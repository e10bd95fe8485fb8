"""Port vs JAX package: host layer (config, datasets, loaders, simple AP),
voxelizer, rulebooks, geometry ops, NMS, plus the port's hygiene rules
(no JAX imports, CUDA unless the CPU is asked for).

Integer outputs (voxels' coords and counts, rulebooks, kept-box indices) are
compared element for element; float outputs at atol 1e-4 (f32, same
formulas, summation order may differ).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu import config as jcfg
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.ops import nms as jnms
from crb_active_3ddet_tpu.ops import points_in_boxes as jpib
from crb_active_3ddet_tpu.ops import voxelize as jvx
from crb_active_3ddet_tpu.ops.sparse import rulebook as jrb
from crb_active_3ddet_tpu.ops.sparse import sparse_ops as jsp
from crb_active_3ddet_tpu.utils import box_coder as jcoder
from crb_active_3ddet_tpu.utils import simple_eval as jeval_ap

from crb_active_3ddet_torch import config as tcfg
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.ops import nms as tnms
from crb_active_3ddet_torch.ops import points_in_boxes as tpib
from crb_active_3ddet_torch.ops import voxelize as tvx
from crb_active_3ddet_torch.ops.sparse import rulebook as trb
from crb_active_3ddet_torch.ops.sparse import sparse_ops as tsp
from crb_active_3ddet_torch.utils import box_coder as tcoder
from crb_active_3ddet_torch.utils import simple_eval as tsimple_eval

ROOT = Path(__file__).resolve().parent.parent
CFG_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / 'tools/cfgs').rglob('*.yaml'))
SECOND = 'tools/cfgs/synthetic_models/second_synth.yaml'
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- host layer ----

@pytest.mark.parametrize('cfg_file', CFG_FILES)
def test_config_copy_loads_the_same(cfg_file):
    """The port's config copy reads every shipped config (with its
    _BASE_CONFIG_ chain) to the same tree as the JAX package's."""
    assert tcfg.load_config(ROOT / cfg_file) == jcfg.load_config(ROOT / cfg_file)


def test_collated_batches_equal():
    """second_synth.yaml test split, same seed: the port's build_dataloader
    collates the same batches, element for element."""
    cj, ct = jcfg.load_config(ROOT / SECOND), tcfg.load_config(ROOT / SECOND)
    _, jl, _ = jbuild(cj.DATA_CONFIG, cj.CLASS_NAMES, 2, workers=0, training=False)
    _, tl, _ = tbuild(ct.DATA_CONFIG, ct.CLASS_NAMES, 2, workers=0, training=False)
    for _, jb, tb in zip(range(2), jl, tl):
        assert set(jb) == set(tb)
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
            else:
                assert jb[k] == tb[k], k


def test_training_samples_equal():
    """Training mode (augmentation on the global numpy RNG): the same seed
    gives the same augmented sample."""
    cj, ct = jcfg.load_config(ROOT / SECOND), tcfg.load_config(ROOT / SECOND)
    js, _, _ = jbuild(cj.DATA_CONFIG, cj.CLASS_NAMES, 2, workers=0, training=True)
    ts, _, _ = tbuild(ct.DATA_CONFIG, ct.CLASS_NAMES, 2, workers=0, training=True)
    for idx in (0, 5):
        np.random.seed(idx)
        a = js[idx]
        np.random.seed(idx)
        b = ts[idx]
        for k in ('points', 'gt_boxes', 'num_points'):
            assert np.array_equal(a[k], b[k]), k


def test_simple_eval_matches():
    rng = np.random.RandomState(0)
    det, gt = [], []
    names = np.array(['Car', 'Pedestrian'])
    for _ in range(3):
        g = np.concatenate([rng.uniform(0, 20, (4, 3)),
                            rng.uniform(1, 4, (4, 3)),
                            rng.uniform(-3, 3, (4, 1))], 1).astype(np.float32)
        d = g + rng.normal(0, 0.3, g.shape).astype(np.float32)
        det.append({'boxes_lidar': d, 'score': rng.rand(4).astype(np.float32),
                    'name': names[rng.randint(0, 2, 4)]})
        gt.append({'boxes_lidar': g, 'name': names[rng.randint(0, 2, 4)]})
    a = jeval_ap.evaluate_lidar_ap(det, gt, ['Car', 'Pedestrian'])
    b = tsimple_eval.evaluate_lidar_ap(det, gt, ['Car', 'Pedestrian'])
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) < 1e-6, k


# ---- voxelizer ----

PCR = (0.0, -4.0, -2.0, 8.0, 4.0, 2.0)
VS = (0.5, 0.5, 1.0)
GRID = (16, 16, 4)


def _points(rng, n):
    pts = np.concatenate([rng.uniform(-0.5, 8.5, (n, 1)),
                          rng.uniform(-4.5, 4.5, (n, 1)),
                          rng.uniform(-2.5, 2.5, (n, 1)),
                          rng.rand(n, 1)], 1).astype(np.float32)
    # points exactly on voxel borders (the f32 floor decides the voxel)
    pts[:20, 0] = np.round(pts[:20, 0] * 2) / 2
    pts[20:40, 1] = np.round(pts[20:40, 1] * 2) / 2
    pts[40:50, :3] = pts[50:60, :3]          # duplicates in one voxel
    return pts


@pytest.mark.parametrize('n,max_voxels,max_ppv,n_valid', [
    (600, 256, 4, 550),      # buffer below the occupied voxels: truncation
    (600, 1024, 2, 600),     # per-voxel point cap
    (40, 64, 5, 30),         # tiny scene: fewer points than voxel slots
], ids=['voxel_cap', 'point_cap', 'tiny'])
def test_voxelize_element_equal(n, max_voxels, max_ppv, n_valid):
    pts = _points(np.random.RandomState(n + max_voxels), n)
    valid = np.arange(n) < n_valid
    ref = jvx.voxelize(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(PCR),
                       jnp.asarray(VS), GRID, max_voxels, max_ppv)
    got = tvx.voxelize(_t(pts), _t(valid), PCR, VS, GRID, max_voxels, max_ppv)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    if max_voxels == 256:
        assert int(got['num_voxels']) == 256      # the case does truncate


def test_grid_size_copy():
    assert tvx.grid_size_from_range(PCR, VS) == jvx.grid_size_from_range(PCR, VS)


# ---- rulebooks ----

def _cell_sorted_coords(rng, grid, b, v, n_valid):
    nz, ny, nx = grid
    coords = np.full((b, v, 3), -1, np.int32)
    for i in range(b):
        cells = np.sort(rng.choice(nz * ny * nx, size=n_valid[i], replace=False))
        coords[i, :n_valid[i]] = np.stack(
            [cells // (ny * nx), (cells % (ny * nx)) // nx, cells % nx], -1)
    valid = np.arange(v)[None, :] < np.asarray(n_valid)[:, None]
    return coords, valid


def _dense_cluster():
    zz, yy, xx = np.meshgrid(np.arange(1, 4), np.arange(1, 4), np.arange(1, 4),
                             indexing='ij')
    coords = np.stack([zz.ravel(), yy.ravel(), xx.ravel()], -1)
    cells = (coords[:, 0] * 6 + coords[:, 1]) * 6 + coords[:, 2]
    return coords[np.argsort(cells)].astype(np.int32)[None], np.ones((1, 27), bool)


@pytest.mark.parametrize('case', ['random', 'dense_cluster'])
def test_subm_rulebook_window_element_equal(case):
    if case == 'random':
        grid = (9, 16, 14)
        coords, valid = _cell_sorted_coords(np.random.RandomState(7), grid, 3, 64,
                                            [64, 50, 1])
    else:
        grid = (6, 6, 6)
        coords, valid = _dense_cluster()
    ref = jrb.subm_rulebook_window(jnp.asarray(coords), jnp.asarray(valid), grid)
    got = trb.subm_rulebook_window(_t(coords), _t(valid), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(trb.unpack_window_rulebook(got).numpy(),
                                  np.asarray(jrb.unpack_window_rulebook(ref)))


@pytest.mark.parametrize('ks,stride,pad,max_out', [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 48),      # conv2/conv3 downsample
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 20),      # conv4 downsample, truncating
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 64),      # conv_out
], ids=['down_p1', 'down_p011_cap', 'conv_out'])
def test_downsample_rulebook_element_equal(ks, stride, pad, max_out):
    grid = (9, 16, 14)
    coords, valid = _cell_sorted_coords(np.random.RandomState(11), grid, 2, 80,
                                        [80, 33])
    ref = jrb.downsample_rulebook(jnp.asarray(coords[0]), jnp.asarray(valid[0]),
                                  grid, ks, stride, pad, max_out)
    got = trb.downsample_rulebook(_t(coords), _t(valid), grid, ks, stride, pad,
                                  max_out)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    assert trb.conv_out_grid(grid, ks, stride, pad) == \
        jrb.conv_out_grid(grid, ks, stride, pad)


def test_sparse_tensor_to_dense_equal():
    grid = (4, 6, 5)
    coords, valid = _cell_sorted_coords(np.random.RandomState(2), grid, 2, 30,
                                        [30, 12])
    feats = np.random.RandomState(3).randn(2, 30, 3).astype(np.float32)
    got = tsp.sparse_tensor_to_dense(_t(feats), _t(coords), _t(valid), grid)
    for b in range(2):
        ref = jsp.sparse_tensor_to_dense(jnp.asarray(feats[b]), jnp.asarray(coords[b]),
                                         jnp.asarray(valid[b]), grid)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


# ---- geometry, box coder, NMS ----

def _boxes(rng, n, spread=10.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_point_density_matches():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (400, 3)).astype(np.float32)
    boxes = _boxes(rng, 25)
    pv = np.arange(400) < 350
    bv = np.arange(25) < 20
    ref = np.asarray(jpib.box_point_density(jnp.asarray(pts), jnp.asarray(boxes),
                                            jnp.asarray(pv), jnp.asarray(bv)))
    got = tpib.box_point_density(_t(pts), _t(boxes), _t(pv), _t(bv)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(tpib.points_in_boxes_numpy(pts, boxes),
                                  jpib.points_in_boxes_numpy(pts, boxes))


def test_residual_coder_decode_matches():
    rng = np.random.RandomState(1)
    enc = (rng.randn(50, 7) * 0.3).astype(np.float32)
    anchors = _boxes(rng, 50)
    ref = np.asarray(jcoder.ResidualCoder().decode(jnp.asarray(enc),
                                                   jnp.asarray(anchors)))
    got = tcoder.ResidualCoder().decode(_t(enc), _t(anchors)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize('n,thresh,score_thresh,cap', [
    (300, 0.1, None, 2048),
    (300, 0.01, 0.3, 2048),
    (300, 0.2, None, 128),       # MATRIX_CAP below the live boxes
], ids=['plain', 'score_thresh', 'matrix_cap'])
def test_rotated_nms_matrix_matches(n, thresh, score_thresh, cap):
    rng = np.random.RandomState(n + int(thresh * 100))
    frames = []
    for _ in range(2):
        boxes = _boxes(rng, n, spread=6.0)
        scores = rng.rand(n).astype(np.float32)
        scores[10:20] = scores[0]                   # ties: lowest index first
        frames.append((boxes, scores))
    boxes = np.stack([f[0] for f in frames])
    scores = np.stack([f[1] for f in frames])
    got = tnms.rotated_nms_matrix(_t(boxes), _t(scores), thresh, 4096, 100,
                                  score_thresh=score_thresh, matrix_cap=cap)
    for f in range(2):
        ref = jnms.rotated_nms_matrix(jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
                                      thresh, 4096, 100, score_thresh=score_thresh,
                                      matrix_cap=cap)
        np.testing.assert_array_equal(got[1][f].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[0][f].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[2][f].numpy(), np.asarray(ref[2]), atol=ATOL)
        assert 0 < int(ref[1].sum()) < min(n, cap)


def test_suppress_fixpoint_matches():
    rng = np.random.RandomState(3)
    k = 70                                            # not a multiple of 32
    o = np.tril(rng.rand(k, k) < 0.08, -1)
    ref = np.asarray(jnms._suppress_fixpoint_packed(jnp.asarray(o), 32))
    got = tnms._suppress_fixpoint_packed(_t(o)[None], 32)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_multi_classes_nms_matches():
    from crb_active_3ddet_tpu.config import CfgNode
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 120, spread=5.0)
    scores = rng.rand(120, 3).astype(np.float32)
    nms_cfg = CfgNode({'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 4096,
                       'NMS_POST_MAXSIZE': 50, 'MATRIX_CAP': 1024})
    ref = jnms.multi_classes_nms(jnp.asarray(scores), jnp.asarray(boxes), nms_cfg,
                                 score_thresh=0.2)
    got = tnms.multi_classes_nms(_t(scores)[None], _t(boxes)[None], nms_cfg,
                                 score_thresh=0.2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=ATOL)


# ---- hygiene and the device rule ----

def _port_files():
    return sorted((ROOT / 'crb_active_3ddet_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports jax, flax, optax, the JAX
    package or scikit-learn, which the card machine lacks (checked on the
    syntax tree, imports inside functions too)."""
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'crb_active_3ddet_tpu', 'sklearn')
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [f'{path.relative_to(ROOT)}: {n}' for n in names
                    if n.split('.')[0] in banned]
    assert not bad, bad
    assert len(_port_files()) > 30


def test_entry_points_default_to_cuda():
    """Without a card the entry points raise unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the CUDA default is valid here')
    from crb_active_3ddet_torch.models.detectors import build_detector
    from crb_active_3ddet_torch.runtime.train import host_to_device_batch
    from crb_active_3ddet_torch.utils.common import resolve_device
    ct = tcfg.load_config(ROOT / SECOND)
    ds, _, _ = tbuild(ct.DATA_CONFIG, ct.CLASS_NAMES, 1, workers=0, training=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_detector(ct.MODEL, 3, ds)
    with pytest.raises(RuntimeError, match='CUDA'):
        host_to_device_batch({'points': np.zeros((1, 4, 4), np.float32)})
    assert resolve_device('cpu') == torch.device('cpu')
    assert build_detector(ct.MODEL, 3, ds, device='cpu').device.type == 'cpu'


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no card, and when run alone outside a checkout."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    res = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text((ROOT / 'chip_smoke.py').read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout

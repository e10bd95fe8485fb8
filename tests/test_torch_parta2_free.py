"""PartA2_free, the PartA2 yamls at full width and the CLIs, in the port vs
the JAX package.

- A reduced PartA2_free.yaml (``test_torch_parta2._reduced(free=True)``: a
  ``PointRCNN`` over UNetV2 with no BEV branch, RETURN_ENCODED_TENSOR
  False, the point head's three towers at 32 wide and its box tower's
  ``PointResidualCoder`` boxes the RoI head's proposals): the eval forward
  on its own proposals and at gt-derived RoIs (1e-4), the eval step, and
  one train step from one RoI sample given to both packages, as
  ``tests/test_torch_parta2.py`` holds PartA2 (the point loss with its box
  term and its multi-class labels).
- ``PointResidualCoder`` encode and decode against the JAX coder, with and
  without mean sizes (class 0 wraps to the last mean size in both).
- The three yamls (kitti_models/PartA2.yaml, kitti_models/PartA2_free.yaml,
  waymo_models/PartA2.yaml) build at full width over their DATA_CONFIG
  geometry: ``flax_init`` sets every parameter and ``flax_to_state_dict``
  of the traced JAX model names every tensor at its shape; a
  ``VoxelResBackBone8x`` in second.yaml's MODEL likewise.
- ``tools/train.main --device cpu`` on a reduced PartA2.yaml over a
  generated KITTI tree (an epoch of 3 steps at batch 2), then
  ``tools/test.main`` on its checkpoint.

Torch ops run on one thread.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which breaks once
# tests/test_vis_html.py has put tools/ first on sys.path: import it now
import torch._dynamo  # noqa: F401
import yaml

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.utils import box_coder as jcoder

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets.kitti import kitti_dataset as tkitti
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils import box_coder as tcoder
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_centerpoint import Fake, _host
from test_torch_cli import Scalars, _plain
from test_torch_parta2 import (ENCODER, TOL, _np, _reduced, check_eval_forward, check_train,
                               eval_pair, train_pair)

ROOT = Path(__file__).resolve().parent.parent
KITTI_PARTA2 = ROOT / 'tools/cfgs/kitti_models/PartA2.yaml'
KITTI_FREE = ROOT / 'tools/cfgs/kitti_models/PartA2_free.yaml'
WAYMO_PARTA2 = ROOT / 'tools/cfgs/waymo_models/PartA2.yaml'
SECOND = ROOT / 'tools/cfgs/kitti_models/second.yaml'
KITTI_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def ev():
    return eval_pair(free=True)


@pytest.mark.parametrize('rois', ['proposals', 'given'])
def test_free_eval_forward_matches(ev, rois):
    assert ev.tmodel.module_topology == ('vfe', 'backbone_3d', 'point_head', 'roi_head')
    assert 'encoded_spconv_features' not in ev.tout
    check_eval_forward(ev, rois)


def test_free_eval_step_matches(ev):
    jstep = jeval.make_eval_step(ev.jmodel, ev.jset, ev.jcfg.POST_PROCESSING, 3)
    tstep = teval.make_eval_step(ev.tmodel, ev.tset, ev.tcfg.POST_PROCESSING, 3)
    jp, jr = jstep(ev.var, ev.jbatch)
    tp, tr = tstep(ttrain.host_to_device_batch(ev.host, 'cpu'))
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    assert {k: int(_np(v).sum()) for k, v in tr.items()} == \
        {k: int(_np(v).sum()) for k, v in jr.items()}


# the parameters whose gradients pass conv_up_m2's ReLU: one of its
# BatchNorm outputs lies within 1e-6 of 0, where the two packages' forward
# rounding flips the ReLU, and their gradients part by up to ~1.3e-3 of
# their norm (those past it, inv_conv2 … conv5, within 1e-6)
FLIPPED = ENCODER + tuple(f'backbone_3d.{n}.' for n in (
    'conv_up_t4', 'conv_up_m4', 'inv_conv4', 'conv_up_t3', 'conv_up_m3', 'inv_conv3',
    'conv_up_t2', 'conv_up_m2'))


def least_bn_output(tr, layer):
    """The least |BatchNorm output| over the valid voxels at the port
    backbone's ``layer``, in the training forward ``check_train`` holds."""
    m = tr.stage_model
    m.train()
    seen = []
    hook = getattr(m.backbone_3d, layer)[1].register_forward_hook(
        lambda mod, args, out: seen.append(out[args[1]].abs().min().item()))
    with torch.no_grad():
        m.backbone_3d(dict(m.vfe(tr.tbatch())))
    hook.remove()
    return seen[0]


def test_free_train_step_matches():
    tr = train_pair(free=True)
    assert float(tr.jtb['point_loss']) > 0 and 'point_box_labels' in tr.tout
    assert tr.jlabels.max() > 1                      # multi-class labels
    assert least_bn_output(tr, 'conv_up_m2') < 1e-6
    check_train(tr, flipped=FLIPPED)


@pytest.mark.parametrize('mean', [True, False])
def test_point_residual_coder_matches_jax(mean):
    rng = np.random.RandomState(3)
    sizes = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    kw = {'use_mean_size': True, 'mean_size': sizes} if mean else {'use_mean_size': False}
    gt = np.concatenate([rng.uniform(-5, 5, (40, 3)), rng.uniform(0.5, 4, (40, 3)),
                         rng.uniform(-np.pi, np.pi, (40, 1))], -1).astype(np.float32)
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    cls = rng.randint(0, 4, 40).astype(np.int32)              # class 0 wraps
    enc = rng.randn(40, 8).astype(np.float32)
    j, t = jcoder.PointResidualCoder(**kw), tcoder.PointResidualCoder(**kw)
    np.testing.assert_allclose(
        _np(t.encode(torch.from_numpy(gt), torch.from_numpy(pts), torch.from_numpy(cls))),
        np.asarray(j.encode(jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(cls))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(t.decode(torch.from_numpy(enc), torch.from_numpy(pts), torch.from_numpy(cls))),
        np.asarray(j.decode(jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls))),
        rtol=1e-6, atol=1e-6)


# ---- the yamls at full width --------------------------------------------------------

def _dataset(cfg):
    d = cfg.DATA_CONFIG
    vox = [p for p in d.DATA_PROCESSOR if p.NAME == 'transform_points_to_voxels'][0]
    nfeat = len(d.POINT_FEATURE_ENCODING.used_feature_list)
    return Fake(cfg.CLASS_NAMES, d.POINT_CLOUD_RANGE, vox.VOXEL_SIZE, nfeat,
                int(vox.MAX_NUMBER_OF_VOXELS['train']), int(vox.MAX_POINTS_PER_VOXEL))


@pytest.mark.parametrize('path, sets', [
    (KITTI_PARTA2, {}), (KITTI_FREE, {}), (WAYMO_PARTA2, {}),
    (SECOND, {'NAME': 'VoxelResBackBone8x'})], ids=['kitti', 'free', 'waymo', 'res'])
def test_yamls_build_at_full_width(path, sets):
    tc, jc = tload(path), jload(path)
    for c in (tc, jc):
        c.MODEL.BACKBONE_3D.update(sets)
    ds = _dataset(tc)
    nc = len(ds.class_names)
    model = tdet(tc.MODEL, nc, ds, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    jmodel = jdet(jc.MODEL, num_class=nc, dataset=ds)
    geom = (ds.voxel_cfg, tuple(int(g) for g in ds.grid_size),
            tuple(float(x) for x in ds.point_cloud_range),
            tuple(float(v) for v in ds.voxel_size))
    host = jtrain.host_to_device_batch(_host(ds, 0))
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), host)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jc.MODEL)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)
    if path == SECOND:
        assert type(model.backbone_3d).__name__ == 'VoxelResBackBone8x'
        assert model.backbone_3d.conv4[2].conv2.weight.shape == (27, 64, 64)
        return
    head = model.roi_head
    g = 10 if path == WAYMO_PARTA2 else 12
    assert head.grid_size == g and head.shared_fc_layer[0].weight.shape == (256, g ** 3 * 128)
    assert head.conv_rpn[0][0].weight.shape == (3, 3, 3, 16, 64)
    assert hasattr(model.backbone_3d, 'conv_out') == (path != KITTI_FREE)
    assert len(head._dropouts()) == 2


# ---- the CLIs on a KITTI tree --------------------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_parta2') / 'kitti'
    chip_smoke.write_kitti_tree(root, n_train=6, n_val=2, points=(3000, 4000),
                                pc_range=KITTI_RANGE, object_range=(-2, -3.2, -3, 9.4, 3.2, 1),
                                max_objects=4)
    cfg = tload(KITTI_PARTA2)
    tkitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=2)
    return root


def test_train_then_test_main_on_kitti(tree, tmp_path, monkeypatch):
    """A reduced PartA2.yaml over the tree: ``train.main`` for one epoch of
    3 steps at batch 2, then ``test.main`` on its checkpoint."""
    cfg = copy.deepcopy(tload(KITTI_PARTA2))
    red = _reduced(tload)
    cfg.MODEL = red.MODEL
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [1.0, 1.0, 1.0, 1.0]
    d = cfg.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(tree), KITTI_RANGE
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    yml = tmp_path / 'parta2_reduced.yaml'
    yml.write_text(yaml.safe_dump(_plain(cfg)))
    for module in (train_cli, test_cli):
        monkeypatch.setattr(module, 'MetricsLogger', Scalars)
    steps = []
    real = ttrain.train_one_epoch

    def epoch(state, step, loader, *a, **k):
        steps.append(len(loader))
        return real(state, step, loader, *a, **k)
    monkeypatch.setattr(ttrain, 'train_one_epoch', epoch)
    out = tmp_path / 'train'
    state = train_cli.main(['--cfg_file', str(yml), '--output_dir', str(out), '--device', 'cpu',
                            '--epochs', '1'])
    assert steps == [3] and state.step == 3
    assert type(state.model.roi_head).__name__ == 'PartA2FCHead'
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap) and np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()

"""VoxelRCNN in the port (``ops/voxel_query.py``,
``models/roi_heads/voxelrcnn_head.py``) vs the JAX package, from the same
weights.

- The voxel query against JAX ``voxel_query`` (vmapped over 2 frames), idx
  and cnt exactly equal, at QUERY_RANGES (4, 4, 4) and (3, 3, 2) and at a
  wider probe lattice: a 500-row buffer whose last 60 rows are invalid
  (their cells repeat valid ones, or lie off the grid), a dense block
  where queries find more than NSAMPLE hits, queries off the grid, at its
  faces and far from every voxel (no hit); the probe offsets equal.
- Two reduced models: ``kitti``, the reduced SECOND of
  ``tests/test_torch_second_eval.py`` (128×128×40 voxels, a 1 024-voxel
  buffer, f32) with caps [4 096, 4 096, 2 048, 1 024] above the stages' counts with ``voxel_rcnn_car.yaml``'s RoI
  head at small widths (GRID_SIZE 4, MLPS [[16, 16]] a source, FCs 64 /
  32; TEST proposals 256 → 32, TRAIN 256 → 64, 16 RoIs sampled a frame);
  ``waymo``, ``voxel_rcnn_with_centerhead_dyn_voxel.yaml``'s MODEL at the
  same cuts (DynMeanVFE over a 12.8 m square of 0.1 × 0.1 × 0.15 m voxels,
  a 1 024-voxel buffer that the frames overflow, the same caps, narrow BEV
  and CenterHead, QUERY_RANGES [3, 3, 2]).  Each: the eval forward (RoIs, the pooled grid,
  rcnn_cls and rcnn_reg, shared features, decoded boxes; atol = rtol =
  1e-4) and the eval step (boxes and scores 1e-4, labels, validity and
  recall exactly); one train step from one RoI sample given to both
  packages (JAX's ``assign_targets`` draws it with a fixed key from
  proposals made from the gt boxes, and is patched to return it inside the
  JAX head), DP_RATIO 0: losses rtol 1e-5, every parameter's gradient
  ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7, and the RoI head's BatchNorm statistics
  (taken over every row, padding too) atol 1e-6.  The batches hold invalid
  voxel rows at every source and grid points without a hit.
- The two yamls build at full width (``flax_init`` sets every parameter;
  ``flax_to_state_dict`` of the traced JAX model names every tensor at its
  shape): KITTI's over a generated KITTI-layout tree, Waymo's over its
  geometry.
- ``tools/train.main --device cpu`` on a reduced ``voxel_rcnn_car.yaml``
  over the tree (an epoch of 3 steps at batch 2), then ``tools/test.main``.
- POOL_METHOD avg_pool at gt-derived RoIs against JAX; an eval forward
  given a generator turns the towers' Dropout live.

Torch ops run on one thread (the module fixture).
"""

import copy
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which breaks once
# tests/test_vis_html.py has put tools/ first on sys.path: import it now
import torch._dynamo  # noqa: F401
import yaml

from crb_active_3ddet_tpu.config import CfgNode as JCfg
from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.ops import voxel_query as jvq
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import CfgNode as TCfg
from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.kitti import kitti_dataset as tkitti
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.models.roi_heads import voxelrcnn_head as tvh
from crb_active_3ddet_torch.ops import voxel_query as tvq
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_centerpoint import Fake, _geom, _host
from test_torch_cli import Scalars, _plain
from test_torch_pvrcnn_train import make_proposals
from test_torch_second_eval import _fill
from test_torch_second_eval import _reduced as _reduced_second

ROOT = Path(__file__).resolve().parent.parent
KITTI_CFG = ROOT / 'tools/cfgs/kitti_models/voxel_rcnn_car.yaml'
WAYMO_CFG = ROOT / 'tools/cfgs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4                  # of the gradient's norm
BN_TOL = 1e-6
KITTI_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]
WAYMO_RANGE = [-6.4, -6.4, -2, 6.4, 6.4, 4]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- the voxel query ----------------------------------------------------------

GRID = (12, 20, 24)
VOXEL = np.array([0.1, 0.1, 0.15], np.float32)      # x, y, z


def _query_case(seed):
    """One frame: (query cells, query xyz, coords, valid, voxel centres)."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = GRID
    block = np.stack(np.meshgrid(np.arange(2, 9), np.arange(5, 13), np.arange(6, 14),
                                 indexing='ij'), -1).reshape(-1, 3)
    block = block[rng.rand(len(block)) < 0.8]
    everywhere = np.stack([rng.randint(0, g, 400) for g in GRID], 1)
    cells = np.unique(np.concatenate([block, everywhere]), axis=0)
    cells = cells[rng.permutation(len(cells))][:440]
    v = 500
    coords = np.zeros((v, 3), np.int32)
    coords[:len(cells)] = cells
    valid = np.zeros(v, bool)
    valid[:len(cells)] = True
    pad = v - len(cells)
    coords[len(cells):] = cells[rng.randint(0, len(cells), pad)]   # repeat valid cells
    coords[-10:] = [-1, 3, 3]                                       # off the grid
    centers = ((coords[:, ::-1] + 0.5) * VOXEL).astype(np.float32)

    m = 160
    q = np.stack([rng.randint(0, g, m) for g in GRID], 1)
    q[:40] = block[rng.randint(0, len(block), 40)]                  # crowded
    q[40:50] = [[0, 0, 0], [nz - 1, ny - 1, nx - 1], [0, ny - 1, 0], [nz - 1, 0, nx - 1],
                [-1, 4, 4], [nz, 4, 4], [3, -2, 5], [3, ny + 1, 5], [3, 5, -3], [3, 5, nx + 2]]
    xyz = ((q[:, ::-1] + rng.uniform(0.05, 0.95, (m, 3))) * VOXEL).astype(np.float32)
    xyz[50:55] += np.float32(40.0)                                  # far from every voxel
    return q.astype(np.int32), xyz, coords, valid, centers


@pytest.mark.parametrize('query_range, radius, nsample, probes', [
    ((4, 4, 4), 0.4, 2, 3), ((4, 4, 4), 0.9, 8, 3), ((3, 3, 2), 0.45, 3, 3),
    ((2, 2, 1), 0.3, 4, 5)], ids=['car_x2', 'wide', 'waymo', 'lattice5'])
def test_voxel_query_equals_jax(query_range, radius, nsample, probes):
    frames = [_query_case(s) for s in (0, 1)]
    stacked = [np.stack(parts) for parts in zip(*frames)]
    jidx, jcnt = jax.vmap(lambda q, x, c, v, p: jvq.voxel_query(
        q, x, c, v, p, grid=GRID, query_range=query_range, radius=radius, nsample=nsample,
        probes_per_dim=probes))(*[jnp.asarray(a) for a in stacked])
    idx, cnt = tvq.voxel_query(*[_t(a) for a in stacked], GRID, query_range, radius,
                               nsample, probes)
    assert idx.dtype == cnt.dtype == torch.int32
    assert idx.shape == (2, 160, nsample) and cnt.shape == (2, 160)
    np.testing.assert_array_equal(_np(cnt), np.asarray(jcnt))
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    c = _np(cnt)
    assert (c == nsample).any() and (c == 0).any() and ((c > 0) & (c < nsample)).any()
    valid = stacked[3]
    hit_rows = np.take_along_axis(valid, _np(idx).reshape(2, -1), 1).reshape(idx.shape)
    assert hit_rows[c > 0].all()                    # never an invalid row
    np.testing.assert_array_equal(tvq._probe_offsets(query_range, probes),
                                  jvq._probe_offsets(query_range, probes))


def test_probe_lattice_is_z_major():
    offs = tvq._probe_offsets((3, 3, 2), 3)
    assert offs.shape == (27, 3)
    assert offs[:3].tolist() == [[-3, -3, -2], [-3, -3, 0], [-3, -3, 2]]
    assert sorted(set(offs[:, 0])) == [-3, 0, 3] and sorted(set(offs[:, 2])) == [-2, 0, 2]


# ---- two reduced models ---------------------------------------------------------

def _narrow_roi_head(r, dp, nms=True):
    r.SHARED_FC, r.CLS_FC, r.REG_FC, r.DP_RATIO = [64, 64], [32, 32], [32, 32], dp
    r.ROI_GRID_POOL.GRID_SIZE = 4
    for src in r.ROI_GRID_POOL.FEATURES_SOURCE:
        r.ROI_GRID_POOL.POOL_LAYERS[src].MLPS = [[16, 16]]
    if nms:
        r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 256, 32
        r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = r.NMS_CONFIG.TRAIN.MATRIX_CAP = 256
        r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
        r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return r


def _reduced_kitti(load, dp=0.3):
    """The reduced SECOND with voxel_rcnn_car.yaml's RoI head at small
    widths."""
    c = _reduced_second(load, False)
    car = load(KITTI_CFG)
    c.MODEL.NAME = 'VoxelRCNN'
    # caps above the downsampled stages' counts: every source is padded
    c.MODEL.BACKBONE_3D.VOXEL_CAPS = [4096, 4096, 2048, 1024]
    c.MODEL.ROI_HEAD = _narrow_roi_head(car.MODEL.ROI_HEAD, dp)
    c.MODEL.POST_PROCESSING = car.MODEL.POST_PROCESSING
    c.MODEL.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    return c


def _reduced_waymo(dp=0.3):
    """voxel_rcnn_with_centerhead_dyn_voxel.yaml's MODEL at small widths
    (a plain dict) and its dataset surface over a 12.8 m square."""
    m = tload(WAYMO_CFG).MODEL
    b = m.BACKBONE_2D
    b.LAYER_NUMS, b.NUM_FILTERS, b.NUM_UPSAMPLE_FILTERS = [1, 1], [16, 32], [16, 16]
    m.BACKBONE_3D.VOXEL_CAPS = [4096, 4096, 2048, 1024]      # as the kitti model's
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
    m.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 64
    _narrow_roi_head(m.ROI_HEAD, dp)
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    ds = Fake(['Vehicle', 'Pedestrian', 'Cyclist'], WAYMO_RANGE, [0.1, 0.1, 0.15], 5, 1024, 1)
    return _plain(m), ds


class Pair:
    """The JAX and the port VoxelRCNN of one reduced config, same weights,
    same host batch."""

    def __init__(self, name, training, pool_method='max_pool'):
        dp = 0.0 if training else 0.3
        if name == 'kitti':
            jc, tc = _reduced_kitti(jload, dp), _reduced_kitti(tload, dp)
            self.jcfg, self.tcfg = jc.MODEL, tc.MODEL
            jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=training)
            self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0,
                                           training=training)
            torch.manual_seed(0)
            np.random.seed(0)
            self.host = next(iter(tloader))
            self.jset = jset
        else:
            cfg, ds = _reduced_waymo(dp)
            self.jcfg, self.tcfg = JCfg(copy.deepcopy(cfg)), TCfg(copy.deepcopy(cfg))
            self.jset = self.tset = ds
            self.host = _host(ds, 0)
        for cfg in (self.jcfg, self.tcfg):
            for layer in cfg['ROI_HEAD']['ROI_GRID_POOL']['POOL_LAYERS'].values():
                layer['POOL_METHOD'] = pool_method
        self.nc = len(self.tset.class_names)
        self.geom = _geom(self.jset)
        self.jmodel = jdet(self.jcfg, num_class=self.nc, dataset=self.jset)
        self.jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(r, jtrain.prepare_device_batch(h, *self.geom),
                                          training=False),
            jax.random.PRNGKey(0), self.jbatch)
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        if name == 'kitti':          # the seeded cls bias keeps no proposal above 0.1
            head = self.var['params']['dense_head']['conv_cls']
            head['bias'] = np.zeros_like(head['bias'])
        self.tmodel = tdet(self.tcfg, num_class=self.nc, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.var['params'],
                                                       self.var['batch_stats'], self.tcfg))

    def tbatch(self):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(self.host, 'cpu'),
                                           *self.geom)


EVAL_KEYS = ('rois', 'roi_labels', 'roi_valid', 'batch_cls_preds', 'batch_box_preds',
             'rcnn_cls', 'rcnn_reg', 'shared_features', 'multi_scale_3d_features')


GIVEN_KEYS = ('rois', 'roi_labels', 'roi_valid', 'roi_scores')


@pytest.fixture(scope='module', params=['kitti', 'waymo'])
def ev(request):
    """Each package's eval forward on its own proposals (a seeded model's:
    they miss the voxels) and on RoIs made from the gt boxes (given to the
    JAX head through a patched proposal layer)."""
    p = Pair(request.param, training=False)
    given = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    p.given = {k: given[k] for k in GIVEN_KEYS}

    def run(v, h, rois):
        batch = jtrain.prepare_device_batch(h, *p.geom)
        if rois is None:
            out = p.jmodel.apply(v, batch, training=False)
        else:
            with mock.patch.object(jrht, 'proposal_layer', lambda bd, *a, **k: {**bd, **rois}):
                out = p.jmodel.apply(v, batch, training=False)
        ms = {k: {f: out['multi_scale_3d_features'][k][f] for f in ('features', 'coords',
                                                                      'valid')}
              for k in out['multi_scale_3d_features']}
        return {**{k: out[k] for k in EVAL_KEYS if k != 'multi_scale_3d_features'},
                'multi_scale_3d_features': ms}
    p.jout = jax.tree.map(np.asarray, jax.jit(lambda v, h: run(v, h, None))(p.var, p.jbatch))
    p.jgiven = jax.tree.map(np.asarray, jax.jit(
        lambda v, h, r: run(v, h, r))(p.var, p.jbatch, p.given))
    p.tmodel.eval()
    with torch.no_grad():
        p.tout = p.tmodel(p.tbatch())
        p.tgiven = p.tmodel({**p.tbatch(), **{k: _t(v) for k, v in p.given.items()}})
    p.name = request.param
    return p


def test_weight_transfer_is_complete(ev):
    sd = flax_to_state_dict(ev.var['params'], ev.var['batch_stats'], ev.tcfg)
    assert set(sd) == set(ev.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(ev.var))
    assert n_flax == sum(v.numel() for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    head = ev.tmodel.roi_head
    assert head.shared_fc_layer[0].weight.shape == (64, 4 ** 3 * 48)
    assert [layer.mlps_in[0][0].weight.shape[1] for layer in head.roi_grid_pool_layers] == \
        [32, 64, 64]


@pytest.mark.parametrize('rois', ['proposals', 'given'])
def test_eval_forward_matches(ev, rois):
    j, t = (ev.jout, ev.tout) if rois == 'proposals' else (ev.jgiven, ev.tgiven)
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(_np(t[k]), j[k], err_msg=k)
    assert j['roi_valid'].sum() > 10
    for k in ('rois', 'rcnn_cls', 'rcnn_reg', 'shared_features', 'batch_cls_preds',
              'batch_box_preds'):
        np.testing.assert_allclose(_np(t[k]), j[k], **TOL, err_msg=k)
    assert not t['cls_preds_normalized']
    # the batch holds padding at every source
    for src in ev.tcfg.ROI_HEAD.ROI_GRID_POOL.FEATURES_SOURCE:
        ms = t['multi_scale_3d_features'][src]
        assert not ms['valid'].all() and ms['valid'].any(), src
        np.testing.assert_array_equal(_np(ms['coords']),
                                      j['multi_scale_3d_features'][src]['coords'])
    if rois == 'given':         # grid points with and without a hit at every source
        with torch.no_grad():
            pooled = ev.tmodel.roi_head.roi_grid_pool(t).reshape(-1, 64, 3, 16)
        zero = (pooled == 0).all(-1).reshape(-1, 3)
        assert zero.any(0).all() and not zero.all(0).any()


def test_eval_step_matches(ev):
    jstep = jeval.make_eval_step(ev.jmodel, ev.jset, ev.jcfg.POST_PROCESSING, ev.nc)
    tstep = teval.make_eval_step(ev.tmodel, ev.tset, ev.tcfg.POST_PROCESSING, ev.nc)
    jp, jr = jstep(ev.var, ev.jbatch)
    tp, tr = tstep(ttrain.host_to_device_batch(ev.host, 'cpu'))
    assert set(tp) == set(jp)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    assert _np(jp['pred_valid']).sum() > 0
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    assert {k: int(_np(v).sum()) for k, v in tr.items()} == \
        {k: int(_np(v).sum()) for k, v in jr.items()}


@pytest.fixture(scope='module', params=['kitti', 'waymo'])
def tr(request):
    """One training forward and backward of each package from one RoI
    sample (JAX's assign_targets with a fixed key, given to both)."""
    p = Pair(request.param, training=True)
    props = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    sampler = p.jcfg.ROI_HEAD.TARGET_CONFIG
    key = jax.random.PRNGKey(5)
    targets = jax.tree.map(np.asarray, jax.jit(
        lambda pr: jrht.assign_targets(key, dict(pr), sampler))(props))
    p.targets = targets

    @jax.jit
    def step(params, batch_stats, h, given):
        batch = jtrain.prepare_device_batch(h, *p.geom)

        def loss_fn(pp):
            with mock.patch.object(jrht, 'assign_targets', lambda *a: dict(given)):
                out, mut = p.jmodel.apply({'params': pp, 'batch_stats': batch_stats}, batch,
                                          training=True, mutable=['batch_stats'],
                                          rngs={'dropout': jax.random.PRNGKey(2)})
            loss, tb = p.jmodel.compute_loss(out)
            return loss, (tb, mut['batch_stats'], out['roi_targets']['rcnn_cls'])
        (_, (tb, stats, cls)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return tb, stats, cls, grads
    p.jtb, jstats, p.jcls, jgrads = jax.tree.map(np.asarray, step(
        p.var['params'], p.var['batch_stats'], p.jbatch, targets))
    p.jgrads = flax_to_state_dict(jgrads, p.var['batch_stats'], p.tcfg)
    p.jstats = flax_to_state_dict(p.var['params'], jstats, p.tcfg)

    p.tmodel.train()
    batch = {**p.tbatch(), 'rois': _t(targets['rois']),
             'roi_targets_dict': {k: _t(v) for k, v in targets.items()}}
    p.tout = p.tmodel(batch)
    loss, p.ttb = p.tmodel.compute_loss(p.tout)
    loss.backward()
    return p


def test_train_losses_and_gradients(tr):
    for k in ('rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'loss'):
        np.testing.assert_allclose(float(tr.ttb[k].detach()), float(tr.jtb[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tr.jtb['rcnn_loss_reg']) > 0
    np.testing.assert_allclose(_np(tr.tout['roi_targets']['rcnn_cls']), tr.jcls, **TOL)
    checked = 0
    for name, prm in tr.tmodel.named_parameters():
        ref = tr.jgrads[name].numpy()
        got = np.zeros_like(ref) if prm.grad is None else _np(prm.grad)
        assert np.linalg.norm(got - ref) <= GRAD_TOL * np.linalg.norm(ref) + 1e-7, name
        checked += name.startswith('roi_head.')
    assert checked == 3 * (3 * 3) + 3 * 2 * 3 + 4


def test_train_batch_norm_statistics(tr):
    """The RoI head's BatchNorms in training take their statistics over
    every row, padding and empty queries included, as the JAX head's."""
    got = tr.tmodel.state_dict()
    names = [k for k in got if k.startswith('roi_head.') and k.endswith(('running_mean',
                                                                          'running_var'))]
    assert len(names) == 2 * (3 * 3 + 3 * 2)
    for k in names:
        np.testing.assert_allclose(_np(got[k]), tr.jstats[k].numpy(), atol=BN_TOL, rtol=1e-5,
                                   err_msg=k)
    # the rows that a masked statistic would leave out are there
    tr.tmodel.eval()
    try:
        with torch.no_grad():
            pooled = tr.tmodel.roi_head.roi_grid_pool(tr.tout).reshape(-1, 64, 3, 16)
    finally:
        tr.tmodel.train()
    zero = (pooled == 0).all(-1).reshape(-1, 3)
    assert zero.any(0).all() and not zero.all(0).any()
    for src in tr.tcfg.ROI_HEAD.ROI_GRID_POOL.FEATURES_SOURCE:
        valid = tr.tout['multi_scale_3d_features'][src]['valid']
        assert valid.any() and not valid.all(), src


def test_avg_pool_matches_jax():
    """POOL_METHOD avg_pool (no shipped config sets it; the pool divides
    by cnt): the eval forward at gt-derived RoIs against JAX."""
    p = Pair('kitti', training=False, pool_method='avg_pool')
    given = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    given = {k: given[k] for k in GIVEN_KEYS}

    @jax.jit
    def run(v, h, rois):
        with mock.patch.object(jrht, 'proposal_layer', lambda bd, *a, **k: {**bd, **rois}):
            out = p.jmodel.apply(v, jtrain.prepare_device_batch(h, *p.geom), training=False)
        return {k: out[k] for k in ('rcnn_cls', 'rcnn_reg', 'shared_features')}
    want = jax.tree.map(np.asarray, run(p.var, p.jbatch, given))
    p.tmodel.eval()
    with torch.no_grad():
        got = p.tmodel({**p.tbatch(), **{k: _t(v) for k, v in given.items()}})
    assert p.tmodel.roi_head.roi_grid_pool_layers[0].avg_pool
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), v, **TOL, err_msg=k)


def test_eval_dropout_live_with_a_generator(ev):
    model = ev.tmodel
    batch = ev.tbatch()
    with torch.no_grad():
        a, b = model(batch), model(batch)
        c = model(batch, torch.Generator().manual_seed(1))
        d = model(batch, torch.Generator().manual_seed(1))
    assert torch.equal(a['rcnn_cls'], b['rcnn_cls'])
    assert not torch.equal(a['rcnn_cls'], c['rcnn_cls'])
    assert torch.equal(c['rcnn_cls'], d['rcnn_cls'])
    assert all(not m.training for m in model.modules())
    assert len(model.roi_head._dropouts()) == 3


# ---- the two yamls at full width ----------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_voxel_rcnn') / 'kitti'
    chip_smoke.write_kitti_tree(root, n_train=6, n_val=2, points=(3000, 4000),
                                pc_range=KITTI_RANGE, object_range=(-2, -3.2, -3, 9.4, 3.2, 1),
                                max_objects=4)
    cfg = tload(KITTI_CFG)
    tkitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=2)
    return root


def _full_width_sets(name, tree):
    """(port dataset, JAX dataset, a JAX host batch) of one yaml at its own
    DATA_CONFIG (KITTI's over the tree, Waymo's geometry on a Fake)."""
    if name == 'kitti':
        tc, jc = tload(KITTI_CFG), jload(KITTI_CFG)
        tc.DATA_CONFIG.DATA_PATH = jc.DATA_CONFIG.DATA_PATH = str(tree)
        tset, _, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 4, workers=0, training=True)
        jset, jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 1, workers=0, training=False)
        return tc.MODEL, jc.MODEL, tset, jset, jtrain.host_to_device_batch(next(iter(jloader)))
    tc, jc = tload(WAYMO_CFG), jload(WAYMO_CFG)
    pcr = tc.DATA_CONFIG.POINT_CLOUD_RANGE
    ds = Fake(tc.CLASS_NAMES, pcr, [0.1, 0.1, 0.15], 5, 40000, 1)
    return tc.MODEL, jc.MODEL, ds, ds, jtrain.host_to_device_batch(_host(ds, 0))


@pytest.mark.parametrize('name', ['kitti', 'waymo'])
def test_yamls_build_at_full_width(tree, name):
    tcfg, jcfg, tset, jset, host = _full_width_sets(name, tree)
    nc = len(tset.class_names)
    model = tdet(tcfg, nc, tset, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    head = model.roi_head
    assert isinstance(head, tvh.VoxelRCNNHead) and 'pfe' not in model.module_topology
    mid = 32 if name == 'kitti' else 64
    assert head.shared_fc_layer[0].weight.shape == (256, 216 * 3 * mid)
    assert [layer.mlps_in[0][0].weight.shape[:2] for layer in head.roi_grid_pool_layers] == \
        [(mid, 32), (mid, 64), (mid, 64)]
    assert [layer.query_range for layer in head.roi_grid_pool_layers] == \
        [(4, 4, 4) if name == 'kitti' else (3, 3, 2)] * 3
    assert head.reg_pred_layer.weight.shape == (7, 256) and head.cls_pred_layer.bias.shape == (1,)
    assert len(head._dropouts()) == 3
    if name == 'kitti':
        assert tset.voxel_cfg['max_voxels'] == 16000 and model.dense_head.total_anchors == 200 * 176 * 2
    jmodel = jdet(jcfg, num_class=nc, dataset=jset)
    geom = _geom(jset)
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), host)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jcfg)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)


def test_train_then_test_main_on_kitti(tree, tmp_path, monkeypatch):
    """A reduced voxel_rcnn_car.yaml over the tree: ``train.main`` for one
    epoch of 3 steps at batch 2, then ``test.main`` on its checkpoint."""
    car = tload(KITTI_CFG)
    cfg = copy.deepcopy(car)
    red = _reduced_kitti(tload)
    m = cfg.MODEL
    m.BACKBONE_3D, m.BACKBONE_2D = red.MODEL.BACKBONE_3D, red.MODEL.BACKBONE_2D
    _narrow_roi_head(m.ROI_HEAD, 0.3)
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    d = cfg.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(tree), KITTI_RANGE
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    yml = tmp_path / 'voxel_rcnn_reduced.yaml'
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
    assert type(state.model.roi_head).__name__ == 'VoxelRCNNHead'
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap) and np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()

"""PointRCNN over PointNet2MSG in the port (``models/backbones_3d/
pointnet2_backbone.py``, ``models/point_heads/point_head_box.py``,
``models/roi_heads/pointrcnn_head.py``) vs the JAX package, from the same
numpy inputs and the same weights.

The reduced pointrcnn.yaml (``reduced``): its MODEL at small widths (SA
levels of 512 → 128 → 32 → 16 points, MLPs 8-64 wide, FP 32-64, point
head towers 32, RoI point pooling of 64 points, the RoI encoder's levels
32 → 16 → group-all, towers 32, NMS 256 → 32 (TEST 16), 16 RoIs a frame)
over the reduced SECOND data of ``tests/test_torch_second_eval.py`` (a
2 048-point buffer).  That config keeps its voxel processor, which
PointRCNN does not read: the JAX package builds its detector and passes the
points on only with one (ROADMAP Queue 3); ``tests/test_torch_pointrcnn_iou.py``
holds the port on the shipped processors.

- eval forward on its own proposals and at gt-derived RoIs given to both
  packages (the JAX head's proposal layer patched): the point features and
  scores 1e-5, the RoIs, head outputs and decoded boxes 1e-4, the RoI
  labels exactly;
- the eval step: boxes and scores 1e-4, labels, validity and recall
  exactly;
- one f32 train step from one RoI sample (the JAX sampler's draw over
  gt-derived proposals, given to both): each loss term rtol 3e-5, the point
  labels exactly, the box targets 1e-6, every BatchNorm statistic atol
  1e-6, the sampled RoIs' rcnn_cls atol 1e-3 (read: 2.2e-4) and the point
  head's gradients within 1e-4 of their norm.  The rest is ill-conditioned
  in f32: the RoI towers' BatchNorms normalise over the batch's 32 RoIs,
  and behind every grouped max (PointNet2MSG's SA and FP levels, the RoI
  head's xyz-up, merge-down and SA levels) a max routes the gradient to
  the argmax of near-tied slots, which the packages' roundings pick apart.
  Against the port's own float64 step the JAX f32 gradients part by up to
  1.5e-1 of their norm (2e-2 in the RoI towers), the port's f32 ones by up
  to 3e-3 (3e-4).  So
- the same train step in float64 on both sides (``jax.enable_x64``): each
  loss term rtol 1e-7 (the port's FPS runs on f32 coordinates) and every
  parameter's gradient within 1e-6 of its norm (read: ≤ 4e-8).

The head's FPS picks over the pooled points agree between the packages on
these inputs (the pooled points part by ≤ 1.2e-7 in f32), so both encoders
run on their own pooled points.  Torch ops run on one thread.
"""

from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_pvrcnn_train import make_proposals
from test_torch_second_eval import _fill
from test_torch_second_eval import _reduced as _reduced_second

ROOT = Path(__file__).resolve().parent.parent
PRCNN = ROOT / 'tools/cfgs/kitti_models/pointrcnn.yaml'
PRCNN_IOU = ROOT / 'tools/cfgs/kitti_models/pointrcnn_iou.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)
GIVEN_KEYS = ('rois', 'roi_labels', 'roi_valid', 'roi_scores')
# the parameters held in the f32 step too (module docstring)
AHEAD = ('point_head.',)
LOSSES = ('point_loss', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'loss')


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


def reduced(load, iou=False):
    """pointrcnn.yaml's (or pointrcnn_iou.yaml's) MODEL at small widths over
    the reduced SECOND data (see the module docstring)."""
    c = _reduced_second(load, False)
    m = load(PRCNN_IOU if iou else PRCNN).MODEL
    sa = m.BACKBONE_3D.SA_CONFIG
    sa.NPOINTS = [512, 128, 32, 16]
    sa.NSAMPLE = [[8, 16]] * 4
    sa.MLPS = [[[8, 8, 16], [8, 8, 16]], [[16, 16, 32], [16, 16, 32]],
               [[32, 32, 32], [32, 32, 32]], [[32, 32, 64], [32, 32, 64]]]
    m.BACKBONE_3D.FP_MLPS = [[32, 32], [32, 32], [64, 64], [64, 64]]
    m.POINT_HEAD.CLS_FC = m.POINT_HEAD.REG_FC = [32]
    r = m.ROI_HEAD
    r.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 64
    r.XYZ_UP_LAYER = [32, 32]
    r.SA_CONFIG.NPOINTS = [32, 16, -1]
    r.SA_CONFIG.NSAMPLE = [8, 8, 8]
    r.SA_CONFIG.MLPS = [[32, 32, 32], [32, 32, 64], [64, 64, 64]]
    r.CLS_FC = r.REG_FC = [32, 32]
    r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 256, 16
    r.NMS_CONFIG.TEST.MATRIX_CAP = r.NMS_CONFIG.TRAIN.MATRIX_CAP = 256
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 256, 32
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    c.MODEL = m
    return c


class Pair:
    """The JAX and the port model of one reduced config, same weights, same
    host batch."""

    def __init__(self, training, iou=False):
        jc, tc = reduced(jload, iou), reduced(tload, iou)
        self.jcfg, self.tcfg = jc.MODEL, tc.MODEL
        self.jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0,
                                 training=training)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0,
                                       training=training)
        torch.manual_seed(0)
        np.random.seed(0)
        self.host = next(iter(tloader))
        self.geom = (self.jset.voxel_cfg, tuple(int(g) for g in self.jset.grid_size),
                     tuple(float(x) for x in self.jset.point_cloud_range),
                     tuple(float(v) for v in self.jset.voxel_size))
        self.jmodel = jdet(self.jcfg, num_class=3, dataset=self.jset)
        self.jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(r, jtrain.prepare_device_batch(h, *self.geom),
                                          training=False),
            jax.random.PRNGKey(0), self.jbatch)
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        self.tmodel = tdet(self.tcfg, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.var['params'],
                                                       self.var['batch_stats'], self.tcfg))

    def tbatch(self):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(self.host, 'cpu'),
                                           *self.geom)


EVAL_KEYS = ('rois', 'roi_labels', 'roi_valid', 'batch_cls_preds', 'batch_box_preds',
             'rcnn_cls', 'rcnn_reg', 'shared_features', 'point_features', 'point_coords',
             'point_valid', 'point_cls_scores', 'point_cls_preds')


@pytest.fixture(scope='module')
def ev():
    """Each package's eval forward on its own proposals and on RoIs made
    from the gt boxes (given to the JAX head through a patched proposal
    layer)."""
    p = Pair(training=False)
    given = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    p.given = {k: given[k] for k in GIVEN_KEYS}

    def run(v, h, rois):
        batch = jtrain.prepare_device_batch(h, *p.geom)
        if rois is None:
            out = p.jmodel.apply(v, batch, training=False)
        else:
            with mock.patch.object(jrht, 'proposal_layer', lambda bd, *a, **k: {**bd, **rois}):
                out = p.jmodel.apply(v, batch, training=False)
        return {k: out[k] for k in EVAL_KEYS}
    p.jout = jax.tree.map(np.asarray, jax.jit(lambda v, h: run(v, h, None))(p.var, p.jbatch))
    p.jgiven = jax.tree.map(np.asarray, jax.jit(
        lambda v, h, r: run(v, h, r))(p.var, p.jbatch, p.given))
    p.tmodel.eval()
    with torch.no_grad():
        p.tout = p.tmodel(p.tbatch())
        p.tgiven = p.tmodel({**p.tbatch(), **{k: _t(v) for k, v in p.given.items()}})
    return p


def test_weight_transfer_is_complete(ev):
    sd = flax_to_state_dict(ev.var['params'], ev.var['batch_stats'], ev.tcfg)
    assert set(sd) == set(ev.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(ev.var))
    assert n_flax == sum(v.numel() for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    assert not hasattr(ev.tmodel, 'vfe')
    assert ev.tmodel.module_topology == ('backbone_3d', 'point_head', 'roi_head')
    head = ev.tmodel.roi_head
    assert head.merge_down_layer[0].weight.shape == (32, 64, 1, 1)
    assert head.merge_down_layer[0].bias is not None          # USE_BN False: a bias
    assert ev.tmodel.backbone_3d.FP_modules[0].mlp[0].weight.shape == (32, 1 + 32, 1, 1)


def test_flax_init_sets_every_parameter(ev):
    """``flax_init`` covers every new parameter (it raises on one it
    misses): Conv and Linear kernels lecun-normal, biases 0, BatchNorm 1 / 0."""
    model = flax_init(tdet(ev.tcfg, num_class=3, dataset=ev.tset, device='cpu'),
                      torch.Generator().manual_seed(0))
    head = model.roi_head
    for conv in (head.xyz_up_layer[0], head.merge_down_layer[0], head.cls_layers[-1]):
        assert (conv.bias == 0).all()
        scale = 1 / np.sqrt(conv.weight[0].numel()) / .87962566103423978   # Flax's truncation
        assert conv.weight.abs().max() <= 2 * scale + 1e-6
    bn = model.backbone_3d.FP_modules[3].mlp[1]
    assert (bn.weight == 1).all() and (bn.bias == 0).all()
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize('rois', ['proposals', 'given'])
def test_eval_forward_matches(ev, rois):
    j, t = (ev.jout, ev.tout) if rois == 'proposals' else (ev.jgiven, ev.tgiven)
    for k in ('roi_labels', 'roi_valid', 'point_valid', 'point_coords'):
        np.testing.assert_array_equal(_np(t[k]), j[k], err_msg=k)
    assert j['roi_valid'].sum() > 10
    for k in ('point_features', 'point_cls_scores', 'point_cls_preds'):
        np.testing.assert_allclose(_np(t[k]), j[k], atol=1e-5, rtol=1e-5, err_msg=k)
    for k in ('rois', 'rcnn_cls', 'rcnn_reg', 'shared_features', 'batch_cls_preds',
              'batch_box_preds'):
        np.testing.assert_allclose(_np(t[k]), j[k], **TOL, err_msg=k)
    if rois == 'given':          # the gt-derived RoIs pool points
        with torch.no_grad():
            _, empty = ev.tmodel.roi_head.roipoint_pool(ev.tgiven)
        assert 0 < empty.float().mean() < 1


def test_eval_step_matches(ev):
    jstep = jeval.make_eval_step(ev.jmodel, ev.jset, ev.jcfg.POST_PROCESSING, 3)
    tstep = teval.make_eval_step(ev.tmodel, ev.tset, ev.tcfg.POST_PROCESSING, 3)
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


# ---- one train step from one RoI sample ------------------------------------------------

def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


def _double(x):
    if isinstance(x, dict):
        return {k: _double(v) for k, v in x.items()}
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def train_pair(iou=False):
    """One training forward and backward of each package from one RoI
    sample (the JAX sampler with a fixed key over gt-derived proposals,
    given to both), in f32 and in float64."""
    p = Pair(training=True, iou=iou)
    props = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    sampler = p.jcfg.ROI_HEAD.TARGET_CONFIG
    key = jax.random.PRNGKey(5)
    targets = jax.tree.map(np.asarray, jax.jit(
        lambda pr: jrht.assign_targets(key, dict(pr), sampler))(props))

    def step(params, batch_stats, h, given):
        def loss_fn(pp):
            with mock.patch.object(jrht, 'assign_targets', lambda *a: dict(given)):
                out, mut = p.jmodel.apply(
                    {'params': pp, 'batch_stats': batch_stats},
                    jtrain.prepare_device_batch(h, *p.geom), training=True,
                    mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(2)})
            loss, tb = p.jmodel.compute_loss(out)
            return loss, (tb, mut['batch_stats'], out['point_cls_labels'],
                          out['point_box_labels'], out['roi_targets']['rcnn_cls'])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    (_, (p.jtb, jstats, p.jlabels, p.jbox, p.jcls)), jgrads = jax.tree.map(
        np.asarray, jax.jit(step)(p.var['params'], p.var['batch_stats'], p.jbatch, targets))
    p.jgrads = flax_to_state_dict(jgrads, p.var['batch_stats'], p.tcfg)
    p.jstats = flax_to_state_dict(p.var['params'], jstats, p.tcfg)
    with jax.enable_x64(True):
        (_, (tb64, *_)), g64 = jax.tree.map(np.asarray, jax.jit(step)(
            *_f64((p.var['params'], p.var['batch_stats'], p.jbatch, targets))))
    p.jtb64, p.jgrads64 = tb64, flax_to_state_dict(g64, p.var['batch_stats'], p.tcfg)

    batch = {**p.tbatch(), 'rois': _t(targets['rois']),
             'roi_targets_dict': {k: _t(v) for k, v in targets.items()}}
    init = {k: v.clone() for k, v in p.tmodel.state_dict().items()}
    p.tmodel.train()
    p.tout = p.tmodel(batch)
    loss, p.ttb = p.tmodel.compute_loss(p.tout)
    loss.backward()
    m64 = tdet(p.tcfg, num_class=3, dataset=p.tset, device='cpu').double()
    m64.load_state_dict(_double(init))
    m64.train()
    loss64, p.ttb64 = m64.compute_loss(m64(_double(batch)))
    loss64.backward()
    p.tgrads64 = {n: prm.grad for n, prm in m64.named_parameters()}
    return p


def check_train(tr):
    for k in LOSSES:
        np.testing.assert_allclose(float(tr.ttb[k].detach()), float(tr.jtb[k]), rtol=3e-5,
                                   err_msg=k)
        np.testing.assert_allclose(float(tr.ttb64[k].detach()), float(tr.jtb64[k]), rtol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(tr.tout['point_cls_labels']), tr.jlabels)
    assert all((tr.jlabels == c).any() for c in (-1, 0, 1))
    np.testing.assert_allclose(_np(tr.tout['point_box_labels']), tr.jbox, atol=1e-6)
    np.testing.assert_allclose(_np(tr.tout['roi_targets']['rcnn_cls']), tr.jcls, atol=1e-3)
    n_ahead = 0
    for name, prm in tr.tmodel.named_parameters():
        ref = tr.jgrads64[name].numpy()
        got = _np(tr.tgrads64[name])
        assert np.linalg.norm(ref) > 0, name                   # every parameter learns
        assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref), name
        if name.startswith(AHEAD):
            ref = tr.jgrads[name].numpy()
            assert np.linalg.norm(_np(prm.grad) - ref) <= 1e-4 * np.linalg.norm(ref) + 1e-7, \
                name
            n_ahead += 1
    assert n_ahead == 10
    got = tr.tmodel.state_dict()
    names = [k for k in got if k.endswith(('running_mean', 'running_var'))]
    assert any(k.startswith('roi_head.SA_modules.2') for k in names)
    for k in names:
        np.testing.assert_allclose(_np(got[k]), tr.jstats[k].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_train_step_matches():
    check_train(train_pair())

"""PartA2 in the port (UNetV2 in ``models/backbones_3d/spconv_backbone.py``,
``models/point_heads/point_head_box.py``, ``models/roi_heads/parta2_head.py``)
vs the JAX package, from the same numpy inputs and the same weights.

- A reduced PartA2.yaml (``_reduced``: the reduced SECOND data of
  ``tests/test_torch_second_eval.py``, a 1 024-voxel buffer over 128×128×40
  voxels, caps [2 304, 2 048, 480, 1 024] of which x_conv4's truncates, narrow BEV,
  POOL_SIZE 4, NUM_FEATURES 32, FCs 64): UNetV2's stages and point features
  (1e-5), the eval forward on its own proposals and at gt-derived RoIs
  given to both packages (1e-4), the eval step (boxes and scores 1e-4,
  labels, validity and recall exactly), one train step from one RoI sample
  given to both (DP_RATIO 0): losses, point labels and part labels, every
  gradient ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7 (the 3D backbone and the point head
  stage by stage, from the JAX step's gradient at their outputs; those
  behind a ReLU that f32 rounding flips at 1e-2, see ``check_train``), every
  BatchNorm statistic atol 1e-6.

``tests/test_torch_parta2_layers.py`` holds the new layers alone and
``tests/test_torch_parta2_free.py`` PartA2_free, the yamls at full width,
the CLIs and the OpenPCDet import.  Torch ops run on one thread.
"""

import copy
from pathlib import Path
from unittest import mock

import flax.linen as fnn
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
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_pvrcnn_train import make_proposals
from test_torch_second_eval import _fill
from test_torch_second_eval import _reduced as _reduced_second

ROOT = Path(__file__).resolve().parent.parent
PARTA2_CFG = ROOT / 'tools/cfgs/kitti_models/PartA2.yaml'
FREE_CFG = ROOT / 'tools/cfgs/kitti_models/PartA2_free.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4                  # of the gradient's norm
FLIP_TOL = 1e-2                  # behind a ReLU that f32 rounding flips, see check_train
ENCODER = tuple(f'backbone_3d.{n}.' for n in ('conv_input', 'conv1', 'conv2', 'conv3',
                                               'conv4'))
BN_TOL = 1e-6
CAPS = [2304, 2048, 480, 1024]   # x_conv4's 480 truncates the reduced frames
GIVEN_KEYS = ('rois', 'roi_labels', 'roi_valid', 'roi_scores')


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


# ---- the reduced PartA2 ----------------------------------------------------------

def _reduced(load, free=False, dp=0.3):
    """PartA2.yaml's (or PartA2_free.yaml's) MODEL at small widths over the
    reduced SECOND data: f32, caps ``CAPS``, narrow BEV, POOL_SIZE 4,
    NUM_FEATURES 32, FCs 64, NMS 256 → 32 (TEST 16), 16 RoIs a frame."""
    c = _reduced_second(load, False)
    m = load(FREE_CFG if free else PARTA2_CFG).MODEL
    m.BACKBONE_3D.USE_BF16 = False
    m.BACKBONE_3D.VOXEL_CAPS = CAPS
    if not free:
        m.BACKBONE_2D = c.MODEL.BACKBONE_2D
    else:
        m.POINT_HEAD.CLS_FC = m.POINT_HEAD.PART_FC = m.POINT_HEAD.REG_FC = [32, 32]
    r = m.ROI_HEAD
    r.SHARED_FC, r.CLS_FC, r.REG_FC, r.DP_RATIO = [64, 64], [64], [64], dp
    r.ROI_AWARE_POOL.POOL_SIZE, r.ROI_AWARE_POOL.NUM_FEATURES = 4, 32
    r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 256, 16
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = r.NMS_CONFIG.TRAIN.MATRIX_CAP = 256
    r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    c.MODEL = m
    return c


class Pair:
    """The JAX and the port model of one reduced config, same weights,
    same host batch."""

    def __init__(self, free, training):
        dp = 0.0 if training else 0.3
        jc, tc = _reduced(jload, free, dp), _reduced(tload, free, dp)
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
        if not free:                 # the seeded cls bias keeps no proposal above 0.1
            head = self.var['params']['dense_head']['conv_cls']
            head['bias'] = np.zeros_like(head['bias'])
        self.tmodel = tdet(self.tcfg, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.var['params'],
                                                       self.var['batch_stats'], self.tcfg))

    def tbatch(self):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(self.host, 'cpu'),
                                           *self.geom)


EVAL_KEYS = ('rois', 'roi_labels', 'roi_valid', 'batch_cls_preds', 'batch_box_preds',
             'rcnn_cls', 'rcnn_reg', 'shared_features', 'point_features', 'point_coords',
             'point_valid', 'point_cls_scores', 'point_part_offset')


def eval_pair(free):
    """Each package's eval forward on its own proposals and on RoIs made
    from the gt boxes (given to the JAX head through a patched proposal
    layer)."""
    p = Pair(free, training=False)
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
        return {**{k: out[k] for k in EVAL_KEYS}, 'multi_scale_3d_features': ms}
    p.jout = jax.tree.map(np.asarray, jax.jit(lambda v, h: run(v, h, None))(p.var, p.jbatch))
    p.jgiven = jax.tree.map(np.asarray, jax.jit(
        lambda v, h, r: run(v, h, r))(p.var, p.jbatch, p.given))
    p.tmodel.eval()
    with torch.no_grad():
        p.tout = p.tmodel(p.tbatch())
        p.tgiven = p.tmodel({**p.tbatch(), **{k: _t(v) for k, v in p.given.items()}})
    return p


STAGE_OUT = {'backbone_3d': ('point_features', 'encoded_spconv_features'),
             'point_head': ('point_cls_preds', 'point_cls_scores', 'point_part_offset',
                            'point_box_preds_raw')}


def train_pair(free):
    """One training forward and backward of each package from one RoI
    sample (JAX's assign_targets with a fixed key over gt-derived
    proposals, given to both).  The JAX step also returns the loss's
    gradient at the outputs of its 3D backbone and its point head (a Flax
    interceptor adds zeros there) and the point head's input."""
    p = Pair(free, training=True)
    props = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    sampler = p.jcfg.ROI_HEAD.TARGET_CONFIG
    key = jax.random.PRNGKey(5)
    targets = jax.tree.map(np.asarray, jax.jit(
        lambda pr: jrht.assign_targets(key, dict(pr), sampler))(props))

    def forward(params, batch_stats, h, given, zeros):
        batch = jtrain.prepare_device_batch(h, *p.geom)
        taps = {}

        def tap(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            stage = context.module.name
            if context.method_name == '__call__' and stage in STAGE_OUT:
                out = dict(out)
                if stage == 'point_head':
                    taps['point_features'] = out['point_features']
                for k in STAGE_OUT[stage]:
                    if k in out:
                        out[k] = out[k] + zeros[k]
            return out
        with fnn.intercept_methods(tap), \
                mock.patch.object(jrht, 'assign_targets', lambda *a: dict(given)):
            out, mut = p.jmodel.apply({'params': params, 'batch_stats': batch_stats}, batch,
                                      training=True, mutable=['batch_stats'],
                                      rngs={'dropout': jax.random.PRNGKey(2)})
        return out, mut, taps

    def shapes_of(params, batch_stats, h, given):
        out, _, _ = forward(params, batch_stats, h, given, jax.tree.map(
            lambda _: 0.0, dict.fromkeys(sum(STAGE_OUT.values(), ()), 0.0)))
        return {k: out[k] for k in sum(STAGE_OUT.values(), ()) if k in out}
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        shapes_of, p.var['params'], p.var['batch_stats'], p.jbatch, targets))

    @jax.jit
    def step(params, batch_stats, h, given, zeros):
        def loss_fn(pp, z):
            out, mut, taps = forward(pp, batch_stats, h, given, z)
            loss, tb = p.jmodel.compute_loss(out)
            return loss, (tb, mut['batch_stats'], out['roi_targets']['rcnn_cls'],
                          out['point_part_labels'], out['point_cls_labels'],
                          taps['point_features'])
        (_, aux), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
            params, zeros)
        return aux, grads
    (p.jtb, jstats, p.jcls, p.jpart, p.jlabels, p.jpf), (jgrads, p.jcot) = jax.tree.map(
        np.asarray, step(p.var['params'], p.var['batch_stats'], p.jbatch, targets, zeros))
    p.jgrads = flax_to_state_dict(jgrads, p.var['batch_stats'], p.tcfg)
    p.jstats = flax_to_state_dict(p.var['params'], jstats, p.tcfg)
    p.stage_model = copy.deepcopy(p.tmodel)           # before the step moves its statistics
    p.tmodel.train()
    batch = {**p.tbatch(), 'rois': _t(targets['rois']),
             'roi_targets_dict': {k: _t(v) for k, v in targets.items()}}
    p.tout = p.tmodel(batch)
    loss, p.ttb = p.tmodel.compute_loss(p.tout)
    loss.backward()
    return p


def stage_grads(tr):
    """The port's 3D backbone and point head, each on its input in the step
    (the backbone on the voxel features, the point head on the JAX step's
    point features), backpropagating the JAX step's gradient at their
    outputs: {parameter name: gradient}."""
    m = tr.stage_model
    m.train()
    vox = m.vfe(tr.tbatch())
    out = m.backbone_3d(dict(vox))
    keys = [k for k in STAGE_OUT['backbone_3d'] if k in out]
    torch.autograd.backward([out[k] for k in keys], [_t(tr.jcot[k]) for k in keys])
    ph_in = {'point_features': _t(tr.jpf), 'point_coords': out['point_coords'].detach(),
             'point_valid': out['point_valid'], 'gt_boxes': vox['gt_boxes']}
    ph_out = m.point_head(ph_in)
    keys = [k for k in STAGE_OUT['point_head'] if k in ph_out]
    torch.autograd.backward([ph_out[k] for k in keys], [_t(tr.jcot[k]) for k in keys])
    return {n: prm.grad for n, prm in m.named_parameters()
            if n.startswith(('backbone_3d.', 'point_head.'))}


def check_eval_forward(ev, rois):
    j, t = (ev.jout, ev.jgiven) if rois == 'proposals' else (ev.jgiven, ev.tgiven)
    if rois == 'proposals':
        t = ev.tout
    for k in ('roi_labels', 'roi_valid', 'point_valid'):
        np.testing.assert_array_equal(_np(t[k]), j[k], err_msg=k)
    # the voxel centres: XLA fuses (c + 0.5)·size + start into one rounding
    np.testing.assert_allclose(_np(t['point_coords']), j['point_coords'], atol=1e-6, rtol=0)
    assert j['roi_valid'].sum() > 10
    for k in ('point_features', 'point_cls_scores', 'point_part_offset'):
        np.testing.assert_allclose(_np(t[k]), j[k], atol=1e-5, rtol=1e-5, err_msg=k)
    for k in ('rois', 'rcnn_cls', 'rcnn_reg', 'shared_features', 'batch_cls_preds',
              'batch_box_preds'):
        np.testing.assert_allclose(_np(t[k]), j[k], **TOL, err_msg=k)
    for src, st in j['multi_scale_3d_features'].items():
        got = t['multi_scale_3d_features'][src]
        np.testing.assert_array_equal(_np(got['coords']), st['coords'], err_msg=src)
        np.testing.assert_allclose(_np(got['features']), st['features'], atol=1e-5,
                                   rtol=1e-5, err_msg=src)


def check_train(tr, flipped=ENCODER):
    """``flipped``: the parameters held at FLIP_TOL (name prefixes)."""
    for k in ('point_loss', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'loss'):
        np.testing.assert_allclose(float(tr.ttb[k].detach()), float(tr.jtb[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(tr.tout['point_cls_labels']), tr.jlabels)
    np.testing.assert_allclose(_np(tr.tout['point_part_labels']), tr.jpart, atol=1e-6)
    assert (tr.jlabels > 0).any() and (tr.jlabels == -1).any()
    np.testing.assert_allclose(_np(tr.tout['roi_targets']['rcnn_cls']), tr.jcls, **TOL)
    # behind the RoI-aware pooling a point's cell follows f32 rounding of its
    # RoI-frame offset (the two packages' cos / sin), so a few voxels' gradients
    # part there: the 3D backbone and the point head are held stage by stage.
    # The gradients behind a ReLU whose input lies within f32 rounding of 0
    # part by ~1e-3 of their norm where the two sides round it to other
    # signs; those parameters (``flipped``) are held at FLIP_TOL, the rest at
    # GRAD_TOL.  PartA2's: UNetV2's encoder (conv_input … conv4), whose
    # gradients in the jitted JAX step part by ~4e-3 of their norm from the
    # same vjp run op by op under ``jax.disable_jit`` (XLA's fusions round
    # some BatchNorm outputs near 0 otherwise); the port's lie within 2e-6 of
    # the op-by-op vjp's, which takes minutes on the CPU and is not run here
    staged = stage_grads(tr)
    for name, prm in tr.tmodel.named_parameters():
        ref = tr.jgrads[name].numpy()
        grad = staged[name] if name in staged else prm.grad
        got = np.zeros_like(ref) if grad is None else _np(grad)
        tol = FLIP_TOL if name.startswith(flipped) else GRAD_TOL
        assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref) + 1e-7, name
    got = tr.tmodel.state_dict()
    names = [k for k in got if k.endswith(('running_mean', 'running_var'))]
    assert any(k.startswith('roi_head.conv_part') for k in names)
    for k in names:
        np.testing.assert_allclose(_np(got[k]), tr.jstats[k].numpy(), atol=BN_TOL, rtol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope='module')
def ev():
    return eval_pair(free=False)


def test_weight_transfer_is_complete(ev):
    sd = flax_to_state_dict(ev.var['params'], ev.var['batch_stats'], ev.tcfg)
    assert set(sd) == set(ev.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(ev.var))
    assert n_flax == sum(v.numel() for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    head = ev.tmodel.roi_head
    assert head.shared_fc_layer[0].weight.shape == (64, 4 ** 3 * 32)
    assert head.conv_part[0][0].weight.shape == (3, 3, 3, 4, 64)
    assert head.conv_rpn[1][0].weight.shape == (3, 3, 3, 64, 16)


def test_unet_truncates_a_level(ev):
    """x_conv2's and x_conv3's buffers hold padding, x_conv4's cap
    truncates (the input buffer is full)."""
    counts = {k: ev.jout['multi_scale_3d_features'][k]['valid'].sum(-1)
              for k in ('x_conv2', 'x_conv3', 'x_conv4')}
    assert (counts['x_conv4'] == CAPS[2]).all()
    assert (counts['x_conv2'] < CAPS[0]).all() and (counts['x_conv3'] < CAPS[1]).all()


@pytest.mark.parametrize('rois', ['proposals', 'given'])
def test_eval_forward_matches(ev, rois):
    check_eval_forward(ev, rois)
    if rois == 'given':          # the gt-derived RoIs' grids hold occupied cells
        with torch.no_grad():
            part, rpn, mask = ev.tmodel.roi_head.roiaware_pool(ev.tgiven)
        assert 0 < mask.float().mean() < 1


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


@pytest.fixture(scope='module')
def tr():
    return train_pair(free=False)


def test_train_losses_gradients_and_statistics(tr):
    check_train(tr)

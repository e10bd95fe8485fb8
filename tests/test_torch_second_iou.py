"""The port's SECONDNetIoU (``models/roi_heads/second_head.py``, the IoU-head
score fusions of ``models/post_processing.py``) vs the JAX package, from the
same weights.

The reduced SECOND of ``tests/test_torch_second_eval.py`` (128×128×40
voxels, narrow BEV widths of 16 + 16 channels, f32, batch 2) with
``second_iou.yaml``'s RoI head and post-processing at small widths
(SHARED_FC [64, 64], IOU_FC [32], the 7×7 grid; TEST proposals 256 → 32,
TRAIN 256 → 64, 16 RoIs sampled a frame).  The Flax variables are made
from a numpy seed and moved into the port with ``utils/flax_weights.py``.

- eval, one jitted JAX program (the forward with a Flax interceptor that
  keeps the first shared FC's input, the pooled taps; post-processing;
  recall): the RoIs, their labels and validity, the pooled taps of the port
  head on the JAX BEV map and RoIs within 1e-5, the IoU logits within 1e-4
  (on the JAX inputs and end to end), the whole eval step (boxes and
  scores 1e-4, labels, validity and recall exactly);
- each SCORE_TYPE fusion through ``post_processing`` on the JAX forward's
  outputs: boxes and scores within 1e-5, labels and validity exactly;
- training, from one RoI sample given to both packages (the JAX
  ``assign_targets`` draws it with a fixed key from proposals made from
  the gt boxes, and is patched to return it inside the JAX head), DP_RATIO
  0: ``rpn_loss`` and ``rcnn_loss_iou`` rtol 1e-5, every parameter's
  gradient ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7; the IoU loss alone gives every module
  but the RoI head no gradient (the RoIs and the BEV map are detached);
- the IoU loss's three variants on seeded logits and labels (1e-6);
- with a generator an eval forward's shared-tower Dropout goes live;
- the layout of OpenPCDet's ``grid_sample`` pooling (a copy of its
  ``roi_grid_pool`` arithmetic): the local x index is its last axis, the
  port's first; the OpenPCDet import of a fabricated SECONDNetIoU state
  dict (the first shared FC permuted, the rest bit for bit, OpenPCDet's
  channel-major product equal to the port's in f64); AnchorHeadMulti's
  import raises;
- (``tests/test_torch_kitti_second.py`` runs the two KITTI configs.)

Torch ops run on one thread (the module fixture).
"""

import copy
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which breaks once
# tests/test_vis_html.py has put tools/ first on sys.path: import it now
import torch._dynamo  # noqa: F401
import yaml

from crb_active_3ddet_tpu.config import CfgNode
from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models import post_processing as jpp
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.models.roi_heads import second_head as jsh
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.kitti import kitti_dataset as tkitti
from crb_active_3ddet_torch.models import post_processing as tpp
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.models.roi_heads import second_head as tsh
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils import openpcdet_ckpt as ockpt
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_cli import Scalars, _plain
from test_torch_openpcdet_ckpt import _fabricate
from test_torch_pvrcnn_train import make_proposals
from test_torch_second_eval import _fill
from test_torch_second_eval import _reduced as _reduced_second

ROOT = Path(__file__).resolve().parent.parent
IOU_CFG = ROOT / 'tools/cfgs/kitti_models/second_iou.yaml'
MULTI_CFG = ROOT / 'tools/cfgs/kitti_models/second_multihead.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)
SCORE_TYPES = ('iou', 'cls', 'weighted_iou_cls', 'num_pts_iou_cls', 'score_by_class')
# the f32 copies of the JAX arrays that the eval tests read
EVAL_KEYS = ('rois', 'roi_scores', 'roi_labels', 'roi_valid', 'full_cls_scores',
             'batch_cls_preds', 'batch_box_preds', 'rcnn_cls', 'spatial_features_2d',
             'points', 'points_valid', 'shared_features')


def _reduced(load, dp=0.3):
    """The reduced SECOND with second_iou.yaml's RoI head (small FCs, cut
    proposal counts) and post-processing."""
    c = _reduced_second(load, False)
    iou = load(IOU_CFG)
    c.MODEL.NAME = 'SECONDNetIoU'
    r = iou.MODEL.ROI_HEAD
    r.SHARED_FC, r.IOU_FC, r.DP_RATIO = [64, 64], [32], dp
    r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 256, 32
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = r.NMS_CONFIG.TRAIN.MATRIX_CAP = 256
    r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    c.MODEL.ROI_HEAD = r
    c.MODEL.POST_PROCESSING = iou.MODEL.POST_PROCESSING
    return c


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Pair:
    """The JAX and the port SECONDNetIoU, same weights, same host batch;
    the JAX eval forward, post-processing and recall in one program."""

    def __init__(self, training):
        jc, tc = _reduced(jload, 0.0 if training else 0.3), _reduced(tload, 0.0 if training else 0.3)
        self.jc, self.tc = jc, tc
        jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=training)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0,
                                       training=training)
        torch.manual_seed(0)
        np.random.seed(0)
        self.host = next(iter(tloader))
        self.jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
        self.geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
                     tuple(float(x) for x in jset.point_cloud_range),
                     tuple(float(v) for v in jset.voxel_size))
        self.jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(r, jtrain.prepare_device_batch(h, *self.geom),
                                          training=False),
            jax.random.PRNGKey(0), self.jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.var = var
        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'],
                                                       tc.MODEL))

    def tbatch(self):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(self.host, 'cpu'),
                                           *self.geom)


@pytest.fixture(scope='module')
def ev():
    p = Pair(training=False)
    post_cfg = p.jc.MODEL.POST_PROCESSING

    @jax.jit
    def run(v, h):
        kept = []

        def tap(next_fun, args, kwargs, context):
            if context.module.name == 'shared_fc_0' and context.method_name == '__call__':
                kept.append(args[0])
            return next_fun(*args, **kwargs)
        batch = jtrain.prepare_device_batch(h, *p.geom)
        with fnn.intercept_methods(tap):
            out = p.jmodel.apply(v, batch, training=False)
        preds = jpp.post_processing(out, post_cfg, num_class=3)
        gt = batch['gt_boxes']
        rec = jax.vmap(jpp.generate_recall_record)(
            preds['pred_boxes'], preds['pred_valid'], gt[..., :7], jnp.abs(gt).sum(-1) > 0)
        return {k: out[k] for k in EVAL_KEYS}, kept[0], preds, rec
    p.jout, p.jpooled, p.jpreds, p.jrec = jax.tree.map(np.asarray, run(p.var, p.jbatch))
    p.tmodel.eval()
    with torch.no_grad():
        p.tout = p.tmodel(p.tbatch())
    return p


def test_weight_transfer_is_complete(ev):
    sd = flax_to_state_dict(ev.var['params'], ev.var['batch_stats'], ev.tc.MODEL)
    assert set(sd) == set(ev.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(ev.var))
    assert n_flax == sum(v.numel() for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    assert 'roi_head.iou_layers.4.weight' in sd        # after the p = 0 Dropout slot


def test_rois_pooled_taps_and_iou_logits(ev):
    j, t = ev.jout, ev.tout
    for k in ('roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(_np(t[k]), j[k], err_msg=k)
    assert j['roi_valid'].sum() > 10
    for k in ('rois', 'roi_scores', 'full_cls_scores', 'spatial_features_2d'):
        np.testing.assert_allclose(_np(t[k]), j[k], **TOL, err_msg=k)
    np.testing.assert_allclose(_np(t['batch_box_preds']), j['rois'], **TOL)
    head = ev.tmodel.roi_head
    given = {'spatial_features_2d': _t(j['spatial_features_2d']), 'rois': _t(j['rois'])}
    with torch.no_grad():
        pooled = head.roi_grid_pool(given)
        out = head(dict(given))
    assert pooled.shape == (2 * 32, 49 * 32)
    np.testing.assert_allclose(_np(pooled), ev.jpooled, atol=1e-5, rtol=1e-5)
    for k in ('rcnn_cls', 'batch_cls_preds', 'shared_features'):
        np.testing.assert_allclose(_np(out[k]), j[k], **TOL, err_msg=k)
        np.testing.assert_allclose(_np(t[k]), j[k], **TOL, err_msg=k)
    assert not out['cls_preds_normalized'] and torch.equal(out['rcnn_reg'], torch.zeros(64, 7))


def test_eval_step_matches(ev):
    step = teval.make_eval_step(ev.tmodel, ev.tset, ev.tc.MODEL.POST_PROCESSING, 3)
    tp, tr = step(ttrain.host_to_device_batch(ev.host, 'cpu'))
    assert set(tp) == set(ev.jpreds)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), ev.jpreds[k], err_msg=k)
    assert ev.jpreds['pred_valid'].sum() > 0
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), ev.jpreds[k], **TOL, err_msg=k)
    assert {k: int(v.sum()) for k, v in tr.items()} == \
        {k: int(v.sum()) for k, v in ev.jrec.items()}


def _fusion_cfg(post_cfg, score_type):
    p = copy.deepcopy(post_cfg)
    p.NMS_CONFIG.SCORE_TYPE = score_type
    p.NMS_CONFIG.SCORE_WEIGHTS = {'iou': 0.7, 'cls': 0.3}
    p.NMS_CONFIG.SCORE_THRESH = {'cls': 2, 'iou': 40}
    p.NMS_CONFIG.SCORE_BY_CLASS = {'Car': 'iou', 'Pedestrian': 'cls', 'Cyclist': 'iou'}
    p.NMS_CONFIG.CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
    return p


def _fusion_inputs(ev):
    """The JAX forward's outputs, the RoIs' labels cycled through the three
    classes (the seeded model labels nearly every RoI alike), for each
    package."""
    j = dict(ev.jout)
    cycled = np.arange(j['roi_labels'].shape[1]) % 3 + 1
    j['roi_labels'] = np.where(j['roi_valid'], cycled, 0).astype(j['roi_labels'].dtype)
    flags = {'cls_preds_normalized': False, 'has_class_labels': True}
    return ({**{k: jnp.asarray(v) for k, v in j.items()}, **flags},
            {**{k: _t(v) for k, v in j.items()}, **flags})


@pytest.mark.parametrize('score_type', SCORE_TYPES)
def test_score_fusion(ev, score_type):
    jin, tin = _fusion_inputs(ev)
    want = jax.tree.map(np.asarray, jpp.post_processing(
        jin, _fusion_cfg(ev.jc.MODEL.POST_PROCESSING, score_type), num_class=3))
    got = tpp.post_processing(tin, _fusion_cfg(ev.tc.MODEL.POST_PROCESSING, score_type), 3)
    assert want['pred_valid'].sum() > 0
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(got[k]), want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    scores = _np(got['pred_scores'])[_np(got['pred_valid'])]
    assert ((scores >= 0) & (scores <= 1)).all()


def test_fusions_differ_and_need_roi_scores(ev):
    """The five fusions score differently, and without roi_scores (a
    one-stage model) SCORE_TYPE changes nothing."""
    _, tin = _fusion_inputs(ev)
    fused = [tpp.fused_scores(tin, _fusion_cfg(ev.tc.MODEL.POST_PROCESSING, s).NMS_CONFIG, s)
             for s in SCORE_TYPES]
    for a in range(len(fused)):
        for b in range(a + 1, len(fused)):
            assert not torch.equal(fused[a], fused[b]), (SCORE_TYPES[a], SCORE_TYPES[b])
    one_stage = {k: v for k, v in tin.items() if k != 'roi_scores'}
    post = ev.tc.MODEL.POST_PROCESSING
    plain = copy.deepcopy(post)
    del plain.NMS_CONFIG['SCORE_TYPE']
    got, want = tpp.post_processing(one_stage, post, 3), tpp.post_processing(one_stage, plain, 3)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(NotImplementedError):
        tpp.fused_scores(tin, post.NMS_CONFIG, 'max_iou_cls')


@pytest.mark.parametrize('kind', ['BinaryCrossEntropy', 'L2', 'smoothL1'])
def test_iou_loss_variants(kind):
    rng = np.random.RandomState(3)
    logits = rng.randn(40).astype(np.float32)
    labels = rng.uniform(-0.5, 1, 40).astype(np.float32)      # some ignored (< 0)
    cfg = {'IOU_LOSS': kind, 'LOSS_WEIGHTS': {'rcnn_iou_weight': 1.5}}
    want = jsh.get_box_iou_layer_loss({'rcnn_iou': jnp.asarray(logits[:, None]),
                                       'rcnn_cls_labels': jnp.asarray(labels)}, CfgNode(cfg))
    got = tsh.get_box_iou_layer_loss({'rcnn_iou': _t(logits[:, None]),
                                      'rcnn_cls_labels': _t(labels)}, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope='module')
def tr():
    """One training forward and backward of each package from one RoI
    sample (JAX's assign_targets with a fixed key, given to both)."""
    p = Pair(training=True)
    props = make_proposals(p.host['gt_boxes'], np.random.RandomState(1))
    sampler = p.jc.MODEL.ROI_HEAD.TARGET_CONFIG
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
            return loss, (tb, out['roi_iou_targets']['rcnn_iou'])
        (_, (tb, iou)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return tb, iou, grads
    p.jtb, p.jiou, jgrads = jax.tree.map(np.asarray, step(
        p.var['params'], p.var['batch_stats'], p.jbatch, targets))
    p.jgrads = flax_to_state_dict(jgrads, p.var['batch_stats'], p.tc.MODEL)

    p.tmodel.train()
    batch = {**p.tbatch(), 'rois': _t(targets['rois']),
             'roi_targets_dict': {k: _t(v) for k, v in targets.items()}}
    p.tout = p.tmodel(batch)
    loss, p.ttb = p.tmodel.compute_loss(p.tout)
    loss.backward()
    p.batch = batch
    return p


def test_train_losses_and_gradients(tr):
    for k in ('rpn_loss', 'rcnn_loss_iou', 'loss'):
        np.testing.assert_allclose(float(tr.ttb[k].detach()), float(tr.jtb[k]), rtol=1e-5, err_msg=k)
    assert float(tr.jtb['rcnn_loss_iou']) > 0
    np.testing.assert_allclose(_np(tr.tout['roi_iou_targets']['rcnn_iou']), tr.jiou, **TOL)
    labels = tr.targets['rcnn_cls_labels']
    assert ((labels > 0) & (labels < 1)).any() and (labels == 1).any() and (labels == 0).any()
    checked = 0
    for name, prm in tr.tmodel.named_parameters():
        ref = tr.jgrads[name].numpy()
        got = np.zeros_like(ref) if prm.grad is None else _np(prm.grad)
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref) + 1e-7, name
        checked += name.startswith('roi_head.')
    assert checked == 2 * 3 + 3 + 2                 # 3 FC layers, 3 BNs, iou_out


def test_iou_loss_alone_reaches_only_the_roi_head(tr):
    model = tr.tmodel
    model.zero_grad(set_to_none=True)
    out = model(tr.batch)
    tsh.get_box_iou_layer_loss(out['roi_iou_targets'],
                               tr.tc.MODEL.ROI_HEAD.LOSS_CONFIG).backward()
    reached = {n.split('.')[0] for n, p in model.named_parameters()
               if p.grad is not None and p.grad.abs().sum() > 0}
    assert reached == {'roi_head'}
    model.zero_grad(set_to_none=True)


def test_eval_dropout_live_with_a_generator():
    cfg = _reduced(tload)
    ds, loader, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=False)
    model = tdet(cfg.MODEL, 3, ds, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    model.eval()
    geom = (ds.voxel_cfg, tuple(int(g) for g in ds.grid_size),
            tuple(float(x) for x in ds.point_cloud_range), tuple(float(v) for v in ds.voxel_size))
    batch = ttrain.prepare_device_batch(ttrain.host_to_device_batch(next(iter(loader)), 'cpu'),
                                        *geom)
    with torch.no_grad():
        a, b = model(batch), model(batch)
        c = model(batch, torch.Generator().manual_seed(1))
        d = model(batch, torch.Generator().manual_seed(1))
    assert torch.equal(a['rcnn_cls'], b['rcnn_cls'])
    assert not torch.equal(a['rcnn_cls'], c['rcnn_cls'])
    assert torch.equal(c['rcnn_cls'], d['rcnn_cls'])
    assert all(not m.training for m in model.modules())


# ---- OpenPCDet's layout and checkpoints ----------------------------------------

def openpcdet_pool(bev_nchw, rois, pcr, voxel_size, down, g):
    """OpenPCDet's ``SECONDHead.roi_grid_pool`` arithmetic (its affine theta,
    ``affine_grid`` and ``grid_sample``): (B·R, C, G, G)."""
    b, _, h, w = bev_nchw.shape
    out = []
    for k in range(b):
        r = rois[k]
        x1 = (r[:, 0] - r[:, 3] / 2 - pcr[0]) / (voxel_size[0] * down)
        x2 = (r[:, 0] + r[:, 3] / 2 - pcr[0]) / (voxel_size[0] * down)
        y1 = (r[:, 1] - r[:, 4] / 2 - pcr[1]) / (voxel_size[1] * down)
        y2 = (r[:, 1] + r[:, 4] / 2 - pcr[1]) / (voxel_size[1] * down)
        cosa, sina = torch.cos(r[:, 6]), torch.sin(r[:, 6])
        theta = torch.stack((
            (x2 - x1) / (w - 1) * cosa, (x2 - x1) / (w - 1) * (-sina),
            (x1 + x2 - w + 1) / (w - 1),
            (y2 - y1) / (h - 1) * sina, (y2 - y1) / (h - 1) * cosa,
            (y1 + y2 - h + 1) / (h - 1)), dim=1).view(-1, 2, 3)
        grid = torch.nn.functional.affine_grid(theta, (r.shape[0], bev_nchw.shape[1], g, g),
                                               align_corners=False)
        out.append(torch.nn.functional.grid_sample(
            bev_nchw[k:k + 1].expand(r.shape[0], -1, -1, -1), grid, align_corners=False))
    return torch.cat(out)


def test_openpcdet_grid_layout_and_import(ev, tmp_path):
    """On a BEV map that rises along x alone, axis-aligned RoIs: OpenPCDet's
    taps vary along its last axis (G_x) and the port's along its first
    (grid-major, x outer).  So OpenPCDet's (C, G_y, G_x) flatten maps to the
    port's (G_x, G_y, C) by reversing the three axes; the import permutes
    the first shared FC so, and its product on OpenPCDet's layout equals
    the port's on the port's (f64)."""
    model = copy.deepcopy(ev.tmodel)
    head = model.roi_head
    g = head.grid_size
    h, w, c = 40, 40, 3
    ramp = torch.arange(w, dtype=torch.float32)[None, None, :, None].expand(1, h, w, c)
    rois = torch.tensor([[[3.2, 0.0, -1.0, 2.4, 1.2, 1.5, 0.0],
                          [2.0, -1.0, -1.0, 1.6, 2.0, 1.5, 0.0]]])
    port = head.roi_grid_pool({'spatial_features_2d': ramp.contiguous(),
                               'rois': rois}).reshape(2, g, g, c)
    opc = openpcdet_pool(ramp.permute(0, 3, 1, 2).contiguous(), rois,
                         head.point_cloud_range, head.voxel_size, head.downsample, g)
    assert (port.diff(dim=1) > 0).all() and (port.diff(dim=2).abs() < 1e-5).all()
    assert (opc.diff(dim=3) > 0).all() and (opc.diff(dim=2).abs() < 1e-5).all()

    sd = _fabricate(model, '2.x', seed=11)
    path = tmp_path / 'second_iou.pth'
    torch.save({'model_state': sd}, path)
    report, _ = ockpt.import_openpcdet_checkpoint(str(path), model)
    assert not report['mismatched'] and not report['unmatched_target']
    got = model.state_dict()
    for key, value in sd.items():
        if key == ockpt.SHARED_FC:
            assert torch.equal(got[key], ockpt.grid_major(value, g * g, True))
            assert torch.equal(ockpt.channel_major(got[key], g * g, True), value)
        elif value.ndim == 5:                          # spconv 2.x (Cout, kz, ky, kx, Cin)
            assert torch.equal(got[key], ockpt.spconv_kernel(value, *got[key].shape[1:])), key
        elif key in got:
            assert torch.equal(got[key], value.to(got[key].dtype)), key
    feats = torch.from_numpy(np.random.RandomState(0).randn(5, g, g, 32))   # (N, G_x, G_y, C)
    layer = head.shared_fc_layer[0]
    with torch.no_grad():
        mine = copy.deepcopy(layer).double()(feats.reshape(5, -1, 1))
        theirs = torch.nn.functional.conv1d(feats.permute(0, 3, 2, 1).reshape(5, -1, 1),
                                            sd[ockpt.SHARED_FC].double())
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6, atol=0)

    multi = copy.deepcopy(ev.tc.MODEL)
    multi.NAME, multi.DENSE_HEAD.NAME = 'SECONDNet', 'AnchorHeadMulti'
    with pytest.raises(NotImplementedError, match='AnchorHeadMulti'):
        ockpt.check_family(multi)

"""The port's AnchorHeadMulti (``models/dense_heads/anchor_head_multi.py``) and
its ATSS and MATCH_HEIGHT target assignment (``target_assigner.py``) vs the
JAX package, from the same weights and inputs.

- The head alone on a seeded (2, 16, 16, 32) BEV map (a 6.4 m square at
  0.05 m voxels, stride 8: 1 536 anchors over Car, Pedestrian, Cyclist,
  two rotations each), for three layouts: ``second_multihead.yaml``'s (a
  64-channel shared conv, a head a class, 1×1 outputs), the JAX test's
  (``tests/test_multihead_atss.py:multi_cfg``: a 32-channel shared conv,
  heads [Car] and [Pedestrian, Cyclist], SEPARATE_REG_CONFIG with one
  middle conv, four REG_LIST entries) and one without a shared conv, with
  two middle convs and heads [Car, Pedestrian] and [Cyclist].  Flax
  variables from a numpy seed (shapes from ``jax.eval_shape``) moved with
  ``utils/flax_weights.py``.  Eval: the raw and decoded predictions within
  1e-5 (headings modulo pi); training (Flax BatchNorm statistics): the
  predictions, the assignment (labels and weights exactly, the encoded
  targets within 1e-6: the log of two math libraries parts by an ulp), the RPN
  loss terms (rtol 1e-5) and the updated BN statistics (atol 1e-6);
  ``MULTI_CLASSES_NMS`` post-processing (``second_multihead.yaml``'s, cut to
  64 → 32 boxes a class) on the JAX predictions: boxes and scores within
  1e-5, labels and validity exactly.
- ATSS (rotated BEV IoU, and 3D with MATCH_HEIGHT) and the axis-aligned
  assigner with MATCH_HEIGHT, on ``second_iou.yaml``'s anchors over the
  same map, against gts with padded rows and a pair
  of equal gts (which share their best anchor: the port gives it to the
  higher index, as JAX's serial scatter does); the two rotations of a
  location tie in distance.  The two packages' rotated overlaps part by
  f32 rounding (a few 1e-6 here), so the assignment is held exactly
  (labels and weights; targets within 1e-6) given the JAX IoU, and on the
  port's own IoU a label may differ only at an anchor within 1e-5 of one
  of its decisions.
- The whole reduced SECOND of ``tests/test_torch_second_eval.py`` with
  ``second_multihead.yaml``'s head and post-processing: the eval step
  (one jitted JAX program) within 1e-4, labels and validity exactly.

Torch ops run on one thread (the module fixture).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models import post_processing as jpp
from crb_active_3ddet_tpu.models.dense_heads import anchor_head_multi as jahm
from crb_active_3ddet_tpu.models.dense_heads import anchor_head_single as jahs
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models import post_processing as tpp
from crb_active_3ddet_torch.models.dense_heads import anchor_head_single as tahs
from crb_active_3ddet_torch.models.dense_heads.anchor_head_multi import AnchorHeadMulti
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import dense_head_from_flax, flax_to_state_dict

from test_torch_second_eval import _fill
from test_torch_second_eval import _reduced as _reduced_second

ROOT = Path(__file__).resolve().parent.parent
MULTI_CFG = ROOT / 'tools/cfgs/kitti_models/second_multihead.yaml'
IOU_CFG = ROOT / 'tools/cfgs/kitti_models/second_iou.yaml'
CLASSES = ('Car', 'Pedestrian', 'Cyclist')
PCR = (0.0, -6.4, -3.0, 12.8, 6.4, 1.0)
GRID = (256, 256, 40)                       # 0.05 × 0.05 × 0.1 m voxels
HEAD_PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)   # the heads' map: 16 × 16
HEAD_GRID = (128, 128, 40)
C_IN = 32
SEPARATE = {'NUM_MIDDLE_CONV': 1, 'NUM_MIDDLE_FILTER': 32,
            'REG_LIST': ['reg:2', 'height:1', 'size:3', 'angle:1']}
LAYOUTS = {
    'second_multihead': dict(),
    'separate_reg': dict(SHARED_CONV_NUM_FILTER=32, SEPARATE_REG_CONFIG=SEPARATE,
                         RPN_HEAD_CFGS=[{'HEAD_CLS_NAME': ['Car']},
                                        {'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist']}]),
    'no_shared_two_mid': dict(SHARED_CONV_NUM_FILTER=None,
                              SEPARATE_REG_CONFIG={**SEPARATE, 'NUM_MIDDLE_CONV': 2,
                                                   'NUM_MIDDLE_FILTER': 16},
                              RPN_HEAD_CFGS=[{'HEAD_CLS_NAME': ['Car', 'Pedestrian']},
                                             {'HEAD_CLS_NAME': ['Cyclist']}]),
}


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


def _head_cfg(load, cfg_file, **changes):
    dh = load(cfg_file).MODEL.DENSE_HEAD
    for k, v in changes.items():
        if v is None:
            dh.pop(k, None)
        else:
            dh[k] = copy.deepcopy(v)
    return dh


def _gt_boxes(rng, batch=2, scale=1.0):
    """(B, 7, 8) gts: four spread objects, an equal pair of Cars (one best
    anchor for both), an upright Pedestrian, a padded row (two in frame 1);
    ``scale`` shrinks the x, y spread to a smaller map."""
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    gt = np.zeros((batch, 7, 8), np.float32)
    for b in range(batch):
        for i, cls in enumerate((1, 2, 3, 1)):
            gt[b, i, :2] = rng.uniform([1.5 * scale, -5 * scale], [11 * scale, 5 * scale])
            gt[b, i, 2] = -1.0 + rng.uniform(-0.3, 0.3)
            gt[b, i, 3:6] = np.array(sizes[cls]) * rng.uniform(0.85, 1.15, 3)
            gt[b, i, 6] = rng.uniform(-np.pi, np.pi)
            gt[b, i, 7] = cls
        gt[b, 4] = gt[b, 0]
        gt[b, 5, :3] = (4.2 * scale, 1.0 * scale, -0.6)
        gt[b, 5, 3:6] = sizes[2]
        gt[b, 5, 7] = 2
    gt[1, 3] = 0                                        # more padding in frame 1
    return gt


class HeadPair:
    """The JAX and the port AnchorHeadMulti of one layout, same weights."""

    def __init__(self, layout):
        jcfg = _head_cfg(jload, MULTI_CFG, **LAYOUTS[layout])
        tcfg = _head_cfg(tload, MULTI_CFG, **LAYOUTS[layout])
        self.jhead = jahm.AnchorHeadMulti(model_cfg=jcfg, num_class=3, class_names=CLASSES,
                                          grid_size=HEAD_GRID, point_cloud_range=HEAD_PCR)
        rng = np.random.RandomState(0)
        self.x = rng.randn(2, 16, 16, C_IN).astype(np.float32)
        self.gt = _gt_boxes(rng, scale=0.5)
        batch = {'spatial_features_2d': jnp.asarray(self.x), 'gt_boxes': jnp.asarray(self.gt)}
        shapes = jax.eval_shape(lambda r: self.jhead.init(r, batch, training=False),
                                jax.random.PRNGKey(0))
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(1)), shapes)
        self.jbatch = batch
        self.thead = AnchorHeadMulti(tcfg, C_IN, 3, CLASSES, HEAD_GRID, HEAD_PCR)
        sd = {}
        dense_head_from_flax(sd, {'dense_head': self.var['params']},
                             {'dense_head': self.var.get('batch_stats', {})})
        self.thead.load_state_dict({k[len('dense_head.'):]: torch.from_numpy(np.array(v))
                                    for k, v in sd.items()})
        self.core = jahs.make_core(jcfg, 3, CLASSES, np.asarray(HEAD_GRID), list(HEAD_PCR))

    def tbatch(self):
        return {'spatial_features_2d': _t(self.x), 'gt_boxes': _t(self.gt)}


PRED_KEYS = ('cls_preds', 'box_preds', 'dir_cls_preds', 'batch_cls_preds')


def _same_targets(got, want):
    """Labels and weights exactly; the encoded targets to 1e-6 (the two
    math libraries' log can part by an ulp)."""
    for k in ('box_cls_labels', 'box_reg_targets', 'reg_weights'):
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype, k
    for k in ('box_cls_labels', 'reg_weights'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(_np(got['box_reg_targets']), np.asarray(want['box_reg_targets']),
                               atol=1e-6, rtol=1e-6)


def _same_preds(got, want):
    for k in PRED_KEYS:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    g, w = _np(got['batch_box_preds']), np.asarray(want['batch_box_preds'])
    np.testing.assert_allclose(g[..., :6], w[..., :6], atol=1e-5, rtol=1e-5)
    turn = np.abs((g[..., 6] - w[..., 6] + np.pi / 2) % np.pi - np.pi / 2)
    assert turn.max() < 1e-5


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_head_eval_and_train(layout):
    p = HeadPair(layout)
    # eval
    jout = p.jhead.apply(p.var, dict(p.jbatch), training=False)
    p.thead.eval()
    with torch.no_grad():
        tout = p.thead(p.tbatch())
    assert tout['batch_cls_preds'].shape == (2, 16 * 16 * 6, 3)
    _same_preds(tout, jout)
    # the anchor order is AnchorHeadSingle's over the whole generator config
    np.testing.assert_array_equal(_np(p.thead.anchors), p.core._flat_anchors_np)

    # training: batch statistics, the assignment, the loss
    jout, mut = p.jhead.apply(p.var, dict(p.jbatch), training=True, mutable=['batch_stats'])
    p.thead.train()
    tout = p.thead(p.tbatch())
    _same_preds(tout, jout)
    _same_targets(tout, jout)
    assert (_np(tout['box_cls_labels']) > 0).sum() > 4
    jloss, jtb = jahs.get_loss(jout, p.core)
    tloss, ttb = tahs.get_loss(tout, p.thead)
    for k in ttb:
        np.testing.assert_allclose(float(ttb[k].detach()), float(jtb[k]), rtol=1e-5, err_msg=k)
    tloss.backward()
    assert all(q.grad is not None and torch.isfinite(q.grad).all() for q in p.thead.parameters())
    new = {}
    dense_head_from_flax(new, {'dense_head': p.var['params']}, {'dense_head': mut['batch_stats']})
    state = p.thead.state_dict()
    stats = [k for k in new if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(_np(state[k[len('dense_head.'):]]), np.asarray(new[k]),
                                   atol=1e-6, err_msg=k)


def test_multi_classes_nms_post_processing():
    """second_multihead.yaml's MULTI_CLASSES_NMS on the JAX head's
    predictions (the NMS cut to 64 → 32 boxes a class)."""
    p = HeadPair('second_multihead')
    jout = p.jhead.apply(p.var, dict(p.jbatch), training=False)
    posts = []
    for load in (jload, tload):
        post = load(MULTI_CFG).MODEL.POST_PROCESSING
        post.NMS_CONFIG.NMS_PRE_MAXSIZE, post.NMS_CONFIG.NMS_POST_MAXSIZE = 64, 32
        post.SCORE_THRESH = 0.3
        posts.append(post)
    jin = {'batch_cls_preds': jout['batch_cls_preds'], 'batch_box_preds': jout['batch_box_preds'],
           'cls_preds_normalized': False}
    tin = {'batch_cls_preds': _t(jout['batch_cls_preds']),
           'batch_box_preds': _t(jout['batch_box_preds']), 'cls_preds_normalized': False}
    want = jax.tree.map(np.asarray, jpp.post_processing(jin, posts[0], num_class=3))
    got = tpp.post_processing(tin, posts[1], 3)
    assert got['pred_valid'].shape == (2, 3 * 32) and want['pred_valid'].sum() > 0
    assert set(np.unique(want['pred_labels'][want['pred_valid']])) == {1, 2, 3}
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits'):
        np.testing.assert_allclose(_np(got[k]), want[k], atol=1e-5, rtol=1e-5, err_msg=k)


ASSIGNERS = [('ATSSTargetAssigner', False), ('ATSSTargetAssigner', True),
             ('AxisAlignedTargetAssigner', True)]


def _jax_iou(fn):
    """The JAX package's IoU ``fn`` per frame, standing in for the port's on
    torch tensors (B, N, 7) × (B, M, 7)."""
    def iou(a, b):
        return _t(jax.vmap(fn)(jnp.asarray(_np(a)), jnp.asarray(_np(b))))
    return iou


def _near_a_threshold(head, gt, labels_differ, match_height):
    """Whether each anchor whose label differs between the packages lies
    within 1e-5 of one of its decisions under the port's own IoU: ATSS a
    candidate's IoU at its gt's mean + std threshold, or a gt's two best
    IoUs; axis-aligned an IoU at its class's matched or unmatched
    threshold."""
    from crb_active_3ddet_torch.ops.iou3d import boxes_iou3d, boxes_iou_bev
    anchors = head.anchors[None, :, :7].expand(gt.shape[0], -1, -1)
    g = _t(gt)
    valid = g.abs().sum(-1) > 0
    ious = (boxes_iou3d if match_height else boxes_iou_bev)(anchors, g[..., :7])
    ious = torch.where(valid[:, None], ious, 0.0)
    ta = head.target_assigner
    near = []
    for b, n in np.argwhere(labels_differ):
        if hasattr(ta, 'topk'):
            d = anchors[b, :, None, :3] - g[b, None, :, :3]
            dist = torch.where(valid[b][None], d.norm(dim=-1), 1e9)
            idx = torch.sort(dist.T, dim=-1, stable=True).indices[:, :ta.topk]
            cand = torch.gather(ious[b].T, 1, idx)
            thr = cand.mean(-1) + cand.std(-1, correction=1) + 1e-6
            top2 = ious[b].topk(2, dim=0).values
            hit = ((idx == n) & ((cand - thr[:, None]).abs() <= 1e-5)).any() \
                | (((top2[0] - top2[1]) <= 1e-5) & (ious[b, n] >= top2[0] - 1e-5) & valid[b]).any()
        else:
            th = torch.tensor(ta.matched_thresholds + ta.unmatched_thresholds)
            hit = ((ious[b, n][:, None] - th[None]).abs() <= 1e-5).any()
        near.append(bool(hit))
    return near


@pytest.mark.parametrize('name, match_height', ASSIGNERS,
                         ids=['atss', 'atss_match_height', 'axis_aligned_match_height'])
def test_assignment_equals_jax(name, match_height, monkeypatch):
    """Given the JAX IoU (the two packages' rotated overlaps part by f32
    rounding), the port assigns exactly as JAX; on its own IoU, only at
    anchors within 1e-5 of a decision."""
    from crb_active_3ddet_torch.models.dense_heads import target_assigner
    from crb_active_3ddet_tpu.ops import iou3d as jiou

    def cfg(load):
        dh = load(IOU_CFG).MODEL.DENSE_HEAD
        dh.TARGET_ASSIGNER_CONFIG.NAME = name
        dh.TARGET_ASSIGNER_CONFIG.MATCH_HEIGHT = match_height
        return dh
    core = jahs.make_core(cfg(jload), 3, CLASSES, np.asarray(HEAD_GRID), list(HEAD_PCR))
    head = tahs.AnchorHeadSingle(cfg(tload), C_IN, 3, CLASSES, HEAD_GRID, HEAD_PCR)
    gt = _gt_boxes(np.random.RandomState(4), scale=0.5)
    want = jax.tree.map(np.asarray, core.assign_targets(jnp.asarray(gt)))
    own = head.assign_targets(_t(gt))
    with monkeypatch.context() as m:
        m.setattr(target_assigner, 'boxes_iou3d', _jax_iou(jiou.boxes_iou3d))
        m.setattr(target_assigner, 'boxes_iou_bev', _jax_iou(jiou.boxes_iou_bev))
        got = head.assign_targets(_t(gt))
    _same_targets(got, want)
    labels = want['box_cls_labels']
    assert set(np.unique(labels[labels > 0])) == {1, 2, 3}
    differ = _np(own['box_cls_labels']) != labels
    near = _near_a_threshold(head, gt, differ, match_height)
    assert all(near), (np.argwhere(differ), near)
    if name == 'ATSSTargetAssigner':
        # the equal Cars (rows 0 and 4) share their best anchor: row 4 takes it
        from crb_active_3ddet_torch.ops.iou3d import boxes_iou3d, boxes_iou_bev
        anchors = head.anchors[None, :, :7].expand(2, -1, -1)
        ious = (boxes_iou3d if match_height else boxes_iou_bev)(anchors, _t(gt[..., :7]))
        best = ious.argmax(1)
        assert torch.equal(best[:, 0], best[:, 4])
        enc = head.box_coder.encode(_t(gt[:, 4:5, :7]), head.anchors[best[:, 4]][:, None])
        for b in range(2):
            assert int(labels[b, best[b, 4]]) == 1
            np.testing.assert_allclose(_np(got['box_reg_targets'][b, best[b, 4]]),
                                       _np(enc[b, 0]), atol=1e-6)
        assert not (labels < 0).any()                      # ATSS ignores no anchor
    else:
        assert (labels < 0).any()


def test_atss_ties_go_to_the_lower_index_and_std_is_unbiased():
    """Two rotations a location tie in distance: the nearest candidates are
    taken in index order, as ``jax.lax.top_k`` takes them; the threshold's
    std has ddof 1."""
    dh = tload(IOU_CFG).MODEL.DENSE_HEAD
    dh.TARGET_ASSIGNER_CONFIG.NAME = 'ATSSTargetAssigner'
    head = tahs.AnchorHeadSingle(dh, C_IN, 3, CLASSES, GRID, PCR)
    gt = _gt_boxes(np.random.RandomState(4))
    anchors = head.anchors[:, :3]
    d = anchors[None, :, None, :] - _t(gt[..., :3])[:, None]
    dist = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2).transpose(1, 2)
    order = torch.sort(dist, dim=-1, stable=True).indices[..., :9]
    jorder = np.asarray(jax.lax.top_k(-jnp.asarray(_np(dist)), 9)[1])
    np.testing.assert_array_equal(_np(order), jorder)
    # the centred Pedestrian's two rotations tie: both among its candidates
    assert (_np(dist[0, 5, order[0, 5, :2]]) == _np(dist[0, 5, order[0, 5, 0]])).all()
    x = torch.tensor([0.1, 0.4, 0.2, 0.9])
    np.testing.assert_allclose(float(x.std(correction=1)), float(jnp.std(jnp.asarray(x.numpy()),
                                                                          ddof=1)), rtol=1e-6)


def _reduced(load):
    c = _reduced_second(load, False)
    multi = load(MULTI_CFG)
    c.MODEL.DENSE_HEAD = multi.MODEL.DENSE_HEAD
    c.MODEL.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
    c.MODEL.POST_PROCESSING = multi.MODEL.POST_PROCESSING
    c.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    c.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 64
    return c


def test_reduced_second_multihead_eval_step():
    jc, tc = _reduced(jload), _reduced(tload)
    jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=False)
    tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0, training=False)
    host = next(iter(tloader))
    jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
    geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
            tuple(float(x) for x in jset.point_cloud_range),
            tuple(float(v) for v in jset.voxel_size))
    jbatch = jtrain.host_to_device_batch(host)
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), jbatch)
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
    for h in range(3):
        head = var['params']['dense_head'][f'head{h}_conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
    tmodel = tdet(tc.MODEL, num_class=3, dataset=tset, device='cpu')
    tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'], tc.MODEL))
    jp, jr = jax.tree.map(np.asarray, jeval.make_eval_step(
        jmodel, jset, jc.MODEL.POST_PROCESSING, 3)(var, jbatch))
    tp, tr = teval.make_eval_step(tmodel, tset, tc.MODEL.POST_PROCESSING, 3)(
        ttrain.host_to_device_batch(host, 'cpu'))
    assert set(tp) == set(jp) and jp['pred_valid'].sum() > 0
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), jp[k], err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), jp[k], atol=1e-4, rtol=1e-4, err_msg=k)
    assert {k: int(v.sum()) for k, v in tr.items()} == {k: int(v.sum()) for k, v in jr.items()}

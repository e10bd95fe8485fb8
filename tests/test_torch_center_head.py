"""The port's CenterHead (``models/dense_heads/center_head.py``) vs the JAX
package's, from the same weights, at a small size (a 12 × 12 BEV map of 16
channels, a shared conv of 8, 3 classes, stride 2, 0.4 m voxels):

- ``make_center_targets`` over padded gts, a gt off the map, one at the
  map's last cell, more gts than ``max_objs``: heatmaps within 1e-6,
  ``inds``, ``mask`` and ``cls_ind`` exactly, regression targets 1e-6;
- ``gaussian_focal_loss`` and ``get_center_loss`` (``reduce`` True and
  False) within rtol 1e-5;
- the forward in eval and in training (BatchNorm on batch statistics, the
  running statistics after it) within 1e-5 of each tensor's largest |value|;
  the gradients of the loss at every parameter and at the input within
  1e-5 of the largest |value|;
- ``decode``: boxes within 1e-5 and labels exactly, with fewer peaks than
  K (the non-peak zeros tie, taken lowest index first) and on a flat
  heatmap (every cell a peak, all tied);
- the score-only post-processing (no model-level NMS_CONFIG) on the decoded
  boxes: boxes and scores within 1e-5, labels and validity exactly, with
  and without a score threshold and a MAX_OBJ_PER_SAMPLE;
- a head built without the voxel size raises.

The Flax variables are drawn from a numpy seed over ``jax.eval_shape`` of
the init (``_fill``) and moved with ``flax_to_state_dict``'s
``center_head_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.models import post_processing as jpp
from crb_active_3ddet_tpu.models.dense_heads import center_head as jch

from crb_active_3ddet_torch.models import post_processing as tpp
from crb_active_3ddet_torch.models.dense_heads import center_head as tch
from crb_active_3ddet_torch.models.dense_heads.anchor_head_single import build_dense_head
from crb_active_3ddet_torch.utils.flax_weights import center_head_from_flax

from test_torch_second_eval import _fill

PCR = (0.0, -4.8, -3.0, 9.6, 4.8, 1.0)
VOXEL = (0.4, 0.4, 4.0)
GRID = (24, 24, 1)
HW = (12, 12)
CLASSES = ('Vehicle', 'Pedestrian', 'Cyclist')
LOSS_CFG = {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                             'code_weights': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5]}}
TOL = 1e-5
TARGET_TOL = 1e-6


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _gts(seed, b=2, m=7):
    """(B, M, 8) gts: frame 0 has 6 (one past the map's +y edge, one at the
    map's last cell, one of each class), the rest padding; frame 1 has 2."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, m, 8), np.float32)
    for f, n in enumerate((6, 2)):
        gt[f, :n, 0] = rng.uniform(0.5, 9.0, n)
        gt[f, :n, 1] = rng.uniform(-4.3, 4.3, n)
        gt[f, :n, 2] = rng.uniform(-2, 0, n)
        gt[f, :n, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
        gt[f, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[f, :n, 7] = 1 + np.arange(n) % 3
    gt[0, 4, :2] = (3.0, 5.2)                 # off the map (cy ≥ 12)
    gt[0, 5, :2] = (9.55, 4.75)               # the map's last cell (11, 11)
    return gt


def _cfg(**extra):
    return {'NAME': 'CenterHead', 'FEATURE_MAP_STRIDE': 2, 'MAX_OBJS': 4,
            'SHARED_CONV_CHANNEL': 8, 'LOSS_CONFIG': LOSS_CFG, **extra}


def _pair(cfg, num_class=3, predict=False, flat=False):
    """The JAX and the port head of ``cfg``, same weights; ``flat``: the
    heatmap's output kernel zero, so that every cell reads its bias."""
    x = np.random.RandomState(5).randn(2, *HW, 16).astype(np.float32)
    jhead = jch.CenterHead(model_cfg=cfg, input_channels=16, num_class=num_class,
                           class_names=CLASSES[:num_class], grid_size=GRID,
                           point_cloud_range=PCR, voxel_size=VOXEL,
                           predict_boxes_when_training=predict)
    shapes = jax.eval_shape(lambda r: jhead.init(r, {'spatial_features_2d': x}),
                            jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
    if flat:
        out = var['params']['hm_out']
        out['kernel'] = np.zeros_like(out['kernel'])
    sd = {}
    center_head_from_flax(sd, {'dense_head': var['params']},
                          {'dense_head': var['batch_stats']})
    thead = build_dense_head(cfg, 16, num_class, CLASSES[:num_class], GRID, PCR,
                             predict_boxes_when_training=predict, voxel_size=VOXEL)
    assert isinstance(thead, tch.CenterHead)
    thead.load_state_dict({k[len('dense_head.'):]: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return jhead, var, thead, x


# ---- targets and losses ------------------------------------------------------

@pytest.mark.parametrize('max_objs', [4, 64], ids=['more_gts_than_max_objs', 'all_gts'])
def test_center_targets_match_jax(max_objs):
    gt = _gts(0)
    want = jax.vmap(lambda g: jch.make_center_targets(
        g, num_classes=3, grid_hw=HW, pcr=jnp.asarray(PCR), voxel_size=jnp.asarray(VOXEL),
        stride=2, max_objs=max_objs))(jnp.asarray(gt))
    got = tch.make_center_targets(torch.from_numpy(gt), 3, HW, PCR, VOXEL, 2, max_objs)
    assert set(got) == set(want)
    _close(got['heatmap'], want['heatmap'], TARGET_TOL, 'heatmap')
    np.testing.assert_allclose(_np(got['reg_targets']), np.asarray(want['reg_targets']),
                               atol=TARGET_TOL, rtol=TARGET_TOL)
    for k in ('inds', 'mask', 'cls_ind'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    mask = _np(got['mask'])
    assert mask.shape == (2, min(max_objs, 7))
    if max_objs == 64:
        assert not mask[0, 4] and mask[0, 5] and not mask[1, 2:].any()
        assert _np(got['inds'])[0, 5] == 12 * 12 - 1
    hm = _np(got['heatmap'])
    assert np.isclose(hm.max(), 1.0) and (hm[1, 2] == 0).all()   # frame 1: no Cyclist


def test_focal_and_center_loss_match_jax():
    rng = np.random.RandomState(1)
    gt = _gts(0)
    targets = jax.vmap(lambda g: jch.make_center_targets(
        g, num_classes=3, grid_hw=HW, pcr=jnp.asarray(PCR), voxel_size=jnp.asarray(VOXEL),
        stride=2, max_objs=4))(jnp.asarray(gt))
    hm = rng.randn(2, *HW, 3).astype(np.float32) - 2
    reg = rng.randn(2, *HW, 8).astype(np.float32)
    want = jax.vmap(jch.gaussian_focal_loss)(jnp.asarray(hm.transpose(0, 3, 1, 2)),
                                             targets['heatmap'])
    got = tch.gaussian_focal_loss(torch.from_numpy(hm.transpose(0, 3, 1, 2)),
                                  torch.from_numpy(np.array(targets['heatmap'])))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL)
    tt = {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}
    for reduce in (True, False):
        jl, jtb = jch.get_center_loss({'center_targets': targets, 'center_heatmap': hm,
                                       'center_reg': reg},
                                      _Cfg(LOSS_CFG), reduce=reduce)
        tl, ttb = tch.get_center_loss({'center_targets': tt, 'center_heatmap':
                                       torch.from_numpy(hm), 'center_reg':
                                       torch.from_numpy(reg)}, LOSS_CFG, reduce=reduce)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=TOL)
        assert set(ttb) == set(jtb)
        for k in jtb:
            np.testing.assert_allclose(_np(ttb[k]), np.asarray(jtb[k]), rtol=TOL, err_msg=k)
        assert _np(tl).shape == (() if reduce else (2,))


class _Cfg(dict):
    """The JAX loss reads ``loss_cfg.LOSS_WEIGHTS``."""
    __getattr__ = dict.__getitem__


# ---- the forward --------------------------------------------------------------

@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_forward_matches_jax(training):
    cfg = _cfg()
    jhead, var, thead, x = _pair(cfg, predict=True)
    gt = _gts(0)

    def jrun(params, x):
        batch = {'spatial_features_2d': x, 'gt_boxes': gt}
        out, mutated = jhead.apply({**var, 'params': params}, batch, training=training,
                                   mutable=['batch_stats'])
        loss = jch.get_center_loss(out, _Cfg(LOSS_CFG))[0] if training else \
            (out['center_heatmap'] ** 2).sum()
        return loss, (out, mutated)
    (jloss, (jout, mutated)), (jgp, jgx) = jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True)(var['params'], jnp.asarray(x))
    thead.train(training)
    tx = torch.from_numpy(x).requires_grad_()
    tout = thead({'spatial_features_2d': tx, 'gt_boxes': torch.from_numpy(gt)})
    tloss = tch.get_center_loss(tout, LOSS_CFG)[0] if training else \
        (tout['center_heatmap'] ** 2).sum()
    tloss.backward()
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=TOL)
    for k in ('center_heatmap', 'center_reg', 'batch_box_preds', 'batch_cls_preds',
              'rpn_preds'):
        _close(tout[k], jout[k], TOL, k)
    assert tout['rpn_preds'].shape == (2, *HW, 3) and not tout['cls_preds_normalized']
    assert ('center_targets' in tout) == training
    sd = {}
    center_head_from_flax(sd, {'dense_head': jax.tree.map(np.asarray, jgp)},
                          {'dense_head': var['batch_stats']})
    for name, p in thead.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad    # a branch the loss skips
        _close(grad, sd[f'dense_head.{name}'], TOL, f'grad {name}')
    _close(tx.grad, jgx, TOL, 'grad of the input')
    if training:
        bn = thead.shared_conv[1]
        js = mutated['batch_stats']['BatchNorm_0']
        _close(bn.running_mean, js['mean'], TOL, 'running mean')
        _close(bn.running_var, js['var'], TOL, 'running var')


@pytest.mark.parametrize('flat', [False, True], ids=['few_peaks', 'flat_heatmap'])
def test_decode_with_ties_matches_jax(flat):
    """K = 64 of 2 × 12 × 12 cells: with the trained-like negative bias few
    cells are peaks and the zeros tie; on a flat heatmap every cell ties."""
    cfg = _cfg(MAX_OBJS=64)
    jhead, var, thead, x = _pair(cfg, num_class=2, flat=flat)
    jout = jhead.apply(var, {'spatial_features_2d': x}, training=False)
    thead.eval()
    with torch.no_grad():
        tout = thead({'spatial_features_2d': torch.from_numpy(x)})
    hm = np.asarray(jout['center_heatmap'])
    peaks = np.asarray(jax.nn.sigmoid(hm))
    labels_j = np.asarray(jout['batch_cls_preds']).argmax(-1)
    labels_t = _np(tout['batch_cls_preds']).argmax(-1)
    np.testing.assert_array_equal(labels_t, labels_j)
    np.testing.assert_allclose(_np(tout['batch_box_preds']), np.asarray(jout['batch_box_preds']),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tout['batch_cls_preds']), np.asarray(jout['batch_cls_preds']),
                               atol=TOL, rtol=TOL)
    scores = np.asarray(jout['batch_cls_preds']).max(-1)
    if flat:
        assert (np.ptp(peaks, axis=(0, 1, 2)) == 0).all()      # one value a class
    else:
        # a zero score is clipped to 1e-6: logit −13.8
        assert (scores < -13).sum() > 0, 'no tied zeros among the picks'

    # the score-only selection over the decoded boxes
    for post in ({}, {'SCORE_THRESH': 0.1}, {'SCORE_THRESH': 0.1, 'MAX_OBJ_PER_SAMPLE': 16}):
        want = jpp.post_processing(jout, post, num_class=2)
        got = tpp.post_processing(tout, post, num_class=2)
        assert set(got) == set(want)
        for k in ('pred_valid', 'pred_labels'):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
        for k in ('pred_boxes', 'pred_scores', 'pred_logits'):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=TOL, rtol=TOL,
                                       err_msg=k)
        assert got['pred_boxes'].shape[1] == post.get('MAX_OBJ_PER_SAMPLE', 64)


def test_center_head_without_voxel_size_raises():
    """Without the voxel size the head would place its targets and boxes in
    cells, not metres: it raises instead."""
    with pytest.raises(ValueError, match='voxel size'):
        build_dense_head(_cfg(), 16, 3, CLASSES, GRID, PCR)

"""One PV-RCNN++ train step in the port vs the JAX package, from the same
weights and one RoI sample.

- The reduced pv_rcnn_plusplus.yaml of ``tests/test_torch_pvrcnn_plusplus.py``
  in training, DP_RATIO 0: the JAX sampler draws one RoI sample (a fixed
  key) from proposals made from the gt boxes; the JAX model gets it through
  its patched proposal layer and sampler (its early proposal step calls
  both), the port's as ``rois`` + ``roi_targets_dict``, which its early
  proposal step keeps.  In f32: every loss term rtol 1e-5, the keypoint
  labels exactly, the sampled RoIs' rcnn_cls 1e-4 and every BatchNorm
  statistic atol 1e-6 (the vector pools' over every (B, M, G) row); in
  float64 on both sides (``jax.enable_x64``): the keypoints equal, every
  loss term rtol 1e-5 and every parameter's gradient within 1e-4 of its
  norm (read: ≤ 1.6e-5).  That is as close as the float64 steps come: the
  JAX sparse convs compute in f32 even under x64 (``compute_dtype``,
  ``spconv_backbone.py:198-204``), and the backbone's training-mode
  BatchNorms carry their rounding into the BEV map at 1.7e-6 of its
  largest value, where the port's f64 step keeps f64.  The gt boxes and
  the anchors stay f32 on both sides (the anchor assigner's force match
  ties by float equality, and the JAX anchors are f32 constants), the
  points f64 (so that both VFEs average in f64).

Torch ops run on one thread.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_pointrcnn import _double, _f64
from test_torch_pvrcnn_plusplus import Pair, _np, _t
from test_torch_pvrcnn_train import make_proposals

GIVEN_KEYS = ('rois', 'roi_labels', 'roi_valid', 'roi_scores')
LOSSES = ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss', 'point_loss', 'rcnn_loss_cls',
          'rcnn_loss_reg', 'rcnn_loss', 'loss')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def tr():
    p = Pair('pv_rcnn_plusplus', training=True, dp=0.0)
    props = make_proposals(np.asarray(p.host['gt_boxes']), np.random.RandomState(1))
    given = {k: props[k] for k in GIVEN_KEYS}
    sampler = p.jcfg.ROI_HEAD.TARGET_CONFIG
    key = jax.random.PRNGKey(5)
    targets = jax.tree.map(np.asarray, jax.jit(
        lambda pr: jrht.assign_targets(key, dict(pr), sampler))(props))

    def step(params, batch_stats, h, rois, tg):
        def loss_fn(pp):
            with mock.patch.object(jrht, 'proposal_layer', lambda bd, *a, **k: {**bd, **rois}), \
                    mock.patch.object(jrht, 'assign_targets', lambda *a: dict(tg)):
                out, mut = p.jmodel.apply(
                    {'params': pp, 'batch_stats': batch_stats},
                    jtrain.prepare_device_batch(h, *p.geom), training=True,
                    mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(2)})
            loss, tb = p.jmodel.compute_loss(out)
            return loss, (tb, mut['batch_stats'], out['point_cls_labels'],
                          out['roi_targets']['rcnn_cls'], out['point_coords'])
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    (_, (p.jtb, jstats, p.jlabels, p.jcls, p.jkp)), jgrads = jax.tree.map(
        np.asarray, jax.jit(step)(p.var['params'], p.var['batch_stats'], p.jbatch, given,
                                  targets))
    p.jgrads = flax_to_state_dict(jgrads, p.var['batch_stats'], p.tcfg)
    p.jstats = flax_to_state_dict(p.var['params'], jstats, p.tcfg)
    # the gt boxes and the anchors stay f32 on both sides (the module
    # docstring)
    host64 = {**p.jbatch, 'points': np.asarray(p.jbatch['points'], np.float64)}
    with jax.enable_x64(True):
        (_, (tb64, _, _, _, kp64)), g64 = jax.tree.map(np.asarray, jax.jit(step)(
            *_f64((p.var['params'], p.var['batch_stats'])), host64, *_f64((given, targets))))
    p.jtb64, p.jkp64 = tb64, kp64
    p.jgrads64 = flax_to_state_dict(g64, p.var['batch_stats'], p.tcfg)

    rois = {'rois': _t(targets['rois']), 'roi_labels': _t(targets['roi_labels']),
            'roi_valid': torch.ones(targets['rois'].shape[:2], dtype=torch.bool),
            'roi_targets_dict': {k: _t(v) for k, v in targets.items()}}
    batch = {**p.tbatch(), **rois}
    init = {k: v.clone() for k, v in p.tmodel.state_dict().items()}
    p.tout = p.tmodel(batch)
    loss, p.ttb = p.tmodel.compute_loss(p.tout)
    loss.backward()
    m64 = tdet(p.tcfg, num_class=3, dataset=p.ds, device='cpu').double()
    m64.load_state_dict(_double(init))
    m64.dense_head.anchors = m64.dense_head.anchors.float()
    m64.train()
    out64 = m64({**_double(batch), 'gt_boxes': batch['gt_boxes']})
    p.tkp64 = out64['point_coords']
    loss64, p.ttb64 = m64.compute_loss(out64)
    loss64.backward()
    p.tgrads64 = {n: prm.grad for n, prm in m64.named_parameters()}
    return p


def test_train_losses_match(tr):
    for k in LOSSES:
        np.testing.assert_allclose(float(tr.ttb[k].detach()), float(tr.jtb[k]), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(float(tr.ttb64[k].detach()), float(tr.jtb64[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tr.jtb['rcnn_loss_reg']) > 0 and float(tr.jtb['point_loss']) > 0
    np.testing.assert_array_equal(_np(tr.tout['point_cls_labels']), tr.jlabels)
    assert all((tr.jlabels == c).any() for c in (0, 1))
    np.testing.assert_array_equal(_np(tr.tout['point_coords']), tr.jkp)
    np.testing.assert_array_equal(_np(tr.tkp64), tr.jkp64)
    np.testing.assert_allclose(_np(tr.tout['roi_targets']['rcnn_cls']), tr.jcls,
                               atol=1e-4, rtol=1e-4)


def test_train_gradients_float64(tr):
    checked = 0
    for name, _ in tr.tmodel.named_parameters():
        ref = tr.jgrads64[name].numpy()
        got = _np(tr.tgrads64[name])
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), name
        checked += 'local_kernel' in name
    assert checked == 2 * 4


def test_train_batch_norm_statistics(tr):
    got = tr.tmodel.state_dict()
    names = [k for k in got if k.endswith(('running_mean', 'running_var'))]
    assert sum('.local_bn.' in k for k in names) == 2 * 2 * 4
    for k in names:
        np.testing.assert_allclose(_np(got[k]), tr.jstats[k].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)

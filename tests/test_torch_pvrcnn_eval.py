"""The port's PV-RCNN eval slice vs the JAX package, from the same weights.

A small PV-RCNN (``pv_rcnn_synth.yaml`` cut to a 128×128×40 grid, narrow BEV
and point-branch widths, 256 keypoints, 16 RoIs on a 4³ grid, batch 2, f32).
The Flax variables are made from a numpy seed (shapes from ``jax.eval_shape``
of the JAX model's init with ``training=False``) and moved into the port with
``utils/flax_weights.py``.  The conv_cls bias is set, from one forward of the
port, to minus each channel's mean logit: every class then reaches the top
proposals, so RoI labels differ, and the final scores sit near 0.5.

Tolerances: keypoints (the FPS selection), RoI validity, RoI labels,
``pred_valid`` and ``pred_labels`` exactly; ``point_features``, ``rcnn_cls``,
``rcnn_reg``, ``pred_boxes``, ``pred_scores`` and the tensors between them at
atol/rtol 1e-4 (same f32 formulas, summation order differs in the matrix
products and convolutions).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import init_weights
from crb_active_3ddet_torch.ops import cuda_fps
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/synthetic_models/pv_rcnn_synth.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)


def _reduced(load):
    c = load(CFG)
    d = c.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]     # 128×128×40 voxels
    d.NUM_SCENES, d.NUM_BG_POINTS, d.MAX_OBJECTS = 2, 1200, 4
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = c.MODEL
    m.BACKBONE_3D.USE_BF16 = m.BACKBONE_2D.USE_BF16 = False
    m.BACKBONE_3D.VOXEL_CAPS = [384, 256, 128, 128]
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1], [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    m.PFE.NUM_KEYPOINTS, m.PFE.NUM_OUTPUT_FEATURES = 256, 32
    m.PFE.FEATURES_SOURCE = ['bev', 'x_conv3', 'x_conv4', 'raw_points']
    for src, layer in m.PFE.SA_LAYER.items():
        layer.MLPS = [[8, 8], [8, 8]]
        layer.NSAMPLE = [8, 8]
    m.POINT_HEAD.CLS_FC = [32, 32]
    r = m.ROI_HEAD
    r.SHARED_FC, r.CLS_FC, r.REG_FC = [64, 64], [32, 32], [32, 32]
    r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 128
    r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 16
    r.ROI_GRID_POOL.GRID_SIZE = 4
    r.ROI_GRID_POOL.MLPS = [[16, 16], [16, 16]]
    r.ROI_GRID_POOL.NSAMPLE = [8, 8]
    return c


def _fill(rng):
    def fill(path, s):
        name = '/'.join(str(p.key) for p in path)
        if name.endswith('var'):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if name.endswith(('mean', 'bias')):
            return (0.05 * rng.randn(*s.shape)).astype(np.float32)
        if name.endswith('scale'):
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return fill


class Pair:
    """The JAX and the port PV-RCNN of one config, same weights, same batch,
    each run once through its own ``make_eval_step`` and once as a bare
    forward."""

    def __init__(self):
        jc, tc = _reduced(jload), _reduced(tload)
        self.tc = tc
        jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0,
                            training=False)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2,
                                       workers=0, training=False)
        self.host = next(iter(tloader))
        jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
        geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
                tuple(float(x) for x in jset.point_cloud_range),
                tuple(float(v) for v in jset.voxel_size))
        jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: jmodel.init(
                r, jtrain.prepare_device_batch(h, *geom), training=False),
            jax.random.PRNGKey(0), jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)),
                                               shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.variables = var
        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(
            var['params'], var['batch_stats'], tc.MODEL))
        tbatch = ttrain.host_to_device_batch(self.host, 'cpu')
        self.tmodel.eval()
        with torch.no_grad():
            logits = self.tmodel(ttrain.prepare_device_batch(tbatch, *geom))['cls_preds']
        head['bias'] = -logits.mean(dim=(0, 1, 2)).numpy()
        self.tmodel.load_state_dict(flax_to_state_dict(
            var['params'], var['batch_stats'], tc.MODEL))
        # one jitted program gives the forward's tensors and the step's outputs
        jstep = jeval.make_eval_step(jmodel, jset, jc.MODEL.POST_PROCESSING, 3)

        @jax.jit
        def both(v, h):
            out = jmodel.apply(v, jtrain.prepare_device_batch(h, *geom),
                               training=False)
            keep = ('point_coords', 'point_coords_valid',
                    'point_features_before_fusion', 'point_features',
                    'point_cls_preds', 'point_cls_scores', 'rois', 'roi_scores',
                    'roi_labels', 'roi_valid', 'full_cls_scores', 'rcnn_cls',
                    'rcnn_reg', 'batch_cls_preds', 'batch_box_preds')
            return {k: out[k] for k in keep}, jstep(v, h)
        self.jout, (self.jpreds, self.jrec) = both(var, jbatch)
        tstep = teval.make_eval_step(self.tmodel, self.tset,
                                     tc.MODEL.POST_PROCESSING, 3)
        self.fps_launches = cuda_fps.launches
        self.tpreds, self.trec = tstep(tbatch)
        self.fps_launches = cuda_fps.launches - self.fps_launches
        with torch.no_grad():
            self.tout = self.tmodel(ttrain.prepare_device_batch(tbatch, *geom))


@pytest.fixture(scope='module')
def pair():
    return Pair()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_weight_transfer_is_complete(pair):
    """Every key of the port model's state_dict is produced, with its shape,
    and every Flax leaf is used once."""
    sd = flax_to_state_dict(pair.variables['params'],
                            pair.variables['batch_stats'], pair.tc.MODEL)
    want = pair.tmodel.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n_flax = sum(np.size(x) for x in jax.tree.leaves(pair.variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith('num_batches_tracked'))
    assert n_flax == n_port
    for k in ('pfe.SA_rawpoints.mlps.0.0.weight', 'pfe.SA_layers.1.mlps.1.3.weight',
              'pfe.vsa_point_feature_fusion.0.weight',
              'point_head.cls_layers.6.bias',
              'roi_head.roi_grid_pool_layer.mlps.1.4.running_var',
              'roi_head.shared_fc_layer.4.weight', 'roi_head.cls_layers.7.bias',
              'roi_head.reg_layers.7.weight'):
        assert k in sd, k


def test_keypoints_equal(pair):
    """The FPS selection: the keypoints are the same points, exactly."""
    np.testing.assert_array_equal(_np(pair.tout['point_coords']),
                                  _np(pair.jout['point_coords']))
    np.testing.assert_array_equal(_np(pair.tout['point_coords_valid']),
                                  _np(pair.jout['point_coords_valid']))
    kp = _np(pair.tout['point_coords'])
    assert kp.shape == (2, 256, 3)
    assert all(len(np.unique(f, axis=0)) == 256 for f in kp)
    assert pair.fps_launches == 0            # CPU tensors: the plain version


def test_point_branch_matches(pair):
    for k in ('point_features_before_fusion', 'point_features',
              'point_cls_preds', 'point_cls_scores'):
        np.testing.assert_allclose(_np(pair.tout[k]), _np(pair.jout[k]), **TOL,
                                   err_msg=k)
    f = _np(pair.tout['point_features_before_fusion'])
    assert f.shape[-1] == pair.tmodel.pfe.num_point_features_before_fusion
    live = np.abs(f).max(axis=(0, 1)) > 0
    for lo, hi in ((0, 256), (256, 272), (272, 288), (288, 304)):
        assert live[lo:hi].any(), (lo, hi)     # bev, raw points, x_conv3, x_conv4


def test_proposals_equal(pair):
    """RoI validity and labels exactly; the RoIs within tolerance."""
    for k in ('roi_valid', 'roi_labels'):
        np.testing.assert_array_equal(_np(pair.tout[k]), _np(pair.jout[k]),
                                      err_msg=k)
    for k in ('rois', 'roi_scores', 'full_cls_scores'):
        np.testing.assert_allclose(_np(pair.tout[k]), _np(pair.jout[k]), **TOL,
                                   err_msg=k)
    valid = _np(pair.tout['roi_valid'])
    assert valid.shape == (2, 16) and valid.all()
    labels = _np(pair.tout['roi_labels'])
    assert labels.min() >= 1 and len(np.unique(labels)) > 1


def test_roi_head_matches(pair):
    for k in ('rcnn_cls', 'rcnn_reg', 'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(_np(pair.tout[k]), _np(pair.jout[k]), **TOL,
                                   err_msg=k)
    assert _np(pair.tout['rcnn_cls']).shape == (32, 1)
    assert _np(pair.tout['rcnn_reg']).shape == (32, 7)


def test_roi_head_takes_given_rois(pair):
    """With ``rois`` in the batch dict the head pools those and skips the
    proposal layer."""
    batch = {k: pair.tout[k] for k in
             ('point_coords', 'point_coords_valid', 'point_features',
              'point_cls_scores')}
    batch['rois'] = torch.flip(pair.tout['rois'], dims=[1])
    with torch.no_grad():
        out = pair.tmodel.roi_head(batch)
    np.testing.assert_allclose(
        _np(out['rcnn_cls']).reshape(2, 16)[:, ::-1],
        _np(pair.tout['rcnn_cls']).reshape(2, 16), **TOL)
    assert 'roi_labels' not in out


def test_eval_step_matches_f32(pair):
    """The whole slice: port make_eval_step vs JAX make_eval_step."""
    jp, tp = pair.jpreds, pair.tpreds
    assert set(tp) == set(jp)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits',
              'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    for k in pair.jrec:
        np.testing.assert_array_equal(_np(pair.trec[k]), _np(pair.jrec[k]),
                                      err_msg=k)
    kept = _np(tp['pred_valid']).sum(-1)
    assert np.all(kept > 0) and np.all(kept < 16), kept
    # two-stage outputs: labels are the RoIs' classes, logits the RPN's
    assert _np(tp['pred_logits']).shape[-1] == 3
    assert set(np.unique(_np(tp['pred_labels'])[_np(tp['pred_valid'])])) \
        <= set(np.unique(_np(pair.tout['roi_labels'])))


def test_pvrcnn_defaults_to_cuda_and_seeded_init(pair):
    """``build_detector`` for PVRCNN raises without a card unless given
    device='cpu'; ``init_weights`` copes with the point branch's shapes."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tdet(pair.tc.MODEL, 3, pair.tset)
    model = tdet(pair.tc.MODEL, 3, pair.tset, device='cpu')
    assert model.device.type == 'cpu'
    assert model.module_topology == ('vfe', 'backbone_3d', 'map_to_bev', 'pfe',
                                     'backbone_2d', 'dense_head', 'point_head',
                                     'roi_head')
    init_weights(model, torch.Generator().manual_seed(3))
    w = model.roi_head.shared_fc_layer[0].weight        # (64, 4³·32, 1)
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1) < 0.05
    w = model.pfe.SA_rawpoints.mlps[0][0].weight        # (8, 4, 1, 1)
    assert w.shape == (8, 4, 1, 1) and 0.1 < w.std().item() < 1.5
    step = teval.make_eval_step(model, pair.tset, pair.tc.MODEL.POST_PROCESSING, 3)
    preds, _ = step(ttrain.host_to_device_batch(pair.host, 'cpu'))
    assert all(torch.isfinite(v).all() for v in preds.values()
               if v.dtype.is_floating_point)

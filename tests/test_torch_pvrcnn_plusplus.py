"""PV-RCNN++ in the port (``models/backbones_3d/pfe.py`` SPC sampling and
vector-pool VSA, ``models/roi_heads/pvrcnn_head.py`` vector-pool RoI grid
pool, ``models/detectors/detector3d.py`` early proposals) vs the JAX
package, from the same numpy inputs and the same weights.

- SPC's candidate mask (``pfe.spc_candidates``) against the mask the JAX
  VSA hands its FPS (read through a spy on ``farthest_point_sample``):
  zero-padded RoI rows that make the points near the origin candidates, a
  frame without a candidate that falls back to its valid points, padded
  points near a RoI, point 0 outside every RoI's reach (FPS starts there
  all the same); the keypoints and their validity (a keypoint's point's,
  not its candidacy) equal;
- ``reduced``: pv_rcnn_plusplus.yaml's (or the resnet file's) MODEL cut as
  ``tests/test_config_zoo.py:_shrink`` cuts a config (64 keypoints,
  GRID_SIZE 3, TEST proposals 256 → 32, TRAIN 256 → 64, 16 RoIs sampled a
  frame), f32, narrow BEV, point head and towers, over a 12.8 m square of
  Waymo's 0.1 × 0.1 × 0.15 m voxels with 3 200 points a frame (a `Fake`
  dataset surface; a 1 024-voxel buffer that the frames overflow, the
  file's VOXEL_CAPS), every SA width, lattice and reduction as the file
  sets it.  pv_rcnn_plusplus.yaml's eval forward and eval step in one
  jitted JAX program: keypoints, RoI labels and validity, predicted labels,
  validity and recall exactly; RoIs, point features, head outputs, boxes
  and scores within 1e-4.  ``tests/test_torch_pvrcnn_plusplus_resnet.py``
  holds the resnet file the same way, ``tests/test_torch_pvrcnn_plusplus_train.py``
  the train step.

Torch ops run on one thread.
"""

import copy
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import CfgNode as JCfg
from crb_active_3ddet_tpu.models import post_processing as jpp
from crb_active_3ddet_tpu.models.backbones_3d import pfe as jpfe
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.ops import pointnet2 as jpn2
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import CfgNode as TCfg
from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.models.backbones_3d import pfe as tpfe
from crb_active_3ddet_torch.models.backbones_3d.vector_pool import VectorPoolAggregationMSG
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.ops import pointnet2 as tpn2
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_centerpoint import Fake, _geom, _host
from test_torch_cli import _plain
from test_torch_second_eval import _fill

ROOT = Path(__file__).resolve().parent.parent
WAYMO = ROOT / 'tools/cfgs/waymo_models'
RANGE = [-6.4, -6.4, -2, 6.4, 6.4, 4]
CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']
TOL = dict(atol=1e-4, rtol=1e-4)
EVAL_KEYS = ('rois', 'roi_labels', 'roi_valid', 'roi_scores', 'point_coords',
             'point_coords_valid', 'point_features_before_fusion', 'point_features',
             'point_cls_scores', 'rcnn_cls', 'rcnn_reg', 'batch_cls_preds', 'batch_box_preds')


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


def reduced(name, dp=0.3):
    """``{name}.yaml``'s MODEL (a plain dict) at the cuts of the module
    docstring, and its dataset surface over a 12.8 m square."""
    m = tload(WAYMO / f'{name}.yaml').MODEL
    m.BACKBONE_3D.USE_BF16 = False
    b = m.BACKBONE_2D
    b.LAYER_NUMS, b.NUM_FILTERS, b.NUM_UPSAMPLE_FILTERS = [1, 1], [16, 32], [16, 16]
    if m.DENSE_HEAD.NAME == 'CenterHead':
        m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
        m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
        m.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 64
    m.PFE.NUM_KEYPOINTS = 64
    m.POINT_HEAD.CLS_FC = [32, 32]
    r = m.ROI_HEAD
    r.SHARED_FC, r.CLS_FC, r.REG_FC, r.DP_RATIO = [64, 64], [32, 32], [32, 32], dp
    r.ROI_GRID_POOL.GRID_SIZE = 3
    r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE, r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 256, 32
    r.NMS_CONFIG.TEST.MATRIX_CAP = 256
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = r.NMS_CONFIG.TRAIN.MATRIX_CAP = 256
    r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 64
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    return _plain(m), Fake(CLASSES, RANGE, [0.1, 0.1, 0.15], 5, 1024, 5)


class Pair:
    """The JAX and the port PV-RCNN++ of one reduced config, same weights,
    same host batch."""

    def __init__(self, name, training=False, dp=0.3):
        cfg, self.ds = reduced(name, dp)
        self.jcfg, self.tcfg = JCfg(copy.deepcopy(cfg)), TCfg(copy.deepcopy(cfg))
        self.host = _host(self.ds, 0)
        self.geom = _geom(self.ds)
        self.jmodel = jdet(self.jcfg, num_class=3, dataset=self.ds)
        self.jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(r, jtrain.prepare_device_batch(h, *self.geom),
                                          training=False),
            jax.random.PRNGKey(0), self.jbatch)
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        self.tmodel = tdet(self.tcfg, num_class=3, dataset=self.ds, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.var['params'],
                                                       self.var['batch_stats'], self.tcfg))
        self.tmodel.train(training)

    def tbatch(self):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(self.host, 'cpu'),
                                           *self.geom)


def jax_eval(p):
    """The JAX eval step (``runtime/eval.make_eval_step``'s body) that also
    returns the forward's tensors: one jitted program."""
    post = p.jcfg.POST_PROCESSING

    @jax.jit
    def run(v, h):
        batch = jtrain.prepare_device_batch(h, *p.geom)
        out = p.jmodel.apply(v, batch, training=False)
        preds = jpp.post_processing(out, post, num_class=3)
        gt = batch['gt_boxes']
        rec = jax.vmap(jpp.generate_recall_record)(
            preds['pred_boxes'], preds['pred_valid'], gt[..., :7], jnp.abs(gt).sum(-1) > 0)
        return {k: out[k] for k in EVAL_KEYS}, preds, rec
    return jax.tree.map(np.asarray, run(p.var, p.jbatch))


def check_eval(p, jout, jpreds, jrec):
    """The port's eval forward and eval step against the JAX program's."""
    p.tmodel.eval()
    with torch.no_grad():
        tout = p.tmodel(p.tbatch())
    for k in ('roi_labels', 'roi_valid', 'point_coords', 'point_coords_valid'):
        np.testing.assert_array_equal(_np(tout[k]), jout[k], err_msg=k)
    for k in EVAL_KEYS:
        np.testing.assert_allclose(_np(tout[k]), jout[k], **TOL, err_msg=k)
    assert jout['roi_valid'].sum() > 10
    tstep = teval.make_eval_step(p.tmodel, p.ds, p.tcfg.POST_PROCESSING, 3)
    tp, tr = tstep(ttrain.host_to_device_batch(p.host, 'cpu'))
    assert set(tp) == set(jpreds)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), jpreds[k], err_msg=k)
    assert jpreds['pred_valid'].sum() > 0
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), jpreds[k], **TOL, err_msg=k)
    assert {k: int(_np(v).sum()) for k, v in tr.items()} == \
        {k: int(np.asarray(v).sum()) for k, v in jrec.items()}
    return tout


# ---- SPC ------------------------------------------------------------------------------

SPC_CFG = {'NAME': 'VoxelSetAbstraction', 'NUM_KEYPOINTS': 48, 'NUM_OUTPUT_FEATURES': 8,
           'SAMPLE_METHOD': 'SPC',
           'SPC_SAMPLING': {'NUM_SECTORS': 6, 'SAMPLE_RADIUS_WITH_ROI': 1.6},
           'FEATURES_SOURCE': ['bev'], 'SA_LAYER': {}}


def _spc_case(case):
    """(points (2, N, 4), valid (2, N), rois (2, R, 7)): frame 0 with RoIs
    around some points, zero-padded RoI rows (``zero_rows``) and point 0
    outside every RoI's reach and the origin's; frame 1 with every RoI far
    from its points (``fallback``) or about its points (``no_zero_rows``)."""
    rng = np.random.RandomState(5)
    n, r = 600, 8
    pts = np.zeros((2, n, 4), np.float32)
    pts[..., :2] = rng.uniform(-12, 12, (2, n, 2))
    pts[..., 2] = rng.uniform(-1, 1, (2, n))
    pts[..., 3] = rng.rand(2, n)
    pts[:, 1:40, :2] = rng.uniform(-1.5, 1.5, (2, 39, 2))      # about the origin
    pts[:, 0, :3] = [11.5, -11.5, 0.5]
    valid = np.ones((2, n), bool)
    valid[:, n - 50:] = False                                   # padding rows
    rois = np.zeros((2, r, 7), np.float32)
    for f in range(2):
        at = pts[f, rng.randint(60, n - 50, r), :3]
        rois[f, :, :3] = at + rng.uniform(-0.5, 0.5, (r, 3))
        rois[f, :, 3:6] = rng.uniform(0.5, 4.5, (r, 3))
        rois[f, :, 6] = rng.uniform(-np.pi, np.pi, r)
    rois[0, :, :2] = np.clip(rois[0, :, :2], -9, 9)
    pts[0, n - 50:, :3] = rois[0, rng.randint(0, r, 50), :3]   # padded points at RoIs
    if case == 'zero_rows':
        rois[0, -2:] = 0.0
        rois[1, :, :2] += 60.0                                  # no candidate: fallback
    return pts, valid, rois


def _jax_spc(pts, valid, rois):
    """(the candidate masks the JAX VSA gives its FPS, its keypoints and
    their validity)."""
    vsa = jpfe.VoxelSetAbstraction(model_cfg=JCfg(SPC_CFG), voxel_size=(0.1, 0.1, 0.15),
                                   point_cloud_range=(-12.8, -12.8, -2, 12.8, 12.8, 4),
                                   num_bev_features=8, num_rawpoint_features=4)
    batch = {'points': jnp.asarray(pts), 'points_valid': jnp.asarray(valid),
             'rois': jnp.asarray(rois), 'spatial_features': jnp.zeros((2, 4, 4, 8)),
             'spatial_features_stride': 64}
    shapes = jax.eval_shape(lambda k: vsa.init(k, batch), jax.random.PRNGKey(0))
    var = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    seen, real = [], jpn2.farthest_point_sample

    def spy(points, v, num_samples):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), v)
        return real(points, v, num_samples)
    with mock.patch.object(jpn2, 'farthest_point_sample', spy):
        out = vsa.apply(var, batch)
    return np.stack(seen), np.asarray(out['point_coords']), np.asarray(out['point_coords_valid'])


@pytest.mark.parametrize('case', ['zero_rows', 'no_zero_rows'])
def test_spc_candidates_match_jax(case):
    pts, valid, rois = _spc_case(case)
    jmask, jkp, jkp_valid = _jax_spc(pts, valid, rois)
    mask = tpfe.spc_candidates(_t(pts[..., :3]), _t(valid), _t(rois), 1.6)
    np.testing.assert_array_equal(_np(mask), jmask)
    m = _np(mask)
    assert not m[0, 0] and m[0].sum() < valid[0].sum()        # point 0 is no candidate
    assert not (m & ~valid).any()                              # padding never is
    near_origin = np.linalg.norm(pts[0, 1:40, :3], axis=-1) < 1.6
    if case == 'zero_rows':
        assert m[0, 1:40][near_origin].all()                   # the zero RoI rows' reach
        np.testing.assert_array_equal(m[1], valid[1])          # fallback
    else:
        assert m[1].sum() < valid[1].sum()
    xyz = _t(pts[..., :3])
    idx = tpn2.farthest_point_sample(xyz, mask, 48).long()
    assert (idx[:, 0] == 0).all()
    kp = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    np.testing.assert_array_equal(_np(kp), jkp)
    kp_valid = torch.gather(_t(valid), 1, idx)
    np.testing.assert_array_equal(_np(kp_valid), jkp_valid)
    assert not jmask[0, 0] and jkp_valid[0, 0]                 # validity, not candidacy


def test_spc_candidates_chunked(monkeypatch):
    """The (B, N, R) test over chunks of points equals one step's."""
    pts, valid, rois = _spc_case('zero_rows')
    whole = tpfe.spc_candidates(_t(pts[..., :3]), _t(valid), _t(rois), 1.6)
    monkeypatch.setattr(tpfe, '_SPC_CHUNK', 37)
    assert torch.equal(tpfe.spc_candidates(_t(pts[..., :3]), _t(valid), _t(rois), 1.6), whole)


# ---- the reduced pv_rcnn_plusplus.yaml --------------------------------------------------

@pytest.fixture(scope='module')
def ev():
    p = Pair('pv_rcnn_plusplus')
    p.jout, p.jpreds, p.jrec = jax_eval(p)
    return p


def test_weight_transfer_is_complete(ev):
    sd = flax_to_state_dict(ev.var['params'], ev.var['batch_stats'], ev.tcfg)
    assert set(sd) == set(ev.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(ev.var))
    assert n_flax == sum(v.numel() for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    m = ev.tmodel
    assert m.module_topology == ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d', 'dense_head',
                                 'roi_proposal', 'pfe', 'point_head', 'roi_head')
    pools = [m.pfe.SA_rawpoints, *m.pfe.SA_layers, m.roi_head.roi_grid_pool_layer]
    assert all(isinstance(x, VectorPoolAggregationMSG) for x in pools)
    assert [x.layers[0].c_red for x in pools] == [2, 32, 32, 30]
    assert [x.layers[1].local_kernel.shape for x in pools] == [
        (27, 5, 32), (27, 35, 32), (27, 35, 32), (27, 33, 32)]
    assert m.pfe.num_point_features_before_fusion == 256 + 128 + 128 + 32
    assert m.roi_head.shared_fc_layer[0].weight.shape == (64, 27 * 128, 1)


def test_eval_matches_jax(ev):
    tout = check_eval(ev, ev.jout, ev.jpreds, ev.jrec)
    assert _np(tout['point_coords_valid']).all()
    # SPC kept its candidates about the RoIs: the keypoints lie within reach
    rois = _np(tout['rois'])
    kp = _np(tout['point_coords'])
    reach = np.linalg.norm(rois[..., 3:6] / 2, axis=-1) + 1.6
    d = np.linalg.norm(kp[:, :, None] - rois[:, None, :, :3], axis=-1)
    assert (d < reach[:, None]).any(-1).all()

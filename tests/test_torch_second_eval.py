"""The port's SECOND eval slice vs the JAX package, from the same weights.

A reduced SECOND (second_synth.yaml cut to a 128×128×40 grid — so the
conv_out depth D = 2 still gives D·128 = 256 BEV channels — narrow BEV
widths, batch 2, and an NMS matrix of 256 instead of 1024 boxes: the JAX
CPU overlap costs ~15 s a step at 1024).  The Flax variables are made from a numpy seed (shapes from
``jax.eval_shape`` of the JAX model's init) and moved into the port with
``utils/flax_weights.py``.  The conv_cls bias is set to 0 so that scores sit
near 0.5, above SCORE_THRESH 0.1: the NMS sees live boxes and suppresses
some.

Tolerances: f32 modules and final boxes/scores at atol/rtol 1e-4 (same f32
formulas, summation order differs); labels, validity and recall counts
exactly.  bf16 (USE_BF16): pre-NMS predictions within 0.05·(1 + |ref|) —
each of the 12 sparse layers and the BEV convs round activations to bf16
(8 mantissa bits, relative step 2⁻⁸ ≈ 0.004) in a different order in each
framework; box headings compared modulo π, because a direction-bin argmax
between two near-equal logits may flip and turn the box by exactly π.
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
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/synthetic_models/second_synth.yaml'
TOL = dict(atol=1e-4, rtol=1e-4)


def _reduced(load, bf16):
    c = load(CFG)
    d = c.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]     # 128×128×40 voxels
    d.NUM_SCENES, d.NUM_BG_POINTS, d.MAX_OBJECTS = 4, 1200, 4
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = c.MODEL
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256     # 1536 anchors/frame
    m.BACKBONE_3D.USE_BF16 = m.BACKBONE_2D.USE_BF16 = bf16
    m.BACKBONE_3D.VOXEL_CAPS = [384, 256, 128, 128]
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1], [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
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
    """The JAX and the port model of one config, same weights, same batch."""

    def __init__(self, bf16):
        jc, tc = _reduced(jload, bf16), _reduced(tload, bf16)
        self.jc, self.tc = jc, tc
        self.jset, self.jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2,
                                            workers=0, training=False)
        self.tset, self.tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2,
                                            workers=0, training=False)
        self.host = next(iter(self.tloader))
        self.jmodel = jdet(jc.MODEL, num_class=3, dataset=self.jset)
        self.geom = (self.jset.voxel_cfg,
                     tuple(int(g) for g in self.jset.grid_size),
                     tuple(float(x) for x in self.jset.point_cloud_range),
                     tuple(float(v) for v in self.jset.voxel_size))
        self.jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(
                r, jtrain.prepare_device_batch(h, *self.geom), training=False),
            jax.random.PRNGKey(0), self.jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)),
                                               shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.variables = var
        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'],
                                                       var['batch_stats']))
        self.tmodel.eval()
        self.jout = jax.jit(lambda v, h: self.jmodel.apply(
            v, jtrain.prepare_device_batch(h, *self.geom), training=False))(
                var, self.jbatch)
        with torch.no_grad():
            self.tout = self.tmodel(ttrain.prepare_device_batch(
                ttrain.host_to_device_batch(self.host, 'cpu'), *self.geom))
        self._steps = None

    def steps(self):
        """(JAX eval step, port eval step), built once: the JAX one
        compiles on its first call."""
        if self._steps is None:
            self._steps = (
                jeval.make_eval_step(self.jmodel, self.jset,
                                     self.jc.MODEL.POST_PROCESSING, 3),
                teval.make_eval_step(self.tmodel, self.tset,
                                     self.tc.MODEL.POST_PROCESSING, 3))
        return self._steps


@pytest.fixture(scope='module')
def f32():
    return Pair(bf16=False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j2t(x):
    return torch.from_numpy(np.array(x))


def test_weight_transfer_is_complete(f32):
    sd = flax_to_state_dict(f32.variables['params'], f32.variables['batch_stats'])
    assert set(sd) == set(f32.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(f32.variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith('num_batches_tracked'))
    assert n_flax == n_port
    assert 'backbone_3d.conv_input.0.weight' in sd
    assert 'backbone_2d.blocks.0.1.weight' in sd


def test_voxelized_batch_equal(f32):
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid',
              'point_slot', 'voxel_features'):
        np.testing.assert_array_equal(_np(f32.tout[k]), _np(f32.jout[k]), err_msg=k)


def test_backbone_3d_matches(f32):
    """VoxelBackBone8x from the JAX voxel features: dense output and every
    stage's sparse features."""
    batch = {k: _j2t(f32.jout[k]) for k in
             ('voxel_features', 'voxel_coords', 'voxel_valid')}
    with torch.no_grad():
        out = f32.tmodel.backbone_3d(batch)
    np.testing.assert_allclose(_np(out['encoded_spconv_features']),
                               _np(f32.jout['encoded_spconv_features']), **TOL)
    for name, st in f32.jout['multi_scale_3d_features'].items():
        got = out['multi_scale_3d_features'][name]
        np.testing.assert_array_equal(_np(got['coords']), _np(st['coords']))
        np.testing.assert_allclose(_np(got['features']), _np(st['features']),
                                   **TOL, err_msg=name)


def test_bev_backbone_matches(f32):
    batch = {'spatial_features': _j2t(f32.jout['spatial_features'])}
    with torch.no_grad():
        out = f32.tmodel.backbone_2d(batch)
    np.testing.assert_allclose(_np(out['spatial_features_2d']),
                               _np(f32.jout['spatial_features_2d']), **TOL)
    np.testing.assert_allclose(_np(f32.tout['spatial_features']),
                               _np(f32.jout['spatial_features']), **TOL)


def test_anchor_head_matches(f32):
    batch = {'spatial_features_2d': _j2t(f32.jout['spatial_features_2d'])}
    with torch.no_grad():
        out = f32.tmodel.dense_head(batch)
    for k in ('cls_preds', 'box_preds', 'dir_cls_preds', 'batch_cls_preds',
              'batch_box_preds'):
        np.testing.assert_allclose(_np(out[k]), _np(f32.jout[k]), **TOL, err_msg=k)


def test_eval_step_matches_f32(f32):
    """The whole slice: port make_eval_step vs JAX make_eval_step."""
    jstep, tstep = f32.steps()
    jp, jr = jstep(f32.variables, f32.jbatch)
    tp, tr = tstep(ttrain.host_to_device_batch(f32.host, 'cpu'))
    assert set(tp) == set(jp)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits',
              'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    for k in jr:
        np.testing.assert_array_equal(_np(tr[k]), _np(jr[k]), err_msg=k)
    live = (_np(torch.sigmoid(f32.tout['batch_cls_preds']).max(-1).values)
            >= float(f32.tc.MODEL.POST_PROCESSING.SCORE_THRESH)).sum(-1)
    kept = _np(tp['pred_valid']).sum(-1)
    assert np.all(kept > 0) and np.all(kept < live), (kept, live)


def test_eval_one_epoch_matches(f32):
    """AP and recall over the split: port eval_one_epoch vs the JAX eval
    step's predictions on every batch.  The AP of the JAX predictions is
    taken with the port's copy of simple_eval (held to the JAX one in
    test_torch_host.py) — the JAX evaluator compiles one XLA IoU program per
    box-count pair, which costs minutes here."""
    jstep, tstep = f32.steps()
    names = f32.jc.CLASS_NAMES
    jannos, jrec = [], {}
    for batch in f32.jloader:
        preds, rec = jstep(f32.variables, jtrain.host_to_device_batch(batch))
        jannos += f32.jset.generate_prediction_dicts(
            batch, jax.tree.map(np.asarray, preds), names)
        for k, v in rec.items():
            jrec[k] = jrec.get(k, 0) + int(np.asarray(v).sum())
    _, jap = f32.tset.evaluation(jannos, names)
    _, tap, trec = teval.eval_one_epoch(tstep, f32.tset, f32.tloader, names,
                                        device='cpu')
    assert trec == jrec
    assert set(tap) == set(jap) | {'sec_per_example'}
    for k in jap:
        assert abs(tap[k] - jap[k]) < 1e-6, k


def test_bf16_pre_nms_matches(f32):
    pair = Pair(bf16=True)
    a = _np(pair.tout['batch_cls_preds'])
    b = _np(pair.jout['batch_cls_preds']).astype(np.float32)
    assert np.max(np.abs(a - b) / (1 + np.abs(b))) <= 0.05
    # bf16 really ran: the same weights in f32 give other logits
    assert not np.array_equal(a, _np(f32.tout['batch_cls_preds']))
    a = _np(pair.tout['batch_box_preds'])
    b = _np(pair.jout['batch_box_preds']).astype(np.float32)
    d = np.abs(a - b)
    dh = np.remainder(a[..., 6] - b[..., 6], np.pi)
    d[..., 6] = np.minimum(dh, np.pi - dh)
    assert np.max(d / (1 + np.abs(b))) <= 0.05

"""The port's OpenPCDet checkpoint import (``utils/openpcdet_ckpt.py``)
against the JAX package's (``crb_active_3ddet_tpu/utils/torch_ckpt.py``).

Fabricated OpenPCDet state dicts (OpenPCDet's names and layouts, seeded
values; the pattern of ``tests/test_torch_import.py``'s
``_fabricate_second_state_dict``) for the reduced SECOND
(``test_torch_second_eval.py``), PointPillars (``test_torch_pointpillar.py``),
PV-RCNN with a LossNet (``test_torch_pvrcnn_active.py``), VoxelRCNN
(``test_torch_voxel_rcnn.py``'s reduced KITTI model) and PartA2
(``test_torch_parta2.py``'s reduced PartA2.yaml: UNetV2's decoder, the part
head's towers and PartA2FCHead's conv branches, whose sparse kernels over
the RoI grid become the port's dense (3, 3, 3, Cin, Cout) ones) and
PointRCNN (``test_torch_pointrcnn.py``'s reduced pointrcnn.yaml:
PointNet2MSG's SA and FP levels, PointHeadBox's towers, PointRCNNHead's
xyz-up, merge-down and SA levels and towers), with the
sparse conv kernels in spconv 1.x's (kz, ky, kx, Cin, Cout) and 2.x's native
(Cout, kz, ky, kx, Cin) layouts.  Each ``.pth`` goes through the JAX importer
into Flax trees of zeros shaped by ``jax.eval_shape`` of the JAX model's
init (traced, not compiled), then ``flax_to_state_dict``, and through the
port's importer into the port model: equal key for key and bit for bit, but
for ``roi_head.shared_fc_layer.0.weight`` of PV-RCNN and PartA2, which the
port permutes from OpenPCDet's channel-major input (C·G³) to its
grid-major one (G³·C) and the JAX importer does not, and for the first
weight of each of PointNet2MSG's FP levels, whose [interpolated | skip]
input blocks the port swaps to its [skip | interpolated] and the JAX
importer does not.  That the permutations are right is held to
OpenPCDet's own product: the imported layer on grid-major pooled features
equals the source weight on the same features flattened channel-major.
VoxelRCNN's first shared FC maps across unpermuted, bit for bit with the
JAX import, since OpenPCDet's VoxelRCNN head flattens its pooled grid
grid-major too: held to OpenPCDet's product on the port's pooled grid.
"""

import copy
import functools
import pickle

import jax
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.utils import torch_ckpt as jckpt

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.utils import openpcdet_ckpt as ockpt
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import test_torch_pointpillar
import test_torch_pvrcnn_active
import test_torch_second_eval

META = {'epoch': 80, 'it': 37120, 'version': 'pcdet+0.5.2+0000000'}


def _voxel_rcnn_tests():
    """``tests/test_torch_voxel_rcnn.py``, imported at first use: through
    ``test_torch_cli`` it imports this module."""
    import test_torch_voxel_rcnn
    return test_torch_voxel_rcnn


def _parta2_tests():
    """``tests/test_torch_parta2.py``, imported at first use."""
    import test_torch_parta2
    return test_torch_parta2


def _pointrcnn_tests():
    """``tests/test_torch_pointrcnn.py``, imported at first use."""
    import test_torch_pointrcnn
    return test_torch_pointrcnn


def _pvrcnn(load):
    c = test_torch_pvrcnn_active._cfg(load, 'llal')
    c.DATA_CONFIG.NUM_SCENES = 2
    return c


CONFIGS = {
    'second': lambda load: test_torch_second_eval._reduced(load, False),
    'pointpillar': test_torch_pointpillar._reduced,
    'pvrcnn': _pvrcnn,
    'voxelrcnn': lambda load: _voxel_rcnn_tests()._reduced_kitti(load),
    'parta2': lambda load: _parta2_tests()._reduced(load),
    'pointrcnn': lambda load: _pointrcnn_tests().reduced(load),
}
PERMUTED = ('pvrcnn', 'parta2')         # the first shared FC: channel-major in OpenPCDet
# what the JAX importer leaves at its init (ROADMAP Queue 3): OpenPCDet's
# nested ``conv5.0.0`` and ``conv_part.{i}.0`` / ``conv_rpn.{i}.0`` modules
JAX_MISSES = {'parta2': {'port': ('backbone_3d.conv5.', 'roi_head.conv_part.',
                                  'roi_head.conv_rpn.'),
                         'flax': ('backbone_3d.SparseConvLayer_16.', 'roi_head.conv_part_',
                                  'roi_head.conv_rpn_')}}


@functools.lru_cache(maxsize=None)
def _models(family):
    """(JAX params and batch_stats of zeros, the port model, the JAX
    MODEL config) of one family."""
    jc, tc = CONFIGS[family](jload), CONFIGS[family](tload)
    jset, jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 1, workers=0, training=False)
    tset, _, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 1, workers=0, training=False)
    jmodel = jdet(jc.MODEL, num_class=len(jc.CLASS_NAMES), dataset=jset)
    geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
            tuple(float(x) for x in jset.point_cloud_range),
            tuple(float(v) for v in jset.voxel_size))
    host = jtrain.host_to_device_batch(next(iter(jloader)))
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), host)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tmodel = tdet(tc.MODEL, num_class=len(tc.CLASS_NAMES), dataset=tset, device='cpu')
    return zeros['params'], zeros['batch_stats'], tmodel, jc.MODEL


def _fabricate(model, layout, seed):
    """A seeded OpenPCDet ``model_state`` for ``model``'s architecture:
    OpenPCDet's names (the port's), its sparse conv kernels in ``layout``
    (in the 2.x case also the point head's first Linear weight with a k=1
    Conv1d's trailing axis), its BN variances positive, no LossNet, and its
    ``global_step``."""
    rng = np.random.RandomState(seed)
    sd = {'global_step': torch.tensor([1234])}
    sparse = {f'{n}.weight' for n, m in model.named_modules()
              if type(m).__name__ in ('SparseConv3d', 'DenseConv3d')}
    for key, t in model.state_dict().items():
        if '.loss_net.' in key:
            continue
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.tensor(int(rng.randint(1, 10 ** 6)))
            continue
        shape = tuple(t.shape)
        if key in sparse:
            *k, ci, co = shape
            taps = tuple(k) if len(k) == 3 else (3, 3, 3) if k[0] == 27 else (k[0], 1, 1)
            shape = (*taps, ci, co) if layout == '1.x' else (co, *taps, ci)
        value = rng.randn(*shape) * 0.05
        if key.endswith('running_var'):
            value = 0.5 + rng.rand(*shape)
        sd[key] = torch.from_numpy(value.astype(np.float32))
    if layout == '2.x' and 'point_head.cls_layers.0.weight' in sd:
        # a Linear weight as a k=1 Conv1d stores it
        sd['point_head.cls_layers.0.weight'] = sd['point_head.cls_layers.0.weight'][..., None]
    return sd


CASES = [('second', '1.x'), ('second', '2.x'), ('pointpillar', '1.x'),
         ('pvrcnn', '1.x'), ('pvrcnn', '2.x'), ('voxelrcnn', '1.x'), ('voxelrcnn', '2.x'),
         ('parta2', '1.x'), ('parta2', '2.x'), ('pointrcnn', '1.x'), ('pointrcnn', '2.x')]


@pytest.mark.parametrize('family, layout', CASES)
def test_import_equals_the_jax_import(tmp_path, family, layout):
    params, stats, model, model_cfg = _models(family)
    sd = _fabricate(model, layout, seed=len(family) + len(layout))
    path = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd, 'optimizer_state': {'state': {}}, **META}, path)

    jp, js, jreport, jmeta = jckpt.import_openpcdet_checkpoint(str(path), params, stats)
    want = flax_to_state_dict(jp, js, model_cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report, meta = ockpt.import_openpcdet_checkpoint(str(path), model)
    got = model.state_dict()

    assert meta == jmeta == META
    assert not report['mismatched'] and not jreport['mismatched']
    loss_net = [k for k in got if '.loss_net.' in k]
    assert bool(loss_net) == (family == 'pvrcnn')
    assert report['unmatched_target'] == loss_net
    misses = JAX_MISSES.get(family, {'port': (), 'flax': ()})
    skips = ockpt.fp_skips(model)
    assert len(skips) == (4 if family == 'pointrcnn' else 0)
    jmissed = [x.replace('/', '.') for x in jreport['unmatched_target']]
    assert all(p.startswith(('roi_head.loss_net.', *misses['flax'])) for p in jmissed)
    assert len([p for p in jmissed if not p.startswith(misses['flax'])]) == (
        len(jckpt._flatten(params['roi_head']['loss_net']))
        + len(jckpt._flatten(stats['roi_head']['loss_net'])) if family == 'pvrcnn' else 0)
    assert bool(misses['flax']) == any(p.startswith(misses['flax']) for p in jmissed)
    assert report['unused_source'] == ['global_step']
    assert set(got) == set(want)
    for key in loss_net:
        assert torch.equal(got[key], before[key]), key
    for key, value in want.items():
        if '.loss_net.' in key:
            continue
        if key.endswith('num_batches_tracked') or key.startswith(misses['port']):
            src = sd[key]
            if src.ndim == 5:                               # oriented as the port keeps it
                src = ockpt.spconv_kernel(src, *got[key].shape[-2:]).reshape(got[key].shape)
            assert torch.equal(got[key], src), key          # JAX keeps none
        elif key == ockpt.SHARED_FC and family in PERMUTED:
            permuted = ockpt.grid_major(value, model.roi_head.grid_size ** 3)
            assert torch.equal(got[key], permuted)
            assert not torch.equal(got[key], value)
        elif key in skips:                  # the JAX importer keeps OpenPCDet's blocks
            assert torch.equal(got[key], ockpt.skip_first(value, skips[key])), key
            assert not torch.equal(got[key], value)
        else:
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    assert report['mapped'] == [k for k in got if '.loss_net.' not in k]


def test_shared_fc_equals_openpcdets_product(tmp_path):
    """OpenPCDet's head views the pooled grid (B·R, G³, C) as (B·R, C·G³, 1)
    after a permute: the imported grid-major layer on (B·R, G³·C, 1) gives
    the same product (both in float64, so that the two summation orders
    agree far inside the tolerance)."""
    params, stats, model, _ = _models('pvrcnn')
    sd = _fabricate(model, '2.x', seed=5)
    path = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd}, path)
    ockpt.import_openpcdet_checkpoint(str(path), model)
    g3 = model.roi_head.grid_size ** 3
    w = sd[ockpt.SHARED_FC]
    c = w.shape[1] // g3
    pooled = torch.from_numpy(np.random.RandomState(0).randn(6, g3, c))
    layer = model.roi_head.shared_fc_layer[0]
    with torch.no_grad():
        got = copy.deepcopy(layer).double()(pooled.reshape(6, g3 * c, 1))
        want = torch.nn.functional.conv1d(pooled.permute(0, 2, 1).reshape(6, c * g3, 1),
                                          w.double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    assert torch.equal(ockpt.channel_major(layer.weight.detach(), g3), w)


def test_parta2_shared_fc_equals_openpcdets_product(tmp_path):
    """OpenPCDet's PartA2 head views its merged sparse grid's ``.dense()``,
    (B·R, C, X, Y, Z), as (B·R, C·G³) before ``shared_fc_layer.0``: the
    imported layer on the port's grid-major (B·R, G³·C) merged features of
    a batch with RoIs at the gt boxes gives the same product (f64)."""
    _, _, model, _ = _models('parta2')
    model = copy.deepcopy(model).eval()
    sd = _fabricate(model, '2.x', seed=11)
    sd[ockpt.SHARED_FC] = sd[ockpt.SHARED_FC][..., None]    # OpenPCDet's Conv1d(k=1)
    path = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd}, path)
    report, _ = ockpt.import_openpcdet_checkpoint(str(path), model)
    assert not report['mismatched'] and report['unmatched_target'] == []
    assert ockpt.shared_fc_layout(model) == (4 ** 3, False)
    pa = _parta2_tests()
    pair = pa.Pair(False, training=False)
    pair.tmodel.load_state_dict(model.state_dict())
    pair.tmodel.eval()
    rois = pa.make_proposals(np.asarray(pair.host['gt_boxes']), np.random.RandomState(1))
    head = pair.tmodel.roi_head
    with torch.no_grad():
        out = pair.tmodel({**pair.tbatch(), 'rois': torch.from_numpy(rois['rois'])})
        merged = head.convs(*head.roiaware_pool(out)).double()        # (B·R, G³·C)
    g3 = head.grid_size ** 3
    dense = merged.reshape(merged.shape[0], g3, -1).permute(0, 2, 1)   # OpenPCDet's (B·R, C, G³)
    assert (dense != 0).any()
    with torch.no_grad():
        mine = copy.deepcopy(head.shared_fc_layer[0]).double()(merged)
    theirs = torch.nn.functional.conv1d(dense.reshape(dense.shape[0], -1, 1),
                                        sd[ockpt.SHARED_FC].double())[..., 0]
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6, atol=1e-12)
    kernel = sd['roi_head.conv_rpn.0.0.weight']               # spconv 2.x (Cout, 3, 3, 3, Cin)
    assert torch.equal(head.conv_rpn[0][0].weight.detach(), kernel.permute(1, 2, 3, 4, 0))


def test_voxelrcnn_shared_fc_equals_openpcdets_product(tmp_path):
    """OpenPCDet's VoxelRCNN head views its pooled grid (B·R, G³, C) as
    (B·R, G³·C) and applies ``shared_fc_layer.0`` (a Linear): on the port's
    pooled grid of a batch with RoIs at the gt boxes, the imported layer
    computes the source weight's product unpermuted (f64)."""
    _, _, model, _ = _models('voxelrcnn')
    model = copy.deepcopy(model).eval()
    sd = _fabricate(model, '2.x', seed=7)
    path = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd}, path)
    report, _ = ockpt.import_openpcdet_checkpoint(str(path), model)
    assert not report['mismatched'] and report['unmatched_target'] == []
    assert ockpt.shared_fc_layout(model) is None
    head = model.roi_head
    assert torch.equal(head.shared_fc_layer[0].weight.detach(), sd[ockpt.SHARED_FC])
    assert torch.equal(head.roi_grid_pool_layers[2].mlps_pos[0][0].weight.detach(),
                       sd['roi_head.roi_grid_pool_layers.2.mlps_pos.0.0.weight'])
    vr = _voxel_rcnn_tests()
    pair = vr.Pair('kitti', training=False)
    pair.tmodel.load_state_dict(model.state_dict())
    pair.tmodel.eval()
    rois = vr.make_proposals(np.asarray(pair.host['gt_boxes']),
                                                np.random.RandomState(1))['rois']
    with torch.no_grad():
        out = pair.tmodel({**pair.tbatch(), 'rois': torch.from_numpy(rois)})
        pooled = pair.tmodel.roi_head.roi_grid_pool(out).double()           # (B·R, G³·C)
    g3 = head.grid_size ** 3
    grid = pooled.reshape(pooled.shape[0], g3, -1)              # OpenPCDet's (B·R, G³, C)
    assert (grid != 0).any()
    with torch.no_grad():
        mine = copy.deepcopy(head.shared_fc_layer[0]).double()(pooled)
    theirs = torch.nn.functional.linear(grid.view(grid.shape[0], -1), sd[ockpt.SHARED_FC].double())
    np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-6, atol=0)


def test_pointnet2_fp_equals_openpcdets_product(tmp_path):
    """OpenPCDet's FP level concatenates [interpolated | skip]; the port's
    imported first FP weight on its [skip | interpolated] features gives
    the source weight's product on OpenPCDet's order (f64), at every level."""
    _, _, model, _ = _models('pointrcnn')
    model = copy.deepcopy(model)
    sd = _fabricate(model, '1.x', seed=11)
    path = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd}, path)
    ockpt.import_openpcdet_checkpoint(str(path), model)
    rng = np.random.RandomState(12)
    for k, skip in enumerate(model.backbone_3d.skip_channels):
        w = model.backbone_3d.FP_modules[k].mlp[0].weight.detach().double()[..., 0, 0]
        src = sd[f'backbone_3d.FP_modules.{k}.mlp.0.weight'].double()[..., 0, 0]
        skip_f = torch.from_numpy(rng.randn(50, skip))
        interp = torch.from_numpy(rng.randn(50, w.shape[1] - skip))
        np.testing.assert_allclose((torch.cat([skip_f, interp], 1) @ w.T).numpy(),
                                   (torch.cat([interp, skip_f], 1) @ src.T).numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_bare_state_dict_and_weights_only(tmp_path):
    _, _, model, _ = _models('second')
    sd = _fabricate(model, '2.x', seed=9)
    path = tmp_path / 'bare.pth'
    torch.save(sd, path)
    loaded, meta = ockpt.load_openpcdet_file(str(path))
    assert meta == {} and set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
    # a pickled object is refused: the file is read with weights_only=True
    torch.save({'model_state': sd, 'cfg': functools.partial(print, 'x')}, path)
    with pytest.raises(pickle.UnpicklingError):
        ockpt.load_openpcdet_file(str(path))


def test_unported_families_and_bad_kernels_raise():
    for cfg in ({'NAME': 'CaDDN'}, {'NAME': 'PointRCNN'},
                {'NAME': 'PointRCNN', 'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'}}):
        stub = type('Stub', (), {'model_cfg': cfg})()
        with pytest.raises(NotImplementedError, match='item 14'):
            ockpt.map_openpcdet_state({}, stub)
    stub = type('Stub', (), {'model_cfg': {'NAME': 'PVRCNNPlusPlus'}})()
    with pytest.raises(NotImplementedError, match='encode 9'):
        ockpt.map_openpcdet_state({}, stub)
    stub = type('Stub', (), {'model_cfg': {'NAME': 'SECONDNet', 'BACKBONE_3D': {
        'NAME': 'VoxelResBackBone8x'}}})()
    with pytest.raises(NotImplementedError, match='128 channels in conv4'):
        ockpt.map_openpcdet_state({}, stub)
    with pytest.raises(ValueError, match='cannot orient'):
        ockpt.spconv_kernel(torch.zeros(3, 3, 3, 5, 6), 4, 6)
    _, _, model, _ = _models('second')
    sd = _fabricate(model, '1.x', seed=3)
    sd['dense_head.conv_cls.weight'] = sd['dense_head.conv_cls.weight'][:1]
    _, report = ockpt.map_openpcdet_state(sd, model)
    assert [m[0] for m in report['mismatched']] == ['dense_head.conv_cls.weight']
    assert report['unmatched_target'] == ['dense_head.conv_cls.weight']

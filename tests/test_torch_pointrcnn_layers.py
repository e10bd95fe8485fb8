"""PointRCNN's layers in the port vs the JAX package, from the same numpy
inputs and the same weights: ``ops/pointnet2.three_nn`` /
``three_interpolate``, ``ops/roi_pooling.roipoint_pool3d``,
``models/backbones_3d/pointnet2_backbone.PointNet2MSG`` and
``models/point_heads/point_head_box.PointHeadBox`` with
``get_point_box_loss``.

Tolerances: three-NN indices and the pooled points exactly (the same
arithmetic), distances and interpolations 1e-6 (the JAX squared distance
sums its three terms in XLA's order), their gradients against ``jax.vjp``
1e-6; PointNet2MSG's features in f32 1e-5 in eval and 1e-4 in training
(normalised by the batch statistics of a few hundred rows, which amplify
the summation orders' differences), its BatchNorm statistics 1e-5; its
gradients in float64 on both sides (``jax.enable_x64``)
within 1e-6 of their norm: in f32 a grouped max routes the gradient to the
argmax of near-tied slots, which the two packages' roundings pick apart
(see ``tests/test_torch_pointrcnn.py``); PointHeadBox's outputs and loss
1e-5, its labels exactly, its gradients 1e-5 of their norm in f32 (no
max-pool).  Torch ops run on one thread.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import CfgNode
from crb_active_3ddet_tpu.models.backbones_3d.pointnet2_backbone import \
    PointNet2MSG as JPointNet2MSG
from crb_active_3ddet_tpu.models.point_heads import point_head_box as jphb
from crb_active_3ddet_tpu.ops import pointnet2 as jpn2
from crb_active_3ddet_tpu.ops import roi_pooling as jroi

from crb_active_3ddet_torch.models.backbones_3d.pointnet2_backbone import PointNet2MSG
from crb_active_3ddet_torch.models.point_heads import point_head_box as tphb
from crb_active_3ddet_torch.ops import pointnet2 as tpn2
from crb_active_3ddet_torch.ops import roi_pooling as troi
from crb_active_3ddet_torch.utils.flax_weights import point_head_towers, pointnet2_from_flax

from test_torch_second_eval import _fill

BACKBONE = {
    'NAME': 'PointNet2MSG',
    'SA_CONFIG': {'NPOINTS': [128, 32, 8], 'RADIUS': [[0.4, 0.8], [0.8, 1.6], [1.6, 3.2]],
                  'NSAMPLE': [[8, 16], [8, 16], [8, 8]],
                  'MLPS': [[[8, 8], [8, 16]], [[16, 16], [16, 16]], [[32, 32], [32, 32]]]},
    'FP_MLPS': [[16, 16], [32, 32], [32, 32]]}
POINT_HEAD = {
    'NAME': 'PointHeadBox', 'CLS_FC': [16], 'REG_FC': [16], 'CLASS_AGNOSTIC': False,
    'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2], 'BOX_CODER': 'PointResidualCoder',
                      'BOX_CODER_CONFIG': {'use_mean_size': True, 'mean_size': [
                          [3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]}},
    'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0, 'point_box_weight': 1.0,
                                     'code_weights': [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 2.0]}}}


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


# ---- three-NN ----------------------------------------------------------------------

def _three_nn_case(case):
    """(unknown (2, 60, 3), known (2, 24, 3), known_valid (2, 24))."""
    rng = np.random.RandomState(0)
    unknown = rng.randn(2, 60, 3).astype(np.float32)
    known = rng.randn(2, 24, 3).astype(np.float32)
    valid = np.ones((2, 24), bool)
    if case == 'duplicates':            # equal distances: the lower index first
        unknown[:, 11:20] = np.round(unknown[:, 11:20])       # on a lattice with
        known[:, :12] = np.round(known[:, :12] * 2) / 2         # many equal distances
        known[:, 9] = known[:, 4]
        known[:, 17] = known[:, 4]
        unknown[:, :10] = known[:, 4:5] + rng.randn(2, 10, 3).astype(np.float32) * 1e-3
        unknown[:, 10] = known[:, 4]
    elif case == 'few_valid':           # one frame with 2 valid sources, one with 1
        valid[0, 2:] = False
        valid[1, :] = False
        valid[1, 7] = True
    return unknown, known, valid


@pytest.mark.parametrize('case', ['random', 'duplicates', 'few_valid', 'chunked'])
def test_three_nn_and_interpolate_match_jax(case, monkeypatch):
    if case == 'chunked':               # query chunks of 7 rows: 60 = 8·7 + 4
        monkeypatch.setattr(tpn2, '_PAIR_CHUNK', 7 * 2 * 24)
    unknown, known, valid = _three_nn_case(case)
    uvalid = np.ones(unknown.shape[:2], bool)
    jd, ji = jax.vmap(jpn2.three_nn)(unknown, uvalid, known, valid)
    td, ti = tpn2.three_nn(_t(unknown), _t(uvalid), _t(known), _t(valid))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-6, atol=1e-6)
    if case == 'duplicates':
        np.testing.assert_array_equal(_np(ti)[:, 10], [[4, 9, 17]] * 2)
    if case == 'few_valid':             # the invalid sources fill, at _BIG, lowest first
        np.testing.assert_array_equal(_np(ti)[1, :, 0], 7)
        np.testing.assert_array_equal(np.sort(_np(ti)[0, :, 2]), 2)
        assert (_np(td)[1, :, 1:] == np.float32(1e5)).all()

    rng = np.random.RandomState(1)
    feats = rng.randn(2, 24, 5).astype(np.float32)
    cot = rng.randn(2, 60, 5).astype(np.float32)
    jout, vjp = jax.vjp(jax.vmap(jpn2.three_interpolate), feats, ji, jd)
    jgf, _, jgd = vjp(cot)
    f, d = _t(feats).requires_grad_(), td.clone().requires_grad_()
    out = tpn2.three_interpolate(f, ti, d)
    out.backward(_t(cot))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(f.grad), np.asarray(jgf), rtol=1e-6, atol=1e-6)
    # d out / d dist: 1/d² weights scale as d⁻³, so hold it relative to its size
    g = np.asarray(jgd)
    assert np.abs(_np(d.grad) - g).max() <= 1e-6 * (1 + np.abs(g).max())


# ---- RoI point pooling ---------------------------------------------------------------

def _pool_case():
    """Two frames of 400 points (the last 40 of frame 1 invalid) and 9 RoIs:
    one holding no point, small ones holding fewer than S, large ones more
    than S, one with points exactly on its faces."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-6, 6, (2, 400, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 1, (2, 400))
    rois = np.zeros((2, 9, 7), np.float32)
    rois[:, :, :3] = rng.uniform(-4, 4, (2, 9, 3))
    rois[:, :, 2] = -0.5
    rois[:, :, 3:6] = [[4.0, 3.0, 2.5]] * 3 + [[1.2, 0.9, 1.0]] * 3 + [[8, 7, 3.5]] * 3
    rois[:, :, 6] = rng.uniform(-np.pi, np.pi, (2, 9))
    rois[:, 0, :3] = [30.0, 30.0, 0.0]                      # empty
    rois[:, 8] = [0.0, 0.0, 0.0, 2.0, 4.0, 2.0, 0.0]        # axis-aligned: face points
    pts[:, :6] = [[1.0, 0.5, 0.0], [-1.0, -2.0, 0.5], [0.3, 2.0, -1.0], [0.0, 0.0, 1.0],
                  [1.0, 2.0, 1.0], [1.0 + 1e-6, 0.0, 0.0]]
    valid = np.ones((2, 400), bool)
    valid[1, 360:] = False
    return pts, rng.randn(2, 400, 6).astype(np.float32), rois, valid


@pytest.mark.parametrize('chunk', [None, 400 * 2 * 2])    # whole, or 2 RoIs a chunk
@pytest.mark.parametrize('s', [16, 128])
def test_roipoint_pool3d_matches_jax(s, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(troi, 'PAIRS_PER_CHUNK', chunk)
    pts, feats, rois, valid = _pool_case()
    extra = (0.1, 0.0, 0.2)
    rv = np.ones((2, 9), bool)
    rv[1, 3] = False
    fn = jax.vmap(partial(jroi.roipoint_pool3d, num_sampled_points=s, extra_width=extra))
    jpooled, vjp, jempty = jax.vjp(lambda f: fn(pts, f, rois, valid, rv), feats, has_aux=True)
    f = _t(feats).requires_grad_()
    pooled, empty = troi.roipoint_pool3d(_t(pts), f, _t(rois), _t(valid), _t(rv), s, extra)
    np.testing.assert_array_equal(_np(pooled), np.asarray(jpooled))
    np.testing.assert_array_equal(_np(empty), np.asarray(jempty))
    # members: none, fewer than S (wrapped round) and more than S
    grown = rois.copy()
    grown[..., 3:6] += extra
    counts = troi._inside(_t(pts), _t(grown), _t(valid), _t(rv))[1].sum(1).numpy()
    assert (counts[:, 0] == 0).all() and (counts[1, 3] == 0)
    assert ((counts > 0) & (counts < s)).any() and (counts > s).any()
    assert _np(empty)[:, 0].all()
    cot = np.random.RandomState(4).randn(*jpooled.shape).astype(np.float32)
    pooled.backward(_t(cot))
    np.testing.assert_allclose(_np(f.grad), np.asarray(vjp(cot)[0]), rtol=1e-6,
                               atol=1e-5)


def test_roipoint_pool3d_face_points_are_inside():
    """The axis-aligned RoI (centre 0, size 2 × 4 × 2) holds the points on
    its faces (|local| = half the size, ``<=``) and not the one 1e-6
    outside."""
    pts, feats, rois, valid = _pool_case()
    pooled, empty = troi.roipoint_pool3d(_t(pts), _t(feats), _t(rois), _t(valid), None, 512)
    held = {tuple(np.round(p, 6)) for p in _np(pooled)[0, 8, :, :3]}
    for p in pts[0, :5]:
        assert tuple(np.round(p, 6)) in held
    assert tuple(np.round(pts[0, 5], 6)) not in held


# ---- PointNet2MSG --------------------------------------------------------------------

def _points(b=2, n=700, n_valid=(700, 520), seed=5):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(0, 12, (b, n, 1)), rng.uniform(-6, 6, (b, n, 1)),
                          rng.uniform(-3, 1, (b, n, 1)), rng.uniform(0, 1, (b, n, 1))],
                         -1).astype(np.float32)
    valid = np.arange(n)[None, :] < np.asarray(n_valid)[:, None]
    pts[~valid] = 0.0
    return pts, valid


@pytest.fixture(scope='module')
def backbone():
    pts, valid = _points()
    cfg = CfgNode(BACKBONE)
    jmod = JPointNet2MSG(model_cfg=cfg, input_channels=4)
    batch = {'points': pts, 'points_valid': valid}
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), batch))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
    tmod = PointNet2MSG(BACKBONE, 4)
    sd = {}
    pointnet2_from_flax(sd, var['params'], var['batch_stats'], BACKBONE, '')
    tmod.load_state_dict({k: _t(v) for k, v in sd.items()})
    return jmod, var, tmod, pts, valid


@pytest.mark.parametrize('training', [False, True])
def test_pointnet2msg_matches_jax(backbone, training):
    jmod, var, tmod, pts, valid = backbone
    batch = {'points': pts, 'points_valid': valid}

    def run(v):
        if training:
            out, mut = jmod.apply(v, batch, training=True, mutable=['batch_stats'])
            return out['point_features'], mut['batch_stats']
        return jmod.apply(v, batch, training=False)['point_features'], v['batch_stats']
    jf, jstats = jax.tree.map(np.asarray, jax.jit(run)(var))
    tmod.train(training)
    state = {k: v.clone() for k, v in tmod.state_dict().items()}
    with torch.no_grad():
        out = tmod({'points': _t(pts), 'points_valid': _t(valid)})
    got_stats = {k: _np(v).copy() for k, v in tmod.state_dict().items()}
    tmod.load_state_dict(state)
    assert out['point_features'].shape == (2, 700, 16)
    tol = 1e-4 if training else 1e-5       # batch statistics of a few hundred rows
    np.testing.assert_allclose(_np(out['point_features']), jf, rtol=tol, atol=tol)
    assert (_np(out['point_features'])[~valid] == 0).all()
    np.testing.assert_array_equal(_np(out['point_coords']), pts[..., :3])
    want = {}
    pointnet2_from_flax(want, var['params'], jstats, BACKBONE, '')
    want = {k: v for k, v in want.items() if k.endswith(('_mean', '_var'))}
    assert len(want) == sum(k.endswith(('_mean', '_var')) for k in got_stats)
    for k, v in want.items():
        np.testing.assert_allclose(got_stats[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_pointnet2msg_gradients_match_jax_in_f64(backbone):
    """One training forward and backward of a random cotangent at the point
    features, both packages in float64: every parameter's gradient within
    1e-6 of its norm."""
    jmod, var, tmod, pts, valid = backbone
    cot = np.random.RandomState(6).randn(2, 700, 16)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda x: np.asarray(x, np.float64), var)
        batch = {'points': pts.astype(np.float64), 'points_valid': valid}

        def loss(params):
            out, _ = jmod.apply({'params': params, 'batch_stats': v64['batch_stats']}, batch,
                                training=True, mutable=['batch_stats'])
            return (out['point_features'] * cot).sum()
        jg = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v64['params']))
    sd = {}
    pointnet2_from_flax(sd, jg, var['batch_stats'], BACKBONE, '')
    m = PointNet2MSG(BACKBONE, 4).double()
    m.load_state_dict({k: v.double() if v.is_floating_point() else v
                       for k, v in tmod.state_dict().items()})
    m.train()
    out = m({'points': _t(pts).double(), 'points_valid': _t(valid)})
    out['point_features'].backward(_t(cot))
    n = 0
    for name, p in m.named_parameters():
        ref = np.asarray(sd[name])
        assert np.linalg.norm(_np(p.grad) - ref) <= 1e-6 * np.linalg.norm(ref) + 1e-12, name
        n += 1
    assert n == len(list(m.parameters())) > 0


# ---- PointHeadBox --------------------------------------------------------------------

def test_point_head_box_matches_jax():
    """Training forward: logits, scores, raw box codes, the decoded boxes
    and masked logits (the proposal layer's input), the labels (exactly),
    the box targets, ``get_point_box_loss`` with ``reduce`` both ways, and
    the gradients of the loss (1e-5 of their norm)."""
    pts, valid = _points(n=600, n_valid=(600, 450))
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 600, 24).astype(np.float32)
    gt = np.zeros((2, 6, 8), np.float32)
    gt[:, :4] = [[4.0, 1.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1], [8.0, -3.0, -1.2, 0.8, 0.6, 1.73, 1.0, 2],
                 [2.0, -4.0, -1.0, 1.76, 0.6, 1.73, -0.5, 3], [10.0, 4.0, -1.0, 4.2, 1.7, 1.5, 2.0, 1]]
    coords = pts[..., :3]
    # points at the first gt's centre and inside the others, so that every
    # class has foreground
    for f in range(2):
        for g in range(4):
            coords[f, 10 * g:10 * g + 10] = gt[f, g, :3] + rng.uniform(-0.2, 0.2, (10, 3))
    cfg = CfgNode(POINT_HEAD)
    jhead = jphb.PointHeadBox(model_cfg=cfg, num_class=3)
    batch = {'point_features': feats, 'point_coords': coords, 'point_valid': valid,
             'gt_boxes': gt}
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), dict(batch),
                                               training=False))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(8)), shapes)
    lw = POINT_HEAD['LOSS_CONFIG']['LOSS_WEIGHTS']
    keys = ('point_cls_preds', 'point_cls_scores', 'point_box_preds_raw', 'batch_cls_preds',
            'batch_box_preds', 'point_cls_labels', 'point_box_labels')

    def run(params):
        out, _ = jhead.apply({'params': params, 'batch_stats': var['batch_stats']},
                             dict(batch), training=True, mutable=['batch_stats'])
        return jphb.get_point_box_loss(out, lw, 3), (
            {k: out[k] for k in keys}, jphb.get_point_box_loss(out, lw, 3, reduce=False))
    (jloss, (jout, jper)), jg = jax.tree.map(
        np.asarray, jax.jit(jax.value_and_grad(run, has_aux=True))(var['params']))
    thead = tphb.PointHeadBox(POINT_HEAD, 3, 24)
    sd = {}
    stacks = (('cls_layers', [16]), ('box_layers', [16]))
    point_head_towers(sd, {'point_head': var['params']}, {'point_head': var['batch_stats']},
                      stacks)
    thead.load_state_dict({k[len('point_head.'):]: _t(v) for k, v in sd.items()})
    thead.train()
    out = thead({k: _t(v) for k, v in batch.items()})
    loss = tphb.get_point_box_loss(out, lw)
    per = tphb.get_point_box_loss(out, lw, reduce=False)
    loss.backward()
    np.testing.assert_array_equal(_np(out['point_cls_labels']), jout['point_cls_labels'])
    labels = jout['point_cls_labels']
    assert all((labels == c).any() for c in (-1, 0, 1, 2, 3))
    for k in keys[:-2] + ('point_box_labels',):
        np.testing.assert_allclose(_np(out[k]), jout[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(_np(per), jper, rtol=1e-5)
    assert (_np(out['batch_cls_preds'])[~valid] == -1e9).all()
    gsd = {}
    point_head_towers(gsd, {'point_head': jg}, {'point_head': var['batch_stats']}, stacks)
    for name, p in thead.named_parameters():
        ref = np.asarray(gsd[f'point_head.{name}'])
        assert np.linalg.norm(_np(p.grad) - ref) <= 1e-5 * np.linalg.norm(ref) + 1e-9, name


def test_point_box_loss_class_agnostic_labels_past_the_logits():
    """A class-agnostic head's one logit against labels up to 3: the labels
    past the logits' count give an all-0 target, as ``jax.nn.one_hot``
    makes it (JAX and port equal)."""
    rng = np.random.RandomState(9)
    d = {'point_cls_preds': rng.randn(2, 50, 1).astype(np.float32),
         'point_cls_labels': rng.randint(-1, 4, (2, 50)).astype(np.int32),
         'point_box_preds_raw': rng.randn(2, 50, 8).astype(np.float32),
         'point_box_labels': rng.randn(2, 50, 8).astype(np.float32)}
    lw = {'point_cls_weight': 2.0, 'point_box_weight': 0.5}
    want = np.asarray(jphb.get_point_box_loss({k: jnp.asarray(v) for k, v in d.items()}, lw, 1,
                                              reduce=False))
    got = tphb.get_point_box_loss({k: _t(v) for k, v in d.items()}, lw, reduce=False)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5)

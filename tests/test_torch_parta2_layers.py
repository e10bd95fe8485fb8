"""The layers of the PartA2 slice alone, in the port vs the JAX package.

- ``roiaware_pool3d`` (``ops/roi_pooling.py``), max and avg, against the
  JAX function vmapped over 2 frames: rotated RoIs, points on the faces of
  axis-aligned RoIs (inside at ``<=``), invalid points and RoIs, empty
  cells and tied maxima (the features a ReLU's on a coarse lattice, so
  that many cells tie).  Max exactly, avg within 1e-6 (the summation
  order); their gradients against ``jax.vjp`` (ties share the gradient
  evenly), 1e-6; a chunk of one RoI gives the same grids.
- ``SparseInverseConvLayer`` and ``SparseBasicBlock``
  (``models/backbones_3d/spconv_backbone.py``) in training mode: outputs,
  BatchNorm statistics and gradients against ``jax.vjp``, in f32 (1e-5) and
  bf16 (the inverse conv at 2e-2 of the output's scale: both packages round
  the same bf16 operands; the basic block is f32 in both).
- UNetV2 and VoxelResBackBone8x alone on a small voxel set (300 voxels a
  frame over a 24×20×8 grid, caps that truncate x_conv3), training mode:
  every output (1e-4), BatchNorm statistic (1e-6) and parameter gradient
  (1e-5 of its norm) against ``jax.vjp`` of the JAX module.

Torch ops run on one thread.
"""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import CfgNode as JCfg
from crb_active_3ddet_tpu.models.backbones_3d import spconv_backbone as jsb
from crb_active_3ddet_tpu.ops import roi_pooling as jrp
from crb_active_3ddet_tpu.ops.sparse import rulebook as jrb

from crb_active_3ddet_torch.config import CfgNode as TCfg
from crb_active_3ddet_torch.models.backbones_3d import spconv_backbone as tsb
from crb_active_3ddet_torch.ops import roi_pooling as trp
from crb_active_3ddet_torch.ops.sparse import rulebook as trb
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_second_eval import _fill


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


# ---- roiaware_pool3d ------------------------------------------------------------

def _pool_case(seed, g):
    """Two frames: 400 points (the last 40 invalid) over 6 RoIs (4 rotated,
    2 axis-aligned with points placed on their faces; the last RoI of the
    second frame invalid), features a ReLU's."""
    rng = np.random.RandomState(seed)
    b, n, r, c = 2, 400, 6, 5
    rois = np.zeros((b, r, 7), np.float32)
    rois[..., :3] = rng.uniform(-2, 2, (b, r, 3))
    rois[..., 3:6] = rng.uniform(1.0, 3.0, (b, r, 3))
    rois[:, :4, 6] = rng.uniform(-np.pi, np.pi, (b, 4))
    rois[:, 4:] = np.round(rois[:, 4:] * 4) / 4           # exact halves: faces representable
    rois[:, 4:, 6] = 0.0
    pts = np.zeros((b, n, 3), np.float32)
    for f in range(b):
        owner = rng.randint(0, r, n)
        box = rois[f, owner]
        local = rng.uniform(-0.6, 0.6, (n, 3)) * box[:, 3:6]
        cosa, sina = np.cos(box[:, 6]), np.sin(box[:, 6])
        pts[f, :, 0] = local[:, 0] * cosa - local[:, 1] * sina + box[:, 0]
        pts[f, :, 1] = local[:, 0] * sina + local[:, 1] * cosa + box[:, 1]
        pts[f, :, 2] = local[:, 2] + box[:, 2]
        face = np.where(owner >= 4)[0][:60]
        axis = rng.randint(0, 3, len(face))
        sign = rng.choice([-1.0, 1.0], len(face))
        pts[f, face, axis] = box[face, axis] + sign * box[face, 3 + axis] / 2
    # a ReLU's features on a coarse lattice: many cells' maxima tie
    feats = np.maximum(np.round(rng.randn(b, n, c) * 2) / 2, 0).astype(np.float32)
    pvalid = np.ones((b, n), bool)
    pvalid[:, -40:] = False
    rvalid = np.ones((b, r), bool)
    rvalid[1, -1] = False
    return pts, feats, rois, pvalid, rvalid


@pytest.mark.parametrize('method', ['max', 'avg'])
def test_roiaware_pool3d_matches_jax(method):
    g = 4
    pts, feats, rois, pv, rv = _pool_case(0, g)

    def jpool(f):
        return jax.vmap(partial(jrp.roiaware_pool3d, out_size=g, pool_method=method))(
            jnp.asarray(pts), f, jnp.asarray(rois), jnp.asarray(pv), jnp.asarray(rv))
    want, vjp = jax.vjp(jpool, jnp.asarray(feats))
    tf = _t(feats).requires_grad_(True)
    got = trp.roiaware_pool3d(_t(pts), tf, _t(rois), _t(pv), _t(rv), g, method)
    assert got.shape == (2, 6, g, g, g, 5)
    if method == 'max':
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    w = np.asarray(want)
    assert (w == 0).all(-1).any() and (w != 0).any()
    assert (w[1, -1] == 0).all()                                # the invalid RoI
    cot = np.random.RandomState(1).randn(*w.shape).astype(np.float32)
    (tf_grad,) = torch.autograd.grad(got, tf, _t(cot), retain_graph=True)
    (jgrad,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(_np(tf_grad), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    assert (_np(tf_grad)[:, -40:] == 0).all()                   # invalid points
    if method == 'max':          # tied maxima share a cell's gradient
        (ones,) = torch.autograd.grad(got.sum(), tf)
        frac = _np(ones) - np.floor(_np(ones))
        assert (frac > 0.01).any()


def test_roiaware_pool3d_face_points_and_chunks(monkeypatch):
    """Points on the faces are inside (``<=``), and a chunk of one RoI at a
    time gives the same pooled grids."""
    pts, feats, rois, pv, rv = _pool_case(2, 3)
    args = (_t(pts), _t(feats), _t(rois), _t(pv), _t(rv), 3, 'max')
    whole = trp.roiaware_pool3d(*args)
    monkeypatch.setattr(trp, 'PAIRS_PER_CHUNK', 1)
    assert torch.equal(trp.roiaware_pool3d(*args), whole)
    local = trp._rotate_to_local(_t(pts), _t(rois))
    on_face = ((local.abs() == _t(rois)[:, None, :, 3:6] / 2).any(-1)
               & (local.abs() <= _t(rois)[:, None, :, 3:6] / 2).all(-1))
    assert on_face.sum() > 20


# ---- the new sparse layers --------------------------------------------------------

def _sparse_case(seed, v=300, grid=(9, 20, 24)):
    """Two frames of cell-sorted voxel coords (valid rows first) with
    random f32 features; the second frame 60 rows shorter."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    coords = np.full((2, v, 3), -1, np.int32)
    valid = np.zeros((2, v), bool)
    for f, m in enumerate((v - 20, v - 80)):
        cells = rng.choice(nz * ny * nx, m, replace=False)
        cells.sort()
        coords[f, :m] = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], -1)
        valid[f, :m] = True
    return coords, valid, grid, rng


class _JInv(fnn.Module):
    """The JAX inverse conv from the downsample it undoes."""
    cdt: str

    @fnn.compact
    def __call__(self, coarse, fine_coords, fine_valid, grid, rbk, training):
        return jsb.SparseInverseConvLayer(16, compute_dtype=self.cdt)(
            coarse, fine_coords, fine_valid, grid, rbk, training)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_inverse_conv_matches_jax(cdt):
    coords, valid, grid, rng = _sparse_case(0)
    vc = 160
    jo, jv, jr = jax.vmap(partial(jrb.downsample_rulebook, grid=grid, kernel_size=(3, 3, 3),
                                  stride=(2, 2, 2), padding=(1, 1, 1), max_out=vc))(
        jnp.asarray(coords), jnp.asarray(valid))
    feats = rng.randn(2, vc, 32).astype(np.float32) * _np(jv)[..., None]
    mod = _JInv(cdt)
    coarse = {'features': jnp.asarray(feats), 'coords': jo, 'valid': jv}
    var = mod.init(jax.random.PRNGKey(0), coarse, coords, valid, grid, jr, False)
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(1)), var)

    def jrun(params, f):
        out, mut = mod.apply({'params': params, 'batch_stats': var['batch_stats']},
                             {**coarse, 'features': f}, jnp.asarray(coords),
                             jnp.asarray(valid), grid, jr, True, mutable=['batch_stats'])
        return out['features'], mut['batch_stats']
    want_out, stats = jrun(var['params'], jnp.asarray(feats))
    _, vjp = jax.vjp(lambda p, f: jrun(p, f)[0], var['params'], jnp.asarray(feats))

    p = var['params']['SparseInverseConvLayer_0']
    layer = tsb.SparseInverseConvLayer(32, 16)
    layer.load_state_dict({'0.weight': _t(p['kernel']),
                           '1.weight': _t(p['MaskedBatchNorm_0']['scale']),
                           '1.bias': _t(p['MaskedBatchNorm_0']['bias']),
                           '1.running_mean': _t(var['batch_stats']['SparseInverseConvLayer_0']
                                                ['MaskedBatchNorm_0']['mean']),
                           '1.running_var': _t(var['batch_stats']['SparseInverseConvLayer_0']
                                               ['MaskedBatchNorm_0']['var']),
                           '1.num_batches_tracked': torch.zeros((), dtype=torch.int64)})
    layer.train()
    rbk = tsb.flat_rulebook(_t(jr), coords.shape[1])
    np.testing.assert_array_equal(_np(rbk), _np(tsb.flat_rulebook(trb.downsample_rulebook(
        _t(coords), _t(valid), grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), vc)[2], 300)))
    link = tsb.Link(_t(valid), rbk, trb.inverse_rulebook(rbk, 2 * 300), True)
    tf = _t(feats).requires_grad_(True)
    dt = torch.float32 if cdt == 'float32' else torch.bfloat16
    got = layer(tf, link, dt)
    scale = 1.0 if cdt == 'float32' else float(np.abs(want_out).max())
    tol = 1e-5 if cdt == 'float32' else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(want_out), atol=tol * scale, rtol=tol)
    st = stats['SparseInverseConvLayer_0']['MaskedBatchNorm_0']
    np.testing.assert_allclose(_np(layer[1].running_mean), np.asarray(st['mean']), atol=tol)
    np.testing.assert_allclose(_np(layer[1].running_var), np.asarray(st['var']), atol=tol)
    cot = np.random.RandomState(2).randn(*got.shape).astype(np.float32)
    gw, gf = torch.autograd.grad(got, (layer[0].weight, tf), _t(cot))
    jp, jf = vjp(jnp.asarray(cot))
    for a, b_ in ((gw, jp['SparseInverseConvLayer_0']['kernel']), (gf, jf)):
        b_ = np.asarray(b_, np.float32)
        assert np.linalg.norm(_np(a) - b_) <= tol * np.linalg.norm(b_) + 1e-7
    assert (_np(got)[~valid] == 0).all() and (_np(gf)[~_np(jv)] == 0).all()


class _JBlock(fnn.Module):
    @fnn.compact
    def __call__(self, st, rbk, training):
        return jsb.SparseBasicBlock(16, st['grid'])(st, training, rulebook=rbk)


def test_basic_block_matches_jax():
    coords, valid, grid, rng = _sparse_case(3)
    jr = jsb.rb.subm_rulebook_window(jnp.asarray(coords), jnp.asarray(valid), grid)
    feats = (np.maximum(rng.randn(2, 300, 16), 0) * valid[..., None]).astype(np.float32)
    st = {'features': jnp.asarray(feats), 'coords': jnp.asarray(coords),
          'valid': jnp.asarray(valid), 'grid': grid}
    mod = _JBlock()
    var = mod.init(jax.random.PRNGKey(0), st, jr, False)
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(4)), var)

    def jrun(params, f):
        out, mut = mod.apply({'params': params, 'batch_stats': var['batch_stats']},
                             {**st, 'features': f}, jr, True, mutable=['batch_stats'])
        return out['features'], mut['batch_stats']
    want, stats = jrun(var['params'], jnp.asarray(feats))
    _, vjp = jax.vjp(lambda p, f: jrun(p, f)[0], var['params'], jnp.asarray(feats))

    block = tsb.SparseBasicBlock(16)
    p, s = var['params']['SparseBasicBlock_0'], var['batch_stats']['SparseBasicBlock_0']
    sd = {}
    for j in (1, 2):
        q, sq = p[f'SparseConvLayer_{j - 1}'], s[f'SparseConvLayer_{j - 1}']
        sd[f'conv{j}.weight'] = _t(q['kernel'])
        sd[f'bn{j}.weight'] = _t(q['MaskedBatchNorm_0']['scale'])
        sd[f'bn{j}.bias'] = _t(q['MaskedBatchNorm_0']['bias'])
        sd[f'bn{j}.running_mean'] = _t(sq['MaskedBatchNorm_0']['mean'])
        sd[f'bn{j}.running_var'] = _t(sq['MaskedBatchNorm_0']['var'])
        sd[f'bn{j}.num_batches_tracked'] = torch.zeros((), dtype=torch.int64)
    block.load_state_dict(sd)
    block.train()
    rbk = tsb.flat_rulebook(trb.unpack_window_rulebook(
        trb.subm_rulebook_window(_t(coords), _t(valid), grid)), 300)
    aux = (trb.inverse_rulebook(rbk, 600), trb.transpose_rulebook(rbk))
    tf = _t(feats).requires_grad_(True)
    got = block(tf, rbk, _t(valid), torch.bfloat16, aux)      # f32 whatever it is told
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    for j in (1, 2):
        st_j = stats['SparseBasicBlock_0'][f'SparseConvLayer_{j - 1}']['MaskedBatchNorm_0']
        bn = getattr(block, f'bn{j}')
        np.testing.assert_allclose(_np(bn.running_mean), np.asarray(st_j['mean']), atol=1e-6)
        np.testing.assert_allclose(_np(bn.running_var), np.asarray(st_j['var']), atol=1e-6)
    cot = np.random.RandomState(5).randn(*got.shape).astype(np.float32)
    grads = torch.autograd.grad(got, (block.conv1.weight, block.conv2.weight, tf), _t(cot))
    jp, jf = vjp(jnp.asarray(cot))
    refs = (jp['SparseBasicBlock_0']['SparseConvLayer_0']['kernel'],
            jp['SparseBasicBlock_0']['SparseConvLayer_1']['kernel'], jf)
    for a, b_ in zip(grads, refs):
        b_ = np.asarray(b_)
        assert np.linalg.norm(_np(a) - b_) <= 1e-5 * np.linalg.norm(b_) + 1e-7


# ---- the backbones alone ------------------------------------------------------------

@pytest.mark.parametrize('name', ['UNetV2', 'VoxelResBackBone8x'])
def test_backbone_gradients_match_jax(name):
    """Training-mode forward and backward of the whole backbone on 300
    voxels a frame, random cotangents at every float output."""
    coords, valid, grid, rng = _sparse_case(6)
    feats = (rng.randn(2, 300, 4) * valid[..., None]).astype(np.float32)
    cfg = {'NAME': name, 'VOXEL_CAPS': [600, 40, 60, 200]}
    grid_size = (grid[2], grid[1], grid[0] - 1)
    vs, pcr = (0.1, 0.1, 0.2), (0.0, -1.0, -1.0, 2.4, 1.0, 0.6)
    jmod = jsb.build_backbone_3d(JCfg(cfg), 4, grid_size, vs, pcr)
    inp = {'voxel_features': jnp.asarray(feats), 'voxel_coords': jnp.asarray(coords),
           'voxel_valid': jnp.asarray(valid)}
    var = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), dict(inp), training=False))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(7)), var)
    keys = ['encoded_spconv_features'] + (['point_features'] if name == 'UNetV2' else [])

    def run(params):
        out, mut = jmod.apply({'params': params, 'batch_stats': var['batch_stats']},
                              dict(inp), training=True, mutable=['batch_stats'])
        ms = {k: out['multi_scale_3d_features'][k]['features']
              for k in out['multi_scale_3d_features']}
        return tuple(out[k] for k in keys) + (ms,), mut['batch_stats']
    want, stats = jax.jit(run)(var['params'])
    vjp = jax.jit(lambda p, c: jax.vjp(lambda q: run(q)[0], p)[1](c)[0])
    model_cfg = {'BACKBONE_3D': cfg}
    tmod = tsb.build_backbone_3d(TCfg(cfg), 4, grid_size, vs, pcr)
    sd = flax_to_state_dict({'backbone_3d': var['params']}, {'backbone_3d': var['batch_stats']},
                            model_cfg)
    tmod.load_state_dict({k[len('backbone_3d.'):]: v for k, v in sd.items()})
    tmod.train()
    out = tmod({k: _t(v) for k, v in inp.items()})
    got = [out[k] for k in keys] + [out['multi_scale_3d_features']]
    assert (_np(out['multi_scale_3d_features']['x_conv3']['valid']).sum(-1) == 40).all()
    for k, a, b in zip(keys, got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=k)
    for k, st in want[-1].items():
        np.testing.assert_allclose(_np(got[-1][k]['features']), np.asarray(st), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    rs = np.random.RandomState(8)
    cots = [rs.randn(*np.shape(w)).astype(np.float32) for w in want[:-1]]
    ms_cot = {k: rs.randn(*np.shape(v)).astype(np.float32) for k, v in want[-1].items()}
    tensors = got[:-1] + [got[-1][k]['features'] for k in ms_cot]
    torch.autograd.backward(tensors, [_t(c) for c in cots] + [_t(c) for c in ms_cot.values()])
    jg = vjp(var['params'], tuple(jnp.asarray(c) for c in cots)
             + ({k: jnp.asarray(v) for k, v in ms_cot.items()},))
    ref = flax_to_state_dict({'backbone_3d': jax.tree.map(np.asarray, jg)},
                             {'backbone_3d': var['batch_stats']}, model_cfg)
    ref_stats = flax_to_state_dict({'backbone_3d': var['params']},
                                   {'backbone_3d': jax.tree.map(np.asarray, stats)}, model_cfg)
    for n, prm in tmod.named_parameters():
        r = ref[f'backbone_3d.{n}'].numpy()
        assert np.linalg.norm(_np(prm.grad) - r) <= 1e-5 * np.linalg.norm(r) + 1e-7, n
    for n, buf in tmod.named_buffers():
        if n.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(_np(buf), ref_stats[f'backbone_3d.{n}'].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=n)

"""The backward of the sparse conv (the gather-GEMM's input and weight
gradients) against the JAX package.

  * ``inverse_rulebook`` over a layer's flat (B·V_out, K) rulebook equals
    the JAX ``inverse_rulebook`` (``ops/sparse/rulebook.py:707``) on the
    same flat rulebook, for subm and strided rulebooks with −1 entries,
    padding rows and ``VOXEL_CAPS`` truncation; for a subm rulebook it is
    the rulebook with its offsets mirrored (k → K−1−k).  Exact.
  * ``gather_gemm_dgrad_plain`` and ``gather_gemm_wgrad_plain`` against
    ``jax.vjp`` of the JAX layer's gather + dot
    (``models/backbones_3d/spconv_backbone.py:137-145``).  f32: 1e-5 of the
    output's scale (same products, other summation order).  bf16 operands
    (f32 cotangent): the JAX VJP keeps the cotangent f32 and rounds each
    tap's product to bf16 before it scatter-adds; the port's dgrad rounds
    the cotangent to bf16 (the tensor cores' operand) and sums a row's taps
    in f32, so 1e-2 of the scale (bf16's relative step is 2⁻⁸ ≈ 4e-3); the
    weight gradient, which both round once to bf16 at the end, within one
    bf16 step (2⁻⁷ relative).
  * ``torch.autograd.gradcheck`` in f64 of ``SparseConvGatherGemm`` on CPU
    tensors (its plain versions), at K = 27 (Cin 4 → 16) and K = 3 (64 → 128),
    and the Function skipping the input gradient when the features need
    none (``conv_input``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.ops.sparse import rulebook as jrb

from crb_active_3ddet_torch.models.backbones_3d.spconv_backbone import flat_rulebook
from crb_active_3ddet_torch.ops import cuda_kernels
from crb_active_3ddet_torch.ops.cuda_kernels import SparseConvGatherGemm
from crb_active_3ddet_torch.ops.sparse import rulebook as trb
from crb_active_3ddet_torch.ops.sparse.sparse_ops import (gather_gemm_dgrad_plain,
                                                          gather_gemm_wgrad_plain)

from test_torch_host import _cell_sorted_coords

GRID = (9, 16, 14)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rulebook(kind):
    """A layer's flat (B·V_out, K) rulebook and V_in = B·V: two frames of
    80 rows, 80 and 33 of them valid (the rest padding rows)."""
    coords, valid = _cell_sorted_coords(np.random.RandomState(11), GRID, 2, 80,
                                        [80, 33])
    if kind == 'subm':
        rbk = trb.unpack_window_rulebook(trb.subm_rulebook_window(
            _t(coords), _t(valid), GRID))
    else:
        ks, st, pd, max_out = {
            'down': ((3, 3, 3), (2, 2, 2), (1, 1, 1), 48),
            'down_cap': ((3, 3, 3), (2, 2, 2), (0, 1, 1), 20),   # truncates
            'conv_out': ((3, 1, 1), (2, 1, 1), (0, 0, 0), 64)}[kind]
        _, _, rbk = trb.downsample_rulebook(_t(coords), _t(valid), GRID, ks, st,
                                            pd, max_out)
    return flat_rulebook(rbk, coords.shape[1]), 2 * coords.shape[1]


RULEBOOKS = ['subm', 'down', 'down_cap', 'conv_out']


@pytest.mark.parametrize('kind', RULEBOOKS)
def test_inverse_rulebook_equals_jax(kind):
    rbk, v_in = _rulebook(kind)
    got = trb.inverse_rulebook(rbk, v_in)
    ref = np.asarray(jrb.inverse_rulebook(jnp.asarray(rbk.numpy()), v_in))
    assert got.dtype == torch.int32 and got.shape == (v_in, rbk.shape[1])
    np.testing.assert_array_equal(got.numpy(), ref)
    # −1 entries, and inputs that feed no output (padding rows; in
    # 'down_cap' also valid voxels whose outputs the cap cut off)
    assert (rbk < 0).any() and (got < 0).all(1).any()
    # every hit appears once in the inverse, at its (input, offset)
    o, k = torch.nonzero(rbk >= 0, as_tuple=True)
    assert torch.equal(got[rbk[o, k].long(), k], o.to(torch.int32))
    assert int((got >= 0).sum()) == len(o)


def test_subm_inverse_is_the_mirrored_rulebook():
    rbk, v_in = _rulebook('subm')
    assert rbk.shape[0] == v_in
    assert torch.equal(trb.inverse_rulebook(rbk, v_in), rbk.flip(1))


def _layer(seed, kind, cin, cout):
    rng = np.random.RandomState(seed)
    rbk, v_in = _rulebook(kind)
    k = rbk.shape[1]
    feats = rng.randn(v_in, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(rbk.shape[0], cout).astype(np.float32)
    return feats, rbk, w, dout


def _jax_vjp(feats, rbk, w, dout, cdt):
    """The JAX layer's flat gather + dot and its VJP at ``dout``."""
    v = feats.shape[0]
    idx = jnp.where(rbk >= 0, rbk, v).reshape(-1)

    def layer(f, ww):
        flat = jnp.concatenate([f.astype(cdt), jnp.zeros((1, f.shape[1]), cdt)])
        g = flat[idx].reshape(rbk.shape[0], -1)
        return jnp.dot(g, ww.astype(cdt).reshape(-1, ww.shape[2]),
                       preferred_element_type=jnp.float32)
    _, vjp = jax.vjp(layer, jnp.asarray(feats), jnp.asarray(w))
    return [np.asarray(x) for x in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize('kind,cin,cout', [('subm', 16, 16), ('subm', 4, 16),
                                           ('down', 32, 64), ('down_cap', 64, 64),
                                           ('conv_out', 64, 128)])
def test_plain_backward_matches_jax_vjp_f32(kind, cin, cout):
    feats, rbk, w, dout = _layer(3, kind, cin, cout)
    jdfeat, jdw = _jax_vjp(feats, rbk.numpy(), w, dout, jnp.float32)
    dfeat = gather_gemm_dgrad_plain(_t(dout), rbk, _t(w), feats.shape[0])
    dw = gather_gemm_wgrad_plain(_t(feats), rbk, _t(dout))
    assert dfeat.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dfeat.numpy(), jdfeat,
                               atol=1e-5 * (1 + np.abs(jdfeat).max()))
    np.testing.assert_allclose(dw.numpy(), jdw, atol=1e-5 * (1 + np.abs(jdw).max()))
    hit = np.zeros(feats.shape[0], bool)
    hit[rbk.numpy()[rbk.numpy() >= 0]] = True
    assert np.all(dfeat.numpy()[~hit] == 0)     # rows no output reads


def test_plain_backward_matches_jax_vjp_bf16():
    feats, rbk, w, dout = _layer(4, 'subm', 32, 32)
    jdfeat, jdw = _jax_vjp(feats, rbk.numpy(), w, dout, jnp.bfloat16)
    fb, wb = _t(feats).bfloat16(), _t(w).bfloat16()
    dfeat = gather_gemm_dgrad_plain(_t(dout), rbk, wb, feats.shape[0]).bfloat16()
    dw = gather_gemm_wgrad_plain(fb, rbk, _t(dout)).bfloat16()
    np.testing.assert_allclose(dfeat.float().numpy(), jdfeat,
                               atol=1e-2 * np.abs(jdfeat).max())
    np.testing.assert_allclose(dw.float().numpy(), jdw, rtol=2 ** -7,
                               atol=1e-3 * np.abs(jdw).max())


@pytest.mark.parametrize('kind,cin,cout', [('subm', 4, 16), ('conv_out', 64, 128)],
                         ids=['k27_4to16', 'k3_64to128'])
def test_function_gradcheck_f64(kind, cin, cout):
    feats, rbk, w, _ = _layer(5, kind, cin, cout)
    f = _t(feats).double().requires_grad_()
    ww = _t(w).double().requires_grad_()
    inv = trb.inverse_rulebook(rbk, feats.shape[0])
    before = (cuda_kernels.launches, cuda_kernels.dgrad_launches,
              cuda_kernels.wgrad_launches)
    assert torch.autograd.gradcheck(
        lambda a, b: SparseConvGatherGemm.apply(a, b, rbk, inv), (f, ww),
        eps=1e-6, atol=1e-5, fast_mode=True)
    assert (cuda_kernels.launches, cuda_kernels.dgrad_launches,
            cuda_kernels.wgrad_launches) == before    # CPU: plain versions only


def test_function_skips_the_input_gradient_it_is_not_asked_for():
    """conv_input: the VFE's features need no gradient, so no dgrad runs
    (its Cout, the input's 4 channels, is no width the kernel takes)."""
    feats, rbk, w, dout = _layer(6, 'subm', 4, 16)
    f = _t(feats)
    ww = _t(w).requires_grad_()
    calls = []
    real = cuda_kernels.gather_gemm_dgrad
    cuda_kernels.gather_gemm_dgrad = lambda *a: calls.append(a) or real(*a)
    try:
        out = SparseConvGatherGemm.apply(f, ww, rbk, trb.inverse_rulebook(rbk, len(f)))
        out.backward(_t(dout))
    finally:
        cuda_kernels.gather_gemm_dgrad = real
    assert calls == [] and f.grad is None
    np.testing.assert_allclose(ww.grad.numpy(),
                               gather_gemm_wgrad_plain(f, rbk, _t(dout)).numpy(),
                               rtol=0, atol=0)

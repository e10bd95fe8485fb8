"""The arithmetic of the bf16 weight-gradient kernel's tensor-core route
(``crb_active_3ddet_torch/csrc/gather_gemm_wgrad.cu``, ``wgrad_mma_kernel``),
emulated in torch on the CPU.

The kernel feeds the f32 output gradient d to bf16 mmas as TERMS bf16 terms,
hi = bf16(d), mid = bf16(d − hi), lo = bf16(d − hi − mid), each rounded to
nearest, and sums every product in f32.  Here:
  * the split itself: with the kernel's TERMS (read from its source) the
    terms sum to d exactly wherever |d| ≥ 2⁻¹¹⁰, and within
    max(2⁻²⁴·|d|, 2⁻¹³⁴) for every finite d that bf16 can hold (below 2⁻¹¹⁰
    lo is a bf16 subnormal, whose step is 2⁻¹³³); two terms leave up to
    2⁻¹⁷·|d|;
  * the split product (bf16 features, the terms, f32 sums) against the f64
    einsum: within 1e-5 of the sum of the products' magnitudes, and at atol
    1e-6 for a single hit, as the card checks hold the kernel;
  * the same emulation against ``jax.vjp``'s weight cotangent of the JAX
    layer's gather + dot on reduced SECOND layers: f32 (bf16-valued
    features) within 1e-5 of the products' magnitudes, and the bf16 VJP
    within one bf16 step, as ``tests/test_torch_sparse_grad.py`` holds the
    plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from crb_active_3ddet_torch.ops import cuda_kernels
from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_neighbors

from test_torch_sparse_grad import _jax_vjp, _rulebook

ROOT = Path(__file__).resolve().parent.parent
BF16_MAX_F32 = 3.3895313892515355e38    # largest finite bf16; larger f32 may round to inf


def _kernel_constant(name):
    src = (ROOT / 'crb_active_3ddet_torch/csrc/gather_gemm_wgrad.cu').read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))


TERMS = _kernel_constant('TERMS')


def split_terms(d, terms=TERMS):
    """The kernel's split3: bf16 terms of the f32 tensor d, each the
    round-to-nearest of what the earlier ones leave."""
    out, rest = [], d
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


def split_error(d, terms=TERMS):
    """|d − Σ terms| in f64, and |d|."""
    x = torch.from_numpy(np.ascontiguousarray(d, np.float32))
    s = sum(t.double() for t in split_terms(x, terms))
    return (x.double() - s).abs().numpy(), x.double().abs().numpy()


def wgrad_split(features, rulebook, dout, terms=TERMS):
    """The kernel's product: dW[k] = Σ_v feat[rb[v, k]]ᵀ (Σ_p term_p[v]),
    each term's products of bf16 operands summed in f32."""
    g = gather_neighbors(features.bfloat16(), rulebook).float()
    out = None
    for t in split_terms(dout, terms):
        part = torch.einsum('vkc,vn->kcn', g, t.float())
        out = part if out is None else out + part
    return out


def _draws(kind):
    """f32 values across bf16's finite range: random bit patterns (every
    exponent), values whose mid or lo falls subnormal or to zero (|d| in
    [2⁻¹²⁶, 2⁻¹⁰⁰] and f32 subnormals), bf16 values (mid = lo = 0) and the
    top of the range."""
    rng = np.random.RandomState(7)
    if kind == 'bit_patterns':
        d = rng.randint(0, 2 ** 32, 400_000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    elif kind == 'subnormal_tail':
        d = (rng.uniform(1, 2, 100_000) * 2.0 ** rng.randint(-149, -99, 100_000)
             * rng.choice([-1, 1], 100_000)).astype(np.float32)
    elif kind == 'bf16_values':
        d = torch.from_numpy(rng.randn(100_000).astype(np.float32)
                             * 10.0 ** rng.randint(-30, 30, 100_000)).bfloat16().float().numpy()
    else:                                             # 'top'
        d = (rng.uniform(0.5, 1.0, 100_000) * BF16_MAX_F32).astype(np.float32)
    return d[np.isfinite(d) & (np.abs(d) <= BF16_MAX_F32)]


def test_kernel_constants():
    """Three terms; bf16 takes the tensor cores, f32 the CUDA cores."""
    assert TERMS == 3
    assert cuda_kernels.wgrad_route(torch.bfloat16) == 'mma'
    assert cuda_kernels.wgrad_route(torch.float32) == 'fma'


@pytest.mark.parametrize('kind', ['bit_patterns', 'subnormal_tail', 'bf16_values', 'top'])
def test_split_reaches_f32(kind):
    d = _draws(kind)
    err, mag = split_error(d)
    assert np.all(err <= np.maximum(2.0 ** -24 * mag, 2.0 ** -134))
    assert np.all(err[mag >= 2.0 ** -110] == 0)
    x = torch.from_numpy(d)
    hi, mid, lo = split_terms(x)
    tiny = torch.finfo(torch.float32).tiny
    if kind == 'subnormal_tail':                      # the case means what it says
        assert bool(((lo != 0) & (lo.float().abs() < tiny)).any())
        assert bool(((mid != 0) & (mid.float().abs() < tiny)).any())
        assert bool(((lo == 0) & (x.abs() >= tiny)).any())
    if kind == 'bf16_values':
        assert torch.all(mid == 0) and torch.all(lo == 0)


@settings(max_examples=400, deadline=None)
@given(st.floats(min_value=-BF16_MAX_F32, max_value=BF16_MAX_F32, width=32,
                 allow_nan=False, allow_infinity=False))
def test_split_bound_holds_for_any_value(d):
    err, mag = split_error(np.array([d], np.float32))
    assert err[0] <= max(2.0 ** -24 * mag[0], 2.0 ** -134)
    if mag[0] >= 2.0 ** -110:
        assert err[0] == 0


@pytest.mark.parametrize('terms', [2, TERMS])
def test_three_terms_are_needed(terms):
    """Two terms leave ~2⁻¹⁷ of a normal value: over the card checks' 1e-5
    of a product's magnitude and over 2⁻²⁴; three leave nothing."""
    d = np.random.RandomState(8).randn(100_000).astype(np.float32)
    err, mag = split_error(d, terms)
    worst = (err / mag).max()
    if terms < 3:
        assert 2.0 ** -18 < worst <= 2.0 ** -16
    else:
        assert worst == 0


def _layer_case(name):
    """(features bf16-valued f32, rulebook, dout f32): a random rulebook at
    SECOND's conv2 width, or a single hit."""
    rng = np.random.RandomState(21)
    v_in, v_out, k, cin, cout = 300, 200, 27, 32, 32
    rb = np.stack([np.resize(rng.permutation(v_in), v_out) for _ in range(k)], 1)
    rb[rng.rand(v_out, k) >= (0.3 if name == 'layer' else 0.0)] = -1
    if name != 'layer':
        rb[77, 13] = 5
    feats = torch.from_numpy(rng.randn(v_in, cin).astype(np.float32)).bfloat16().float()
    dout = rng.randn(v_out, cout).astype(np.float32)
    dout *= {'single_hit_tiny': 1e-30, 'single_hit_huge': 1e30}.get(name, 1.0)
    return feats, torch.from_numpy(rb.astype(np.int32)), torch.from_numpy(dout)


@pytest.mark.parametrize('name', ['layer', 'single_hit', 'single_hit_tiny', 'single_hit_huge'])
def test_split_product_matches_f64(name):
    feats, rb, dout = _layer_case(name)
    got = wgrad_split(feats, rb, dout)
    g64 = gather_neighbors(feats.double(), rb)
    ref = torch.einsum('vkc,vn->kcn', g64, dout.double())
    scale = torch.einsum('vkc,vn->kcn', g64.abs(), dout.double().abs())
    assert torch.all((got.double() - ref).abs() <= 1e-5 * scale)
    if name == 'layer':
        return
    # one product an entry: the f32 product, to its own rounding
    single = torch.outer(feats[5], dout[77])
    torch.testing.assert_close(got[13], single, atol=0, rtol=1e-6)
    assert int((got != 0).sum()) == int((single != 0).sum())
    if name == 'single_hit':
        torch.testing.assert_close(got[13], single, atol=1e-6, rtol=0)
        two = wgrad_split(feats, rb, dout, terms=2)
        assert (two[13] - single).abs().max() > 1e-6      # two terms miss it


@pytest.mark.parametrize('kind,cin,cout', [('subm', 16, 16), ('subm', 32, 32),
                                           ('down', 32, 64), ('down_cap', 64, 64),
                                           ('conv_out', 64, 128)])
def test_split_product_matches_jax_vjp(kind, cin, cout):
    """A reduced SECOND layer's rulebook; features bf16-valued, dout f32,
    both fed in from numpy."""
    rbk, v_in = _rulebook(kind)
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(v_in, cin).astype(np.float32)).bfloat16().float().numpy()
    k = rbk.shape[1]
    w = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(rbk.shape[0], cout).astype(np.float32)
    got = wgrad_split(torch.from_numpy(feats), rbk, torch.from_numpy(dout)).numpy()
    _, jdw = _jax_vjp(feats, rbk.numpy(), w, dout, jnp.float32)
    jdw = jdw.reshape(got.shape)
    g = np.abs(gather_neighbors(torch.from_numpy(feats).double(), rbk).numpy())
    scale = np.einsum('vkc,vn->kcn', g, np.abs(dout).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - jdw) <= 1e-5 * scale + 1e-30)
    assert np.abs(jdw).max() > 0
    # the JAX package's bf16 layer: its VJP rounds dW to bf16, within one
    # bf16 step of the split product rounded likewise
    _, jdw16 = _jax_vjp(feats, rbk.numpy(), w, dout, jnp.bfloat16)
    np.testing.assert_allclose(torch.from_numpy(got).bfloat16().float().numpy(),
                               jdw16.reshape(got.shape), rtol=2 ** -7,
                               atol=1e-3 * np.abs(jdw16).max())

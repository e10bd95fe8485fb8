"""The schedule of the f32 gather-GEMM kernel
(``crb_active_3ddet_torch/csrc/gather_gemm.cu``, ``gather_fma_kernel``),
emulated in torch on the CPU.

The kernel computes ``out[v] = Σ_k feat[rb[v, k]] @ W[k]`` on CUDA cores in
f32.  A block owns BM rows and TN columns; for each unit (one offset, or
16 / Cin offsets folded below Cin 16) it lists the rows that hit, in
ascending order, and walks steps (unit, chunk of at most CC input
channels) through two staged buffers, one barrier a step; the block's G
entry groups split a step's n hits, ⌈n / G⌉ (at most MR = BM / G)
consecutive ones each, and a thread continues its hits' accumulators (kept
in shared memory between steps) for 4 columns over the step's values in
(offset, channel) order.  Every output element is one chain of products
from 0 in ascending (offset, channel) order that leaves out only the rows
that miss, whose products are exactly 0: the order of the plain version's
f32 matmul, which is why the card holds the two bit-equal.

Here the emulation, with the kernel's tile constants read from its source:
  * in f32, bit-equal to a chain over every (offset, channel) in ascending
    order that multiplies the zeros too (the same two-rounding arithmetic on
    both sides): the schedule drops only exactly-zero products and keeps the
    order; and the (row, offset, channel) visits of each output row are
    exactly its hits × channels, ascending, each once;
  * in f64, against ``subm_conv3d_gather`` within 1e-12 of the products'
    magnitude: every hit is summed once;
  * in f32, against the JAX package's Pallas kernel in interpret mode (as
    its own tests run it on the CPU) within 1e-5 of the products' magnitude.
Cases: V_out not a multiple of BM, tiles without a hit, a tile where one row
hits one offset, steps where every group takes its most hits, K 27 and 3,
every supported Cin
(4/8/16/32/64/128) and Cout (16/32/64/128), and the dgrad (the inverse
rulebook with W[k]ᵀ, Cin 128).
"""

import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.ops.pallas_kernels import sparse_conv_gather_gemm as jgemm

from crb_active_3ddet_torch.ops.sparse.rulebook import inverse_rulebook
from crb_active_3ddet_torch.ops.sparse.sparse_ops import (gather_gemm_dgrad_plain,
                                                          subm_conv3d_gather)

ROOT = Path(__file__).resolve().parent.parent
SRC = (ROOT / 'crb_active_3ddet_torch/csrc/gather_gemm.cu').read_text()


def _constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SRC).group(1))


THREADS, BM, CC_MAX, NR = (_constant(n) for n in ('FMA_THREADS', 'FMA_BM', 'FMA_CC', 'NR'))


def tile(cin, cout):
    """The kernel's ``Fma<CIN, TN>`` constants."""
    tn = min(cout, 64)
    f = 16 // cin if cin < 16 else 1
    cc = min(cin, CC_MAX)
    g = THREADS // (tn // NR)
    return dict(TN=tn, F=f, CC=cc, NCH=cin // cc, D=f * cc, G=g, MR=BM // g)


def fma_schedule(feats, rb, w, visits=None):
    """The kernel's work, block by block and step by step, in the dtype of
    the inputs.  ``visits``, if given, collects (row, offset, channel) in
    the order each output row's chain takes them."""
    v_out, k = rb.shape
    cin, cout = w.shape[1], w.shape[2]
    t = tile(cin, cout)
    tn, f_, cc, d_, g_ = t['TN'], t['F'], t['CC'], t['D'], t['G']
    units = -(-k // f_)
    out = torch.empty((v_out, cout), dtype=feats.dtype)
    for v0 in range(0, v_out, BM):
        rbt = torch.full((BM, k), -1, dtype=torch.int32)
        rbt[:min(BM, v_out - v0)] = rb[v0:v0 + BM]
        # offsets padded to whole units with -1 (the staging's zero fill)
        rbu = torch.full((BM, units * f_), -1, dtype=torch.int32)
        rbu[:, :k] = rbt
        lists = [torch.nonzero((rbu[:, f_ * u:f_ * u + f_] >= 0).any(1)).flatten()
                 for u in range(units)]
        for n0 in range(0, cout, tn):
            wu = torch.zeros((units * f_, cin, tn), dtype=w.dtype)
            wu[:k] = w[:, :, n0:n0 + tn]
            acc = torch.zeros((BM + 1, tn), dtype=feats.dtype)    # row BM: scratch
            for u in range(units):
                rows = lists[u]
                n_e = len(rows)
                for c in range(0, cin, cc) if n_e else ():
                    # stage: the hits' gathered rows (zeros for -1) and the
                    # unit's weight rows, D values in (offset, channel) order
                    src = rbu[rows, f_ * u:f_ * u + f_]                   # (n_e, F)
                    g = feats[src.clamp(min=0).long(), c:c + cc]           # (n_e, F, CC)
                    g = torch.where((src >= 0)[..., None], g, torch.zeros_like(g))
                    stage_f = torch.zeros((BM, d_), dtype=feats.dtype)
                    stage_f[:n_e] = g.reshape(n_e, d_)
                    stage_w = wu[f_ * u:f_ * u + f_, c:c + cc].reshape(d_, tn)
                    # compute: the G entry groups split the hits, mr
                    # consecutive ones each (their threads own other rows);
                    # the groups past the list idle, a partial group's
                    # missing entries go to the scratch row
                    mr = min(t['MR'], -(-n_e // g_))
                    assert -(-n_e // mr) <= g_
                    e = torch.arange(-(-n_e // mr) * mr)
                    r = torch.where(e < n_e, rows[e.clamp(max=n_e - 1)], torch.tensor(BM))
                    a = acc[r]
                    for d in range(d_):
                        a = a + stage_f[e, d, None] * stage_w[d][None, :]
                    acc[r] = a
                    if visits is not None and n0 == 0:
                        for i in range(n_e):
                            for ff in range(f_):
                                kk = f_ * u + ff
                                if kk < k and rbt[rows[i], kk] >= 0:
                                    visits.setdefault(v0 + int(rows[i]), []).extend(
                                        (kk, c + ch) for ch in range(cc))
            out[v0:v0 + BM, n0:n0 + tn] = acc[:min(BM, v_out - v0)]
    return out


def chain(feats, rb, w):
    """One chain per output element over every (offset, channel) in
    ascending order, zeros for -1 included."""
    v_out, k = rb.shape
    g = feats[rb.clamp(min=0).long()]
    g = torch.where((rb >= 0)[..., None], g, torch.zeros_like(g))
    acc = torch.zeros((v_out, w.shape[2]), dtype=feats.dtype)
    for kk in range(k):
        for c in range(w.shape[1]):
            acc = acc + g[:, kk, c, None] * w[kk, c][None, :]
    return acc


def fmaf(a, b, c):
    """CUDA's fmaf on f32 tensors: a * b + c rounded to f32 once.  The
    product is exact in f64; TwoSum gives the f64 sum's error exactly;
    rounding the sum to odd at 53 bits, then to nearest f32, rounds once."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    inexact = err != 0
    bits = torch.where(inexact & ((err > 0) != (s > 0)), bits - 1, bits)    # toward 0
    bits = torch.where(inexact, bits | 1, bits)                            # odd
    return bits.view(torch.float64).float()


def fma_chain(feats, rb, w):
    """The kernel's contract on any device: one fmaf chain from 0 an output
    element, over every (offset, channel) in ascending order (a -1 entry
    gives products that are exactly 0, which leave the chain as it is)."""
    v_out, k = rb.shape
    g = feats[rb.clamp(min=0).long()]
    g = torch.where((rb >= 0)[..., None], g, torch.zeros_like(g))
    acc = torch.zeros((v_out, w.shape[2]), dtype=torch.float32, device=feats.device)
    for kk in range(k):
        for c in range(w.shape[1]):
            acc = fmaf(g[:, kk, c, None], w[kk, c][None, :], acc)
    return acc


def magnitude(feats, rb, w):
    return subm_conv3d_gather(feats.abs().double(), rb, w.abs().double()).numpy()


# (v_in, v_out, K, Cin, Cout, share of entries that hit)
CASES = {
    'cin4_cout16': (200, 300, 27, 4, 16, 0.2),       # conv_input; 300 = 2 BM + 44
    'cin8_cout32': (150, 170, 27, 8, 32, 0.3),
    'cin16_cout16': (200, 260, 27, 16, 16, 0.15),
    'cin16_cout32': (200, 140, 27, 16, 32, 0.3),
    'cin32_cout32': (150, 200, 27, 32, 32, 0.25),
    'cin32_cout64': (150, 140, 27, 32, 64, 0.2),
    'cin64_cout64_dense': (150, 130, 27, 64, 64, 0.9),   # every group at its most hits
    'cin64_cout128_k3': (150, 140, 3, 64, 128, 0.5),     # conv_out
    'empty_tiles': (100, 3 * BM + 5, 27, 32, 64, 0.3),
    'one_hit': (50, BM + 40, 27, 16, 32, 0.0),
}


def _case(name, seed=5):
    v_in, v_out, k, cin, cout, share = CASES[name]
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, v_in, (v_out, k)).astype(np.int32)
    rb[rng.rand(v_out, k) >= share] = -1
    if name == 'empty_tiles':
        rb[BM:3 * BM] = -1                 # two whole tiles without a hit
    if name == 'one_hit':
        rb[BM + 7, 13] = 11                # the second tile: one row, one offset
    feats = rng.randn(v_in, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * 0.1).astype(np.float32)
    return torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w)


def _dgrad_case(seed=6):
    """conv_out's dgrad: the forward (K 3, 64 -> 128) over a rulebook with
    each (input, offset) used once, run as the kernel runs it, over the
    inverse rulebook with W[k]ᵀ: Cin 128, Cout 64."""
    v_in, v_out, k = 170, 150, 3
    rng = np.random.RandomState(seed)
    rb = np.stack([np.resize(rng.permutation(v_in), v_out) for _ in range(k)], 1)
    rb[rng.rand(v_out, k) >= 0.6] = -1
    rb = torch.from_numpy(rb.astype(np.int32))
    w = torch.from_numpy((rng.randn(k, 64, 128) * 0.1).astype(np.float32))
    dout = torch.from_numpy(rng.randn(v_out, 128).astype(np.float32))
    return dout, rb, inverse_rulebook(rb, v_in), w, v_in


def _check(feats, rb, w, plain64):
    visits = {}
    got = fma_schedule(feats, rb, w, visits)
    # f32: the chain's bits; each row visits its hits x channels, ascending, once
    assert torch.equal(got, chain(feats, rb, w))
    cin = w.shape[1]
    for v in range(rb.shape[0]):
        want = [(kk, c) for kk in range(rb.shape[1]) if rb[v, kk] >= 0 for c in range(cin)]
        assert visits.get(v, []) == want
    empty = (rb < 0).all(1)
    assert torch.all(got[empty] == 0)
    # f64: every hit once
    mag = magnitude(feats, rb, w)
    got64 = fma_schedule(feats.double(), rb, w.double()).numpy()
    assert np.all(np.abs(got64 - plain64) <= 1e-12 * mag)
    # f32 against the Pallas kernel (interpret mode)
    pal = np.asarray(jgemm(jnp.asarray(feats.numpy()), jnp.asarray(rb.numpy()),
                           jnp.asarray(w.numpy()), block_v=64, interpret=True))
    assert np.all(np.abs(got.numpy() - pal) <= 1e-5 * mag)
    return got


@pytest.mark.parametrize('name', list(CASES))
def test_schedule_matches_chain_plain_and_pallas(name):
    feats, rb, w = _case(name)
    t = tile(w.shape[1], w.shape[2])
    got = _check(feats, rb, w, subm_conv3d_gather(feats.double(), rb, w.double()).numpy())
    if name == 'cin64_cout64_dense':
        tile0 = (rb[:BM] >= 0)                         # a step where every group
        assert int(tile0.sum(0).max()) > t['G'] * (t['MR'] - 1)    # takes MR hits
    if name == 'one_hit':
        want = torch.zeros(w.shape[2])
        for c in range(w.shape[1]):                      # one hit: its own chain
            want = want + feats[11, c] * w[13, c]
        assert torch.equal(got[BM + 7], want)
        assert int((got.abs().sum(1) > 0)[BM:2 * BM].sum()) == 1


def test_schedule_dgrad_cin128():
    """The dgrad runs the same kernel over the inverse rulebook with W[k]ᵀ:
    at Cin 128 a unit is several chunks of channels, one step each."""
    dout, rb, inv, w, v_in = _dgrad_case()
    wt = w.transpose(1, 2).contiguous()
    assert tile(128, 64)['NCH'] > 1
    plain64 = gather_gemm_dgrad_plain(dout.double(), rb, w.double(), v_in).numpy()
    _check(dout, inv, wt, plain64)


def test_tile_constants_cover_the_supported_shapes():
    """Every (Cin, Cout) the wrapper takes gives a whole tile: the entry
    groups cover the block's rows with 1 to 8 hits each (the kernel's
    instantiations), the depth is whole float4s, the chunks cover Cin."""
    for cin in (4, 8, 16, 32, 64, 128):
        for cout in (16, 32, 64, 128):
            t = tile(cin, cout)
            assert 1 <= t['MR'] <= 8 and t['MR'] * t['G'] == BM and t['D'] % 4 == 0
            assert t['NCH'] * t['CC'] == cin and cout % t['TN'] == 0


def _nearest_f32(x):
    """The f32 nearest to the rational x, ties to even."""
    x0 = np.float32(float(x))
    cands = [x0, np.nextafter(x0, np.float32(np.inf)), np.nextafter(x0, np.float32(-np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return min(near, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def test_fmaf_rounds_once():
    """The reference fmaf against the exact rational a * b + c rounded to
    the nearest f32, on random f32 triples over magnitudes 2^-30..2^30 with
    cancellation, and on a sum within a 2^-70 of an f32 midpoint, where an
    f64 sum rounded again to f32 is one step off."""
    rng = np.random.RandomState(3)
    n = 3000
    a = (rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(np.float32)
    b = (rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(np.float32)
    c = np.where(rng.rand(n) < 0.5, -(a.astype(np.float64) * b),
                 rng.randn(n) * 2.0 ** rng.randint(-30, 30, n)).astype(np.float32)
    got = fmaf(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # exact = (1 + 2^-23) + 2^-24 - 2^-70: nearest is 1 + 2^-23; f64 rounds
    # to the midpoint, which ties to 1 + 2^-22
    a1 = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    b1 = torch.tensor([(1 - 2.0 ** -23) * 2.0 ** -24], dtype=torch.float32)
    c1 = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    assert fmaf(a1, b1, c1).item() == 1 + 2.0 ** -23
    assert (a1.double() * b1.double() + c1.double()).float().item() == 1 + 2.0 ** -22


@pytest.mark.parametrize('name', ['cin4_cout16', 'one_hit'])
def test_fma_chain_matches_plain(name):
    """The card's bit-exact reference for the kernel, against the plain
    version in f64 within 1e-6 of the products' magnitude (f32 sums)."""
    feats, rb, w = _case(name)
    got = fma_chain(feats, rb, w).numpy()
    plain64 = subm_conv3d_gather(feats.double(), rb, w.double()).numpy()
    assert np.all(np.abs(got - plain64) <= 1e-6 * magnitude(feats, rb, w))

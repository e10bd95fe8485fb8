"""The schedule of the f32 weight-gradient kernel
(``crb_active_3ddet_torch/csrc/gather_gemm_wgrad.cu``, ``wgrad_fma_kernel``),
emulated in torch on the CPU.

The kernel computes ``dW[k, c, n] = Σ_{v: rb[v, k] ≥ 0} feat[rb[v, k], c] ·
dout[v, n]`` on CUDA cores in f32.  The offsets' hit lists (rows ascending)
are laid end to end, offset after offset, and cut into B equal ranges, B a
wave of the kernel's resident blocks for each Cout tile (at most nnz):
block b owns hits [b·nnz/B, (b+1)·nnz/B).  For each offset its range meets, the block lists
those hits in row order (at most LIST_CAP at a time); its G groups of
threads take every G-th of them, each element of a group's outputs one fmaf
chain from 0 over its hits in list order; the groups' tiles are added in
group order into partial slot b + k.  A second kernel adds, for each
offset, the slots of the blocks that hold its hits, one warp an element:
lane l the l-th, (l + 32)-th, ... in block order, then the lanes pairwise.

Here the emulation, with the kernel's constants read from its source:
  * the tile (M × M outputs a thread, P threads a group, G groups, H hits a
    stage) for every shape the wrapper takes, and the grid and scratch;
  * every hit visited exactly once, the blocks' shares equal to one hit,
    each group's hits ascending and every G-th of its block's share of an
    offset;
  * in f64, against ``gather_gemm_wgrad_plain`` within 1e-12 of the sum of
    the products' magnitudes;
  * in f32, against ``jax.vjp``'s weight cotangent of the JAX layer's
    gather + dot within 1e-5 of the sum of the products' magnitudes.
Cases: an empty column, a single hit (and so one block), blocks whose
share spans offsets, offsets spread over more than 32 blocks, shares that fill their stages and groups
exactly, K 27 and 3, every supported Cin (4/8/16/32/64/128) and Cout
(16/32/64/128).  The card's tests (``tests/test_torch_kernels.py``) hold the
kernel bit for bit to this emulation with an exactly rounded ``fmaf`` at the
card's own grid.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_torch.ops import cuda_kernels
from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_wgrad_plain

from test_torch_gather_fma import fmaf

ROOT = Path(__file__).resolve().parent.parent
SRC = (ROOT / 'crb_active_3ddet_torch/csrc/gather_gemm_wgrad.cu').read_text()


def _constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SRC).group(1))


THREADS, SCAN, LIST_CAP, WIDE, STAGE, MAX_K = (
    _constant(n) for n in ('THREADS', 'SCAN', 'LIST_CAP', 'WIDE', 'STAGE', 'MAX_K'))
CHUNK = THREADS * SCAN       # rows a round of a block's scan
SMEM_PER_SM = 232_448        # bytes of shared memory a block may use on Hopper
AL_WAVE = 2 * 132            # two resident blocks on each of the H100's SMs


def fma_tn(cout):
    """The kernel's Cout tile (``fma_tn``)."""
    return 128 if cout % 128 == 0 else min(cout, 64)


def tile(cin, cout):
    """The kernel's ``FmaTile<CIN, TN>`` constants."""
    tn = fma_tn(cout)
    m = 8 if cin * tn >= WIDE else 4
    p = (cin // m) * (tn // m)
    g = THREADS // p
    h = max(2 * g, STAGE)
    smem = max(2 * LIST_CAP * 4 + 2 * h * (cin + tn) * 4, g * cin * tn * 4 if g > 1 else 0)
    return dict(TN=tn, M=m, P=p, G=g, H=h, SMEM=smem)


def grid(v_out, k, cin, cout, wave):
    """``gather_gemm_wgrad_slices`` on the f32 route, for a card with
    ``wave`` resident blocks: (blocks a Cout tile, floats of partial tiles,
    ints of the hit lists and counts)."""
    blocks = max(1, wave // (cout // fma_tn(cout)))
    return blocks, (blocks + k - 1) * cin * cout, 2 * k * v_out + k * -(-v_out // CHUNK) + k


def lane_sum(values):
    """The sum kernel's order over a list of tiles: lane l adds tiles l, l +
    32, ... from 0, then lanes l and l ^ 16 are added, then ^ 8, ^ 4, ^ 2,
    ^ 1; lane 0's sum."""
    lanes = torch.zeros((32,) + values[0].shape, dtype=values[0].dtype)
    for j, v in enumerate(values):
        lanes[j % 32] = lanes[j % 32] + v
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0]


def wgrad_schedule(feats, rb, dout, blocks, fma=None, visits=None):
    """The kernel's sums in its order, in the inputs' dtype, with ``blocks``
    blocks a Cout tile (at most one a hit).  ``fma(a, b, c)`` is a chain's step (default ``a * b
    + c``, two roundings; pass ``fmaf`` for the card's one); ``visits``, if
    given, collects (block, offset, group) → the rows of its chain, in
    order.  The lists of LIST_CAP hits and the stages of H do not enter the
    sums: both are multiples of G, so group g takes the block's hits g, g +
    G, ... of an offset across them."""
    step = fma or (lambda a, b, c: a * b + c)
    v_out, k = rb.shape
    cin, cout = feats.shape[1], dout.shape[1]
    g_ = tile(cin, cout)['G']
    lists = [torch.nonzero(rb[:, kk] >= 0).flatten() for kk in range(k)]
    start = np.cumsum([0] + [len(x) for x in lists])
    nnz = int(start[-1])
    blocks = min(blocks, nnz)
    slot = {}
    for b in range(blocks):
        lo, hi = b * nnz // blocks, (b + 1) * nnz // blocks
        for kk in range(k):
            a, e = max(lo, start[kk]) - start[kk], min(hi, start[kk + 1]) - start[kk]
            if a >= e:
                continue
            rows = lists[kk][a:e]
            steps = -(-len(rows) // g_)
            pos = torch.full((steps * g_,), -1, dtype=torch.long)
            pos[:len(rows)] = rows
            pos = pos.reshape(steps, g_)                  # hit s * G + g: group g's s-th
            acc = torch.zeros((g_, cin, cout), dtype=feats.dtype)
            for s in range(steps):
                r = pos[s]
                hit = (r >= 0)[:, None, None]
                f = feats[rb[r.clamp(min=0), kk].long().clamp(min=0)][:, :, None]
                d = dout[r.clamp(min=0)][:, None, :]
                acc = torch.where(hit, step(f, d, acc), acc)
            part = torch.zeros((cin, cout), dtype=feats.dtype)
            for g in range(g_):                           # group order
                part = part + acc[g]
            slot[(b, kk)] = part
            if visits is not None:
                for g in range(g_):
                    visits[(b, kk, g)] = rows[g::g_].tolist()
    dw = torch.zeros((k, cin, cout), dtype=feats.dtype)
    for kk in range(k):
        parts = [part for (b, j), part in sorted(slot.items()) if j == kk]   # block order
        if parts:
            dw[kk] = lane_sum(parts)
    return dw


def magnitude(feats, rb, dout):
    return gather_gemm_wgrad_plain(feats.abs().double(), rb, dout.abs().double()).numpy()


# (v_in, v_out, K, Cin, Cout, share of entries that hit)
CASES = {
    'cin4_cout16': (200, 300, 27, 4, 16, 0.3),        # conv_input; 300 rows: a part slice
    'cin8_cout32': (150, 170, 27, 8, 32, 0.3),
    'cin16_cout16': (200, 260, 27, 16, 16, 0.3),
    'cin16_cout32': (200, 140, 27, 16, 32, 0.3),
    'cin32_cout32': (150, 200, 27, 32, 32, 0.25),
    'cin32_cout64': (150, 140, 27, 32, 64, 0.2),
    'cin64_cout64_full': (150, 256, 27, 64, 64, 1.0),  # stages and groups filled exactly
    'cin64_cout128_k3': (150, 140, 3, 64, 128, 0.5),  # conv_out
    'cin128_cout16': (90, 100, 27, 128, 16, 0.3),
    'cin128_cout64': (90, 100, 27, 128, 64, 0.3),
    'cin128_cout128': (90, 100, 27, 128, 128, 0.3),
    'empty_column': (150, 200, 27, 32, 64, 0.3),
    'single_hit': (50, 100, 27, 16, 32, 0.0),
    'centre_offset': (300, 300, 27, 16, 16, 0.05),      # a subm centre: every row hits
}


def _case(name, seed=5):
    v_in, v_out, k, cin, cout, share = CASES[name]
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, v_in, (v_out, k)).astype(np.int32)
    rb[rng.rand(v_out, k) >= share] = -1
    if name == 'empty_column':
        rb[:, 5] = -1
    if name == 'single_hit':
        rb[77, 13] = 11
    if name == 'centre_offset':
        rb[:, 13] = np.arange(v_out)
    feats = rng.randn(v_in, cin).astype(np.float32)
    dout = rng.randn(v_out, cout).astype(np.float32)
    return torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(dout)


CASE_BLOCKS = {'cin64_cout64_full': 27}   # 256 hits a block: 8 stages, each group 64


def _blocks(name):
    feats, rb, dout = _case(name)
    wave = CASE_BLOCKS.get(name, AL_WAVE)
    return grid(rb.shape[0], rb.shape[1], feats.shape[1], dout.shape[1], wave)[0]


@pytest.mark.parametrize('name', list(CASES))
def test_schedule_visits_each_hit_once_and_matches_plain_f64(name):
    feats, rb, dout = _case(name)
    k = rb.shape[1]
    blocks = _blocks(name)
    g_ = tile(feats.shape[1], dout.shape[1])['G']
    visits = {}
    got = wgrad_schedule(feats.double(), rb, dout.double(), blocks, visits=visits)
    # every hit once; each block's share of an offset interleaved over the
    # groups; the shares laid end to end, in block order, are the hit lists
    shares = {}
    for kk in range(k):
        seen = []
        for b in range(blocks):
            chains = [visits.get((b, kk, g), []) for g in range(g_)]
            share = sorted(r for c in chains for r in c)
            for g, c in enumerate(chains):
                assert c == share[g::g_]
            seen += share
            shares[b] = shares.get(b, 0) + len(share)
        assert seen == torch.nonzero(rb[:, kk] >= 0).flatten().tolist()
    nnz = int((rb >= 0).sum())
    assert sum(shares.values()) == nnz
    assert max(shares.values()) - min(shares.values()) <= 1      # equal shares
    plain = gather_gemm_wgrad_plain(feats.double(), rb, dout.double()).numpy()
    assert np.all(np.abs(got.numpy() - plain) <= 1e-12 * magnitude(feats, rb, dout))
    if name == 'empty_column':
        assert torch.all(got[5] == 0) and torch.all(got.abs().sum((1, 2))[:5] > 0)
    if name == 'single_hit':
        assert torch.equal(got[13], torch.outer(feats[11].double(), dout[77].double()))
        assert int((got != 0).sum()) == int((got[13] != 0).sum())


def test_cases_reach_the_edges_they_name():
    """Blocks whose share spans two offsets; fewer hits than blocks; an
    offset over more than 32 blocks; shares of whole stages that give every
    group as many hits."""
    feats, rb, dout = _case('cin32_cout32')
    blocks, nnz = _blocks('cin32_cout32'), int((rb >= 0).sum())
    ends = np.cumsum((rb >= 0).sum(0).numpy())[:-1]
    assert any(b * nnz // blocks < e < (b + 1) * nnz // blocks
               for b in range(blocks) for e in ends)
    assert _blocks('single_hit') > 1 and int((_case('single_hit')[1] >= 0).sum()) == 1
    feats, rb, dout = _case('centre_offset')               # a lane adds several slots
    assert 300 > 33 * -(-int((rb >= 0).sum()) // _blocks('centre_offset'))
    t = tile(64, 64)
    feats, rb, dout = _case('cin64_cout64_full')
    per_block = int((rb >= 0).sum()) // _blocks('cin64_cout64_full')
    assert bool(torch.all(rb >= 0)) and per_block == rb.shape[0] and per_block % t['H'] == 0


@pytest.mark.parametrize('name', ['cin4_cout16', 'cin16_cout16', 'cin32_cout32',
                                  'cin64_cout128_k3', 'cin128_cout64'])
def test_schedule_matches_jax_vjp(name):
    """f32, two roundings a step and with the card's fmaf: within 1e-5 of
    the products' magnitude of the JAX layer's weight cotangent."""
    from test_torch_sparse_grad import _jax_vjp
    feats, rb, dout = _case(name)
    k, cin, cout = rb.shape[1], feats.shape[1], dout.shape[1]
    w = np.zeros((k, cin, cout), np.float32)
    _, jdw = _jax_vjp(feats.numpy(), rb.numpy(), w, dout.numpy(), jnp.float32)
    jdw = jdw.reshape(k, cin, cout)
    mag = magnitude(feats, rb, dout)
    for fma in (None, fmaf):
        got = wgrad_schedule(feats, rb, dout, _blocks(name), fma=fma).numpy()
        assert np.all(np.abs(got.astype(np.float64) - jdw) <= 1e-5 * mag + 1e-30)
    assert np.abs(jdw).max() > 0


def test_tiles_cover_every_supported_shape():
    """Every (Cin, Cout) the wrapper takes gives a whole tile: groups of
    threads cover the block, a stage and a list hold whole groups, a
    thread's tile is whole float4s, and two blocks fit an SM's shared
    memory."""
    for cin in cuda_kernels.SUPPORTED_CIN:
        for cout in (16, 32, 64, 128, 192, 256):
            assert cuda_kernels.supported_cout(cout)
            t = tile(cin, cout)
            assert t['P'] * t['G'] == THREADS and t['H'] % t['G'] == 0
            assert LIST_CAP % t['G'] == 0
            assert t['M'] in (4, 8) and cin % t['M'] == 0 and t['TN'] % t['M'] == 0
            assert cout % t['TN'] == 0 and 2 * t['SMEM'] <= SMEM_PER_SM
    assert tile(64, 64)['M'] == 8 and tile(4, 16)['G'] == 64 and tile(64, 128)['TN'] == 128
    assert MAX_K == cuda_kernels.MAX_K == 32             # one lane an offset


@pytest.mark.parametrize('v_out,k,cin,cout,wave,blocks', [
    (64000, 27, 64, 64, AL_WAVE, 264), (64000, 3, 64, 128, AL_WAVE, 264),
    (64000, 27, 64, 256, AL_WAVE, 132), (64000, 27, 4, 16, 3 * 132, 396),
    (100, 27, 16, 16, AL_WAVE, 264), (0, 27, 16, 16, AL_WAVE, 264), (5000, 3, 64, 256, 1, 1)])
def test_grid(v_out, k, cin, cout, wave, blocks):
    """One wave a Cout tile; the partial slots b + k of every block and
    offset; the hit lists (two ints a possible hit), a count of hits for
    each offset and round of rows, and a total for each offset."""
    got = grid(v_out, k, cin, cout, wave)
    assert got[0] == blocks and (blocks == 1 or blocks * (cout // fma_tn(cout)) <= wave)
    assert got[1] == (blocks + k - 1) * cin * cout
    assert got[2] == 2 * k * v_out + k * -(-v_out // CHUNK) + k

"""Port kernels' plain versions vs the JAX package's Pallas kernels (interpret
mode) and XLA ops; the CUDA kernels themselves vs their plain versions on the
card (marked ``cuda``, skipped without one).

Tolerance 1e-4 absolute throughout, as in tests/test_pallas_kernels.py: both
sides are f32 and differ only in summation order (gather-GEMM) or in rounding
of the same clip arithmetic (overlap, boxes of size ≤ 5 m at |x| ≤ 10 m).
The farthest point sampling is held for equality (its plain version against
the JAX package is in tests/test_torch_pointnet2.py).  This file imports only
the JAX package's ops, so it also runs where flax is not installed.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from crb_active_3ddet_tpu.ops import iou3d as jiou
from crb_active_3ddet_tpu.ops.pallas_kernels import sparse_conv_gather_gemm as jgemm
from crb_active_3ddet_tpu.ops.pallas_overlap import (boxes_iou_bev_pallas,
                                                     boxes_overlap_bev_pallas)
from crb_active_3ddet_tpu.ops.sparse.sparse_ops import subm_conv3d_gather as jgather

from crb_active_3ddet_torch.ops import cuda_fps, cuda_kernels, cuda_overlap
from crb_active_3ddet_torch.ops import iou3d as tiou
from crb_active_3ddet_torch.ops.cuda_kernels import sparse_conv_gather_gemm
from crb_active_3ddet_torch.ops.sparse.sparse_ops import subm_conv3d_gather

from test_torch_gather_fma import CASES as FMA_CASES, _case as fma_case, fma_chain, fmaf
from test_torch_wgrad_fma import (CASES as WGRAD_FMA_CASES, _case as wgrad_fma_case, grid,
                                  wgrad_schedule)

ATOL = 1e-4


def _random_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-10, 10, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- overlap (K1) ----

def test_overlap_plain_matches_pallas_and_xla():
    rng = np.random.RandomState(3)
    a, b = _random_boxes(rng, 70), _random_boxes(rng, 150)   # ragged tiles
    got = tiou.boxes_overlap_bev(_t(a), _t(b)).numpy()
    pallas = np.asarray(boxes_overlap_bev_pallas(jnp.asarray(a), jnp.asarray(b),
                                                 row_tile=16, interpret=True))
    xla = np.asarray(jiou.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (70, 150)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, xla, atol=ATOL)


def test_overlap_plain_degenerate_rows():
    rng = np.random.RandomState(4)
    a = _random_boxes(rng, 8)
    a[3:] = 0.0            # zero-padded (degenerate) boxes give zero overlap
    b = _random_boxes(rng, 8)
    got = tiou.boxes_overlap_bev(_t(a), _t(b)).numpy()
    assert np.all(got[3:] == 0.0)
    pallas = np.asarray(boxes_overlap_bev_pallas(jnp.asarray(a), jnp.asarray(b),
                                                 row_tile=8, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_iou_bev_matches_pallas():
    rng = np.random.RandomState(5)
    a = _random_boxes(rng, 33)
    got = tiou.boxes_iou_bev(_t(a), _t(a)).numpy()
    ref = np.asarray(boxes_iou_bev_pallas(jnp.asarray(a), jnp.asarray(a),
                                          row_tile=16, interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_iou3d_matches_xla():
    rng = np.random.RandomState(6)
    a, b = _random_boxes(rng, 20), _random_boxes(rng, 30)
    b[:10, :2] = a[:10, :2] + 0.3          # make some pairs overlap
    got = tiou.boxes_iou3d(_t(a), _t(b)).numpy()
    ref = np.asarray(jiou.boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_overlap_batched_equals_per_frame():
    """The batch dimension (one launch per NMS step on the card) gives the
    per-frame matrices, also across the plain version's row chunks."""
    rng = np.random.RandomState(7)
    a = np.stack([_random_boxes(rng, 150) for _ in range(3)])
    b = np.stack([_random_boxes(rng, 40) for _ in range(3)])
    got = cuda_overlap.boxes_overlap_bev_cuda(_t(a), _t(b)).numpy()
    assert got.shape == (3, 150, 40)
    for f in range(3):
        ref = np.asarray(jiou.boxes_overlap_bev(jnp.asarray(a[f]),
                                                jnp.asarray(b[f])))
        np.testing.assert_allclose(got[f], ref, atol=ATOL)


# ---- gather-GEMM (K2) ----

def _gemm_case(seed, v_in, v_out, k, c_in, c_out, missing=False):
    rng = np.random.RandomState(seed)
    feats = rng.randn(v_in, c_in).astype(np.float32)
    if missing:
        rulebook = np.full((v_out, k), -1, np.int32)
    else:
        rulebook = rng.randint(-1, v_in, (v_out, k)).astype(np.int32)
    w = (rng.randn(k, c_in, c_out) * 0.1).astype(np.float32)
    return feats, rulebook, w


@pytest.mark.parametrize('cin,padded', [(5, 8), (3, 4), (4, 4), (12, 16), (24, 24),
                                         (64, 64), (200, 200)])
def test_gather_gemm_input_channel_padding(cin, padded):
    """A layer with fewer than 16 input channels that the kernels lack
    (Waymo's 5 point features at conv_input) runs as the next Cin they have
    (wider ones are left as they are, and refused): zero channels appended to
    features and weights leave every output of the function as it is (f64,
    where the added products are exact zeros) and give the weights a zero
    gradient, which the wgrad wrapper drops."""
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_wgrad_plain
    feats, rulebook, w = _gemm_case(11, 60, 45, 27, cin, 16)
    f, r, ww = _t(feats).double(), _t(rulebook), _t(w).double()
    fp, wp = cuda_kernels.pad_input_channels(f, ww)
    assert fp.shape == (60, padded) and wp.shape == (27, padded, 16)
    assert torch.equal(fp[:, :cin], f) and torch.equal(wp[:, :cin], ww)
    assert not fp[:, cin:].any() and not wp[:, cin:].any()
    torch.testing.assert_close(subm_conv3d_gather(fp, r, wp), subm_conv3d_gather(f, r, ww),
                               atol=1e-12, rtol=0)
    dout = torch.from_numpy(np.random.RandomState(12).randn(45, 16))
    dw = gather_gemm_wgrad_plain(fp, r, dout)
    torch.testing.assert_close(dw[:, :cin], gather_gemm_wgrad_plain(f, r, dout),
                               atol=1e-12, rtol=0)
    assert not dw[:, cin:].any()
    assert cuda_kernels.pad_input_channels(f)[1] is None


@pytest.mark.parametrize('case', [
    (0, 64, 48, 27, 16, 32, False),     # test_matches_xla_gather_gemm
    (1, 8, 8, 27, 4, 8, True),          # test_all_missing_neighbors
    (2, 20, 37, 27, 8, 16, False),      # test_unaligned_voxel_count
    (3, 50, 70, 3, 64, 128, False),     # conv_out shape: K = 3
], ids=['random', 'all_missing', 'unaligned', 'k3'])
def test_gather_gemm_plain_matches_pallas(case):
    feats, rulebook, w = _gemm_case(*case)
    got = sparse_conv_gather_gemm(_t(feats), _t(rulebook), _t(w)).numpy()
    pallas = np.asarray(jgemm(jnp.asarray(feats), jnp.asarray(rulebook),
                              jnp.asarray(w), block_v=16, interpret=True))
    xla = np.asarray(jgather(jnp.asarray(feats), jnp.asarray(rulebook),
                             jnp.asarray(w)))
    assert got.shape == (rulebook.shape[0], w.shape[2])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, xla, atol=ATOL)
    if case[-1]:
        assert np.all(got == 0.0)


EDGE_CASES = ['all_missing', 'single_hit', 'ragged16', 'ragged64_sparse', 'cin4',
              'k3_cout128']


def _edge_case(name):
    """Rulebooks at the edges of the CUDA kernel's tiling (a warp owns 32
    rows in two 16-row groups, a block 64 or 128): nothing to gather, one
    single entry, row counts that fill no group or tile, whole tiles without
    a hit beside tiles with few, the Cin 4 layer, and K = 3 with Cout 128."""
    rng = np.random.RandomState(11)
    v_in, v_out, k, c_in, c_out = {
        'all_missing': (40, 70, 27, 32, 32), 'single_hit': (40, 100, 27, 16, 16),
        'ragged16': (60, 37, 27, 64, 64), 'ragged64_sparse': (150, 201, 27, 32, 64),
        'cin4': (50, 90, 27, 4, 16), 'k3_cout128': (50, 70, 3, 64, 128)}[name]
    feats = rng.randn(v_in, c_in).astype(np.float32)
    w = (rng.randn(k, c_in, c_out) * 0.1).astype(np.float32)
    rulebook = rng.randint(0, v_in, (v_out, k)).astype(np.int32)
    if name == 'all_missing':
        rulebook[:] = -1
    elif name == 'single_hit':
        rulebook[:] = -1
        rulebook[77, 13] = 5
    elif name in ('ragged64_sparse', 'cin4'):
        rulebook[rng.rand(v_out, k) > 0.05] = -1       # 5 % of the entries hit
        rulebook[64:128] = -1                          # a tile with no hit at all
        rulebook[:16, 20:] = -1                        # offsets no row of a group has
    else:
        rulebook[rng.rand(v_out, k) < 0.3] = -1
    return feats, rulebook, w


@pytest.mark.parametrize('name', EDGE_CASES)
def test_gather_gemm_plain_edge_cases_match_pallas(name):
    """Tolerance 1e-4·(1 + max|ref|): f32 on both sides, another summation
    order."""
    feats, rulebook, w = _edge_case(name)
    got = sparse_conv_gather_gemm(_t(feats), _t(rulebook), _t(w)).numpy()
    pallas = np.asarray(jgemm(jnp.asarray(feats), jnp.asarray(rulebook),
                              jnp.asarray(w), block_v=16, interpret=True))
    xla = np.asarray(jgather(jnp.asarray(feats), jnp.asarray(rulebook),
                             jnp.asarray(w)))
    assert got.shape == (rulebook.shape[0], w.shape[2]) and got.dtype == np.float32
    tol = ATOL * (1 + np.abs(xla).max())
    np.testing.assert_allclose(got, pallas, atol=tol)
    np.testing.assert_allclose(got, xla, atol=tol)
    empty = (rulebook < 0).all(1)
    assert np.all(got[empty] == 0.0)
    if name == 'single_hit':
        assert empty.sum() == len(rulebook) - 1
        np.testing.assert_allclose(got[77], feats[5] @ w[13], atol=tol)


def test_gather_gemm_plain_bf16_matches_xla():
    """bf16 features and weights, f32 accumulation (the USE_BF16 path):
    bf16×bf16 products are exact in f32, so only summation order differs —
    tolerance 1e-4 relative to the output scale."""
    feats, rulebook, w = _gemm_case(8, 64, 48, 27, 32, 64)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = sparse_conv_gather_gemm(fb, _t(rulebook), wb)
    assert got.dtype == torch.float32
    ref = np.asarray(jgather(jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(rulebook),
                             jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16)))
    scale = 1.0 + np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * scale)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors no kernel is launched (the counters stay put); on a
    CUDA tensor the wrapper launches the kernel or raises."""
    before = (cuda_kernels.launches, cuda_overlap.launches)
    feats, rulebook, w = _gemm_case(0, 16, 8, 27, 4, 16)
    sparse_conv_gather_gemm(_t(feats), _t(rulebook), _t(w))
    rng = np.random.RandomState(0)
    cuda_overlap.boxes_overlap_bev_cuda(_t(_random_boxes(rng, 4)),
                                        _t(_random_boxes(rng, 4)))
    assert (cuda_kernels.launches, cuda_overlap.launches) == before


# ---- the CUDA kernels on the card (skipped without one) ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _misaligned(t):
    """The same values 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _hold_f32(f, r, ww, got):
    """The f32 route sums each output element as one fmaf chain in ascending
    (offset, channel) order: its bits are those of ``fma_chain`` (exact
    rounding, on the card).  That is the f32 matmul's order where cuBLAS
    runs one chain an element, as at the AL path's 64 000 rows, which
    chip_smoke.py holds bit for bit; at these few rows cuBLAS sums in another
    order (seen on an H100), so the plain version is held to the tolerance
    above.  The route
    reads features and weights 16 bytes a lane and refuses them unaligned
    (a Cin the kernels lack is copied into padded tensors, aligned anew)."""
    assert torch.equal(got, fma_chain(f, r, ww))
    if f.shape[1] not in cuda_kernels.SUPPORTED_CIN:
        return
    with pytest.raises(ValueError, match='aligned'):
        sparse_conv_gather_gemm(_misaligned(f), r, ww)
    with pytest.raises(ValueError, match='aligned'):
        sparse_conv_gather_gemm(f, r, _misaligned(ww))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(64, 48, 27, 16, 32), (200, 130, 27, 4, 16),
                                   (100, 70, 27, 64, 64), (90, 64, 3, 64, 128),
                                   (30, 17, 27, 32, 32), (40, 50, 27, 8, 16),
                                   (200, 130, 27, 5, 16), *FMA_CASES])
def test_gather_gemm_kernel_matches_plain(cuda_device, dtype, shape):
    """The shapes, then the cases of tests/test_torch_gather_fma.py (every
    supported Cin and Cout, tiles without a hit, one hit in a tile, steps
    where every entry group takes its most hits)."""
    feats, rulebook, w = (fma_case(shape) if isinstance(shape, str)
                          else map(_t, _gemm_case(9, *shape)))
    f = feats.to(cuda_device, dtype)
    r = rulebook.to(cuda_device)
    ww = w.to(cuda_device, dtype)
    n0 = cuda_kernels.launches
    got = sparse_conv_gather_gemm(f, r, ww)
    torch.cuda.synchronize()
    assert cuda_kernels.launches == n0 + 1
    ref = subm_conv3d_gather(f, r, ww)
    torch.testing.assert_close(got, ref, atol=ATOL * (1 + ref.abs().max().item()),
                               rtol=0)
    assert torch.equal(got, sparse_conv_gather_gemm(f, r, ww))   # same bits again
    if dtype == torch.float32:
        _hold_f32(f, r, ww, got)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', EDGE_CASES)
def test_gather_gemm_kernel_edge_cases(cuda_device, dtype, name):
    feats, rulebook, w = _edge_case(name)
    f = _t(feats).to(cuda_device, dtype)
    r = _t(rulebook).to(cuda_device)
    ww = _t(w).to(cuda_device, dtype)
    n0 = cuda_kernels.launches
    got = sparse_conv_gather_gemm(f, r, ww)
    torch.cuda.synchronize()
    assert cuda_kernels.launches == n0 + 1
    ref = subm_conv3d_gather(f, r, ww)
    torch.testing.assert_close(got, ref, atol=ATOL * (1 + ref.abs().max().item()),
                               rtol=0)
    assert torch.all(got[(r < 0).all(1)] == 0)
    assert torch.equal(got, sparse_conv_gather_gemm(f, r, ww))   # same bits again
    if dtype == torch.float32:
        _hold_f32(f, r, ww, got)


@pytest.mark.cuda
def test_gather_gemm_kernel_refuses_what_it_does_not_take(cuda_device):
    f = torch.zeros(8, 16, device=cuda_device)
    r = torch.zeros(8, 27, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match='not supported'):
        sparse_conv_gather_gemm(f, torch.zeros(8, 33, dtype=torch.int32,
                                               device=cuda_device),
                                torch.zeros(33, 16, 16, device=cuda_device))
    with pytest.raises(ValueError, match='not supported'):
        sparse_conv_gather_gemm(f, r, torch.zeros(27, 16, 24, device=cuda_device))
    with pytest.raises(TypeError):
        sparse_conv_gather_gemm(f.bfloat16(), r,
                                torch.zeros(27, 16, 16, device=cuda_device))


@pytest.mark.cuda
def test_overlap_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(10)
    a = np.stack([_random_boxes(rng, 70) for _ in range(2)])
    a[:, 60:] = 0.0
    b = np.stack([_random_boxes(rng, 150) for _ in range(2)])
    ta, tb = _t(a).to(cuda_device), _t(b).to(cuda_device)
    n0 = cuda_overlap.launches
    got = cuda_overlap.boxes_overlap_bev_cuda(ta, tb)
    torch.cuda.synchronize()
    assert cuda_overlap.launches == n0 + 1
    ref = cuda_overlap.overlap_bev_plain(ta, tb)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    assert torch.all(got[:, 60:] == 0)


def _near_touching(rng, k, margin, reach=60.0):
    """k boxes (k even) in pairs whose corner bounds lie 0 to 2 × margin
    apart along x or y (either side; the other axis overlapping), centres
    within ±reach m: the pairs at the edge of the kernel's early-out."""
    a = _random_boxes(rng, k // 2)
    b = _random_boxes(rng, k // 2)
    a[:, :2] = rng.uniform(-reach, reach, (k // 2, 2))
    b[:, :2] = 0.0
    ac, b0 = cuda_overlap.corners_cat(_t(a)), cuda_overlap.corners_cat(_t(b))
    ax0, ax1 = ac[:, :4].min(1).values.numpy(), ac[:, :4].max(1).values.numpy()
    ay0, ay1 = ac[:, 4:].min(1).values.numpy(), ac[:, 4:].max(1).values.numpy()
    bx0, bx1 = b0[:, :4].min(1).values.numpy(), b0[:, :4].max(1).values.numpy()
    by0, by1 = b0[:, 4:].min(1).values.numpy(), b0[:, 4:].max(1).values.numpy()
    gap = np.linspace(0, 2 * margin, k // 2).astype(np.float32)
    side = np.arange(k // 2) % 4
    along = rng.uniform(0, 1, k // 2).astype(np.float32)
    b[:, 0] = np.where(side == 0, ax1 + gap - bx0, np.where(
        side == 1, ax0 - gap - bx1, ax0 + along * (ax1 - ax0)))
    b[:, 1] = np.where(side == 2, ay1 + gap - by0, np.where(
        side == 3, ay0 - gap - by1, ay0 + along * (ay1 - ay0)))
    return np.stack([a, b], 1).reshape(k, 7)


def _mask_case(name):
    """(2, K, 7) boxes and (2, K) alive for the mask kernel's cases."""
    rng = np.random.RandomState(12)
    k = {'all_dead': 100, 'one_point': 300, 'near_touching': 512,
         'zero_size': 200}.get(name) or int(name[1:])
    spread = 35.0 if k >= 512 else 8.0       # a 70 m scene at the NMS's width
    boxes = np.stack([_random_boxes(rng, k) for _ in range(2)])
    boxes[..., :2] = rng.uniform(-spread, spread, (2, k, 2))
    boxes[:, 1::3, :2] = boxes[:, 0:k - 1:3, :2] + rng.normal(0, 0.5, (2, len(range(1, k, 3)), 2))
    alive = rng.rand(2, k) < 0.9
    if name == 'all_dead':
        alive[:] = False
    elif name == 'one_point':                 # every pair overlaps: the worst case
        boxes[..., :2] = 3.0
    elif name == 'near_touching':
        boxes = np.stack([_near_touching(rng, k, 1e-2) for _ in range(2)])
    elif name == 'zero_size':                 # degenerate B returns area(A)
        boxes[:, ::5, 3:5] = 0.0
    return boxes.astype(np.float32), alive


MASK_KERNEL_CASES = ['k1', 'k31', 'k33', 'k128', 'k1024', 'k1025', 'all_dead',
                     'one_point', 'near_touching', 'zero_size']


@pytest.mark.cuda
@pytest.mark.parametrize('name', MASK_KERNEL_CASES)
def test_nms_mask_kernel_equals_plain(cuda_device, name):
    """The mask kernel's words equal ``nms_mask_plain``'s on the card, but
    for pairs whose plain IoU lies within 1e-6 of the threshold (none are
    expected: both compute the same f32 arithmetic)."""
    boxes, alive = _mask_case(name)
    tb, ta = _t(boxes).to(cuda_device), _t(alive).to(cuda_device)
    thresh = 0.0 if name == 'near_touching' else 0.1    # 0: any area suppresses
    n0 = cuda_overlap.mask_launches
    got = cuda_overlap.nms_mask(tb, ta, thresh)
    torch.cuda.synchronize()
    assert cuda_overlap.mask_launches == n0 + 1
    ref = cuda_overlap.nms_mask_plain(tb, ta, thresh)
    assert got.shape == ref.shape and got.dtype == torch.int32
    if name == 'near_touching':      # at threshold 0 every bit must agree
        assert torch.equal(got, ref)
    elif not torch.equal(got, ref):
        k = boxes.shape[1]
        ov = cuda_overlap.overlap_bev_plain(tb, tb)
        areas = tb[..., 3] * tb[..., 4]
        iou = ov / torch.clamp(areas[..., :, None] + areas[..., None, :] - ov, min=1e-8)
        near = ((iou - thresh).abs() <= 1e-6).cpu().numpy()
        bits = [np.unpackbits(w.cpu().numpy().view(np.uint8), axis=-1,
                              bitorder='little')[..., :k] for w in (got, ref)]
        wrong = (bits[0] != bits[1]) & ~near
        assert not wrong.any(), f'{int(wrong.sum())} bits differ away from the threshold'
    if name == 'all_dead':
        assert not got.any()
    if name == 'zero_size':
        assert got.any()


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8, 40, 500), (2, 70, 150), (3, 1, 33),
                                   (2, 33, 1), (1, 0, 5), (2, 5, 0)])
def test_overlap_kernel_float_entry_matches_plain(cuda_device, shape):
    """The float entry over raw boxes (corners in the kernel), zero rows
    (degenerate boxes) included and a row stride of 9 floats."""
    bsz, n, m = shape
    rng = np.random.RandomState(n + m)
    a = np.zeros((bsz, n, 9), np.float32)
    a[..., :7] = np.stack([_random_boxes(rng, n) for _ in range(bsz)])
    a[:, n - n // 4:] = 0.0
    b = np.stack([_random_boxes(rng, m) for _ in range(bsz)])
    b[:, m - m // 5:] = 0.0
    ta, tb = _t(a).to(cuda_device), _t(b).to(cuda_device)
    n0 = cuda_overlap.launches
    got = cuda_overlap.boxes_overlap_bev_cuda(ta, tb)
    torch.cuda.synchronize()
    assert cuda_overlap.launches == n0 + 1
    assert got.shape == (bsz, n, m)
    ref = cuda_overlap.overlap_bev_plain(ta, tb)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    assert torch.all(got[:, n - n // 4:] == 0)


@pytest.mark.cuda
def test_overlap_kernels_refuse_what_they_do_not_take(cuda_device):
    boxes = torch.zeros(2, 8, 7, device=cuda_device)
    alive = torch.ones(2, 8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_overlap.boxes_overlap_bev_cuda(boxes.double(), boxes.double())
    with pytest.raises(TypeError):
        cuda_overlap.nms_mask(boxes.half(), alive, 0.1)
    with pytest.raises(ValueError):
        cuda_overlap.nms_mask(boxes[..., :6], alive, 0.1)
    with pytest.raises(ValueError):
        cuda_overlap.nms_mask(boxes, alive.to(torch.uint8), 0.1)
    with pytest.raises(ValueError):
        cuda_overlap.nms_mask(boxes, alive.cpu(), 0.1)
    with pytest.raises(ValueError):
        cuda_overlap.boxes_overlap_bev_cuda(boxes, boxes[:1])


def _fps_points(seed, n, snapped):
    """Random points, or multiples of 1/8 in [-1, 1] (many exact ties)."""
    rng = np.random.RandomState(seed)
    if snapped:
        return (rng.randint(-8, 9, (n, 3)) / 8).astype(np.float32)
    return (rng.randn(n, 3) * 8).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('n,k,nv', [(300, 32, 300), (1024, 256, 640),
                                    (129, 64, 129), (18000, 1024, 17000),
                                    (64, 100, 5), (64, 16, 0), (1, 4, 1),
                                    (7, 12, 7), (2049, 64, 2049),
                                    (24576, 64, 24576), (24577, 64, 24577),
                                    (45000, 2048, 30000),
                                    ('capacity', 48, 'capacity')])
def test_fps_kernel_equals_plain(cuda_device, n, k, nv, snapped):
    if n == 'capacity':
        n = nv = cuda_fps.max_points()
        assert n >= 45000
    pts = np.stack([_fps_points(s, n, snapped) for s in range(3)])
    valid = np.broadcast_to(np.arange(n) < nv, (3, n)).copy()
    p, v = _t(pts).to(cuda_device), _t(valid).to(cuda_device)
    n0 = cuda_fps.launches
    got = cuda_fps.farthest_point_sample_cuda(p, v, k)
    torch.cuda.synchronize()
    assert cuda_fps.launches == n0 + 1            # one launch for the batch
    assert torch.equal(got, cuda_fps.fps_plain(p, v, k))
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(_t(pts), _t(valid), k))


@pytest.mark.cuda
@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('part', [0, 3, 7])
def test_fps_kernel_valid_points_in_one_eighth(cuda_device, part, snapped):
    """All valid points lie in one eighth of the index range (the share one
    block of the kernel's cluster owns); more samples than valid points."""
    n, k = 2048, 300
    pts = np.stack([_fps_points(s + 20, n, snapped) for s in range(2)])
    valid = np.zeros((2, n), bool)
    valid[:, part * 256:(part + 1) * 256] = True
    p, v = _t(pts).to(cuda_device), _t(valid).to(cuda_device)
    got = cuda_fps.farthest_point_sample_cuda(p, v, k)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_fps.fps_plain(p, v, k))
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(_t(pts), _t(valid), k))


def test_fps_cluster_route_holds_a_waymo_frame():
    """The third FPS route's constants, read from ``csrc/fps.cu``: a cluster
    of 16 blocks (the non-portable size) holds the Waymo config's
    180 000-point buffer, its coordinate planes and exchange slots fit a
    block's 227 KB of shared memory, and one 256-thread block an SM leaves
    each thread the 255 registers the 44 running distances need; the register
    instances stop at 45 056 points, below every Waymo frame."""
    import re
    import yaml
    root = Path(__file__).resolve().parents[1]
    src = (root / 'crb_active_3ddet_torch/csrc/fps.cu').read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))
    cl, threads, pt = const('CL_BIG'), const('THREADS_BIG'), const('PT_BIG')
    capacity = cl * threads * pt
    assert cl == 16 and capacity == 180224
    slots = cl * threads // 32
    smem = 3 * threads * pt * 4 + 2 * slots * (8 + 16) + 2 * 8
    assert smem <= 232448
    assert threads * 255 <= 65536
    register_capacity = const('CL') * const('THREADS') * const('PT_WIDE')
    assert register_capacity == 45056
    cfg = yaml.safe_load((root / 'tools/cfgs/dataset_configs/waymo_dataset.yaml').read_text())
    vox = [p for p in cfg['DATA_PROCESSOR'] if p['NAME'] == 'transform_points_to_voxels'][0]
    for mode in ('train', 'test'):
        assert register_capacity < vox['MAX_POINTS_PER_FRAME'][mode] <= capacity


@pytest.mark.cuda
def test_fps_kernel_instances(cuda_device):
    """The wide instance (44 points a thread) holds KITTI's 45 000-point test
    buffer and the cluster-of-16 route Waymo's 180 000;
    ``test_fps_kernel_equals_plain`` runs both sides of the narrow instance's
    24 576 and ``test_fps_cluster_route_equals_plain`` both sides of 45 056."""
    assert cuda_fps.max_register_points() == 45056
    assert cuda_fps.max_points() == 180224
    assert cuda_fps.cluster_occupancy() >= 1


@pytest.mark.cuda
@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('n,k,nv', [(45057, 300, 45057), (100000, 512, 70000),
                                    (180000, 1024, 180000), (180000, 64, 1000),
                                    ('capacity', 300, 'capacity')])
def test_fps_cluster_route_equals_plain(cuda_device, n, k, nv, snapped):
    """The third route (frames past the register instances' 45 056 points)
    bit for bit against the plain version, two frames in one launch."""
    if n == 'capacity':
        n = nv = cuda_fps.max_points()
    pts = np.stack([_fps_points(s + 40, n, snapped) for s in range(2)])
    valid = np.broadcast_to(np.arange(n) < nv, (2, n)).copy()
    valid[1, ::7] = False                       # padding inside the second frame
    p, v = _t(pts).to(cuda_device), _t(valid).to(cuda_device)
    n0 = cuda_fps.launches
    got = cuda_fps.farthest_point_sample_cuda(p, v, k)
    torch.cuda.synchronize()
    assert cuda_fps.launches == n0 + 1
    assert torch.equal(got, cuda_fps.fps_plain(p, v, k))


def _spc_frames(seed, n=180000, r=128):
    """Two Waymo-sized frames (150 m square, the second with 20 000 padded
    rows) and r RoIs a frame about some of their points."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(2, n, 3) * np.array([150, 150, 6]) - np.array([75, 75, 2])).astype(np.float32)
    valid = np.ones((2, n), bool)
    valid[1, n - 20000:] = False
    rois = np.zeros((2, r, 7), np.float32)
    rois[:, :, :3] = pts[np.arange(2)[:, None], rng.randint(0, n - 20000, (2, r))]
    rois[:, :, 3:6] = rng.uniform(0.8, 5.0, (2, r, 3))
    rois[:, -8:] = 0.0                              # zero-padded RoI rows
    pts[:, 0] = [70.0, -70.0, 3.0]                  # point 0 outside every RoI's reach
    return pts, valid, rois


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['spc', 'empty'])
def test_fps_cluster_route_under_spc_mask(cuda_device, case):
    """K3 at PV-RCNN++'s Waymo shape, (2, 180 000) → 4 096, over SPC's
    candidate mask (``pfe.spc_candidates``: point 0 no candidate, FPS starts
    there all the same) and over an empty candidate set (the kernel's own
    case; SPC falls back to the valid points before it), bit for bit
    against the plain version, one launch."""
    from crb_active_3ddet_torch.models.backbones_3d.pfe import spc_candidates
    pts, valid, rois = _spc_frames(3)
    mask = spc_candidates(_t(pts), _t(valid), _t(rois), 1.6)
    assert not mask[:, 0].any() and 4096 < int(mask.sum(1).min()) < int(_t(valid).sum(1).min())
    if case == 'empty':
        mask[:] = False
    p, v = _t(pts).to(cuda_device), mask.to(cuda_device)
    n0 = cuda_fps.launches
    got = cuda_fps.farthest_point_sample_cuda(p, v, 4096)
    torch.cuda.synchronize()
    assert cuda_fps.launches == n0 + 1
    assert torch.equal(got, cuda_fps.fps_plain(p, v, 4096))
    assert (got[:, 0] == 0).all()
    if case == 'spc':
        assert torch.gather(v, 1, got[:, 1:].long()).all()


@pytest.mark.cuda
@pytest.mark.parametrize('r,n', [(0.2, (2, 2, 2)), (0.4, (3, 3, 3)), (4.8, (3, 3, 3))])
def test_pruned_three_nn_equals_dense_on_the_card(cuda_device, r, n):
    """The vector pool's pruned three-NN (``three_nn_lattice``) against its
    dense form on the card, index for index and bit for bit, at 2 × 2 048
    query points over 60 000 supports (a tenth padded, part of the query
    points far from every support), and against its own CPU result (the same
    indices; the distances within 1e-6, as the two devices round them)."""
    from crb_active_3ddet_torch.models.backbones_3d import vector_pool as vp
    rng = np.random.RandomState(5)
    xyz = (rng.rand(2, 60000, 3) * np.array([40, 40, 3])).astype(np.float32)
    valid = rng.rand(2, 60000) < 0.9
    new = xyz[:, rng.randint(0, 60000, 2048)] + (rng.randn(2, 2048, 3) * 0.1).astype(np.float32)
    new[:, :64] += np.float32(100.0)
    offsets = vp._sub_voxel_offsets(r, n).astype(np.float32)
    args = (_t(new), _t(new[:, :, None] + offsets), _t(xyz), _t(valid))
    on_card = [a.to(cuda_device) for a in args]
    dist, idx = vp.three_nn_lattice(*on_card, vp.lattice_reach(offsets))
    ddist, didx = vp.three_nn_dense(*on_card[1:])
    assert torch.equal(idx, didx) and torch.equal(dist, ddist)
    cdist, cidx = vp.three_nn_lattice(*args, vp.lattice_reach(offsets))
    assert torch.equal(idx.cpu(), cidx)
    torch.testing.assert_close(dist.cpu(), cdist, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_fps_kernel_refuses_too_many_points(cuda_device):
    n = 180225
    p = torch.zeros(1, n, 3, device=cuda_device)
    with pytest.raises(ValueError, match='at most'):
        cuda_fps.farthest_point_sample_cuda(
            p, torch.ones(1, n, dtype=torch.bool, device=cuda_device), 8)


# ---- the gather-GEMM's backward on the card (skipped without one) ----

def _backward_case(name):
    """A layer's backward inputs at the edges of the kernels' tiling: a
    rulebook in which each (input, offset) feeds at most one output (as
    every real rulebook, so that its inverse exists), the inverse, features,
    weights and an f32 output gradient.  'k3_cout128' is conv_out
    (K = 3, 64 -> 128: the dgrad's Cin is 128).  The SECOND backbone's
    (Cin, Cout, K) are cin4 (conv_input), c16_16 (conv1), random (conv2.0),
    c32_32 (conv2), ragged (conv3.0), wide (conv3, conv4) and k3_cout128
    (conv_out); 'large' cuts its rows into many slices of two scan rounds
    each, 'dense' fills every slice's hit list; 'empty_column' has an offset
    without a hit; 'tiny_dout' and 'huge_dout' are 'single_hit' with the
    output gradient scaled to ~1e-30 and ~1e30."""
    from crb_active_3ddet_torch.ops.sparse.rulebook import inverse_rulebook
    v_in, v_out, k, c_in, c_out, hit = {
        'random': (300, 200, 27, 16, 32, 0.3), 'cin4': (90, 70, 27, 4, 16, 0.3),
        'ragged': (150, 201, 27, 32, 64, 0.05), 'wide': (130, 100, 27, 64, 64, 0.5),
        'k3_cout128': (120, 77, 3, 64, 128, 0.7), 'all_missing': (40, 70, 27, 32, 32, 0.0),
        'single_hit': (40, 100, 27, 16, 16, 0.0), 'c16_16': (300, 251, 27, 16, 16, 0.3),
        'c32_32': (260, 173, 27, 32, 32, 0.3), 'large': (40000, 50000, 27, 32, 32, 0.1),
        'dense': (50000, 50000, 27, 16, 16, 1.0), 'empty_column': (300, 200, 27, 32, 64, 0.3),
        'tiny_dout': (40, 100, 27, 16, 16, 0.0), 'huge_dout': (40, 100, 27, 16, 16, 0.0),
        'cin5': (90, 70, 27, 5, 16, 0.3)}[name]
    rng = np.random.RandomState(13)
    rb = np.stack([np.resize(rng.permutation(v_in), v_out) for _ in range(k)], 1)
    rb[np.arange(v_out) >= v_in] = -1            # keep (input, offset) unique
    rb[rng.rand(v_out, k) >= hit] = -1
    if name in ('single_hit', 'tiny_dout', 'huge_dout'):
        rb[77, 13] = 5
    if name == 'empty_column':
        rb[:, 5] = -1
    rb = rb.astype(np.int32)
    feats = rng.randn(v_in, c_in).astype(np.float32)
    w = (rng.randn(k, c_in, c_out) * 0.1).astype(np.float32)
    dout = rng.randn(v_out, c_out).astype(np.float32)
    dout *= {'tiny_dout': 1e-30, 'huge_dout': 1e30}.get(name, 1.0)
    inv = inverse_rulebook(_t(rb), v_in)
    return feats, _t(rb), inv, w, dout


BACKWARD_CASES = ['random', 'cin4', 'ragged', 'wide', 'k3_cout128', 'all_missing',
                  'single_hit']
WGRAD_CASES = BACKWARD_CASES + ['c16_16', 'c32_32', 'large', 'dense', 'empty_column',
                                'tiny_dout', 'huge_dout', 'cin5']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', [n for n in BACKWARD_CASES if n != 'cin4'])
def test_gather_gemm_dgrad_kernel_matches_plain(cuda_device, dtype, name):
    """dgrad: the forward kernel over the inverse rulebook with W[k]ᵀ.
    Tolerance 1e-4·(1 + max|ref|): the plain version rounds the output
    gradient to the weights' dtype as the kernel does, so only the f32
    summation order differs."""
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_dgrad_plain
    feats, rb, inv, w, dout = _backward_case(name)
    r, iv = rb.to(cuda_device), inv.to(cuda_device)
    ww = _t(w).to(cuda_device, dtype)
    d = _t(dout).to(cuda_device)
    n0 = cuda_kernels.dgrad_launches
    got = cuda_kernels.gather_gemm_dgrad(d, r, iv, ww, len(feats))
    torch.cuda.synchronize()
    assert cuda_kernels.dgrad_launches == n0 + 1
    assert got.shape == (len(feats), w.shape[1]) and got.dtype == torch.float32
    ref = gather_gemm_dgrad_plain(d, r, ww, len(feats))
    torch.testing.assert_close(got, ref, atol=ATOL * (1 + ref.abs().max().item()),
                               rtol=0)
    assert torch.all(got[(iv < 0).all(1)] == 0)
    assert torch.equal(got, cuda_kernels.gather_gemm_dgrad(d, r, iv, ww, len(feats)))
    if dtype == torch.float32:
        # the forward's f32 route over the inverse rulebook: one fmaf chain
        # an element in ascending (offset, channel) order
        assert torch.equal(got, fma_chain(d, iv, ww.transpose(1, 2).contiguous()))
    if name == 'single_hit':
        torch.testing.assert_close(got[5], ref[5], atol=1e-6, rtol=0)
        assert int((got.abs().sum(1) > 0).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', WGRAD_CASES)
def test_gather_gemm_wgrad_kernel_matches_plain(cuda_device, dtype, name):
    """wgrad, both routes: bf16 features on tensor cores with the output
    gradient as three bf16 terms (Cin 4 staged into 16 channels), f32 on
    CUDA cores; error within 1e-5 of the sum of the products' magnitudes, equal
    bits on a second run; each route the same with the transposed rulebook
    given or built by the wrapper."""
    from crb_active_3ddet_torch.ops.sparse.rulebook import transpose_rulebook
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import gather_gemm_wgrad_plain
    feats, rb, _, w, dout = _backward_case(name)
    f = _t(feats).to(cuda_device, dtype)
    r = rb.to(cuda_device)
    d = _t(dout).to(cuda_device)
    n0 = cuda_kernels.wgrad_launches
    got = cuda_kernels.gather_gemm_wgrad(f, r, d)
    torch.cuda.synchronize()
    assert cuda_kernels.wgrad_launches == n0 + 1
    assert got.shape == w.shape and got.dtype == torch.float32
    ref = gather_gemm_wgrad_plain(f, r, d)
    scale = gather_gemm_wgrad_plain(f.abs(), r, d.abs())
    assert torch.all((got - ref).abs() <= 1e-5 * scale + 1e-30)
    assert torch.equal(got, cuda_kernels.gather_gemm_wgrad(f, r, d))
    assert torch.equal(got, cuda_kernels.gather_gemm_wgrad(f, r, d, transpose_rulebook(r)))
    if name == 'all_missing':
        assert torch.all(got == 0)
    if name == 'empty_column':
        per_offset = got.abs().sum((1, 2))
        assert per_offset[5] == 0 and torch.all(per_offset[torch.arange(len(got)) != 5] > 0)
    if name == 'single_hit':
        torch.testing.assert_close(got[13], torch.outer(f[5].float(), d[77]),
                                   atol=1e-6, rtol=0)
    if name in ('single_hit', 'tiny_dout', 'huge_dout'):
        # one product an entry: the f32 product, to its own rounding
        torch.testing.assert_close(got[13], torch.outer(f[5].float(), d[77]),
                                   atol=0, rtol=1e-6)
        assert int((got != 0).sum()) == int((torch.outer(f[5], d[77]) != 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(WGRAD_FMA_CASES))
def test_gather_gemm_wgrad_f32_kernel_matches_schedule(cuda_device, name):
    """The f32 route bit for bit against its schedule's emulation
    (tests/test_torch_wgrad_fma.py) with an exactly rounded fmaf, at the
    grid the card's library makes; the grid and scratch are the emulation's
    for the kernel's resident blocks on this card."""
    import ctypes
    from crb_active_3ddet_torch.ops import cuda_build
    feats, rb, dout = wgrad_fma_case(name)
    (v_out, k), cin, cout = rb.shape, feats.shape[1], dout.shape[1]
    lib = cuda_build.load_library('gather_gemm_wgrad', cuda_kernels._WSIG)
    cut = (ctypes.c_int * 4)()
    assert lib.gather_gemm_wgrad_slices(v_out, k, cin, cout, 0, cut) == 0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cut[3] >= 1
    assert tuple(cut[:3]) == grid(v_out, k, cin, cout, cut[3] * sms)
    got = cuda_kernels.gather_gemm_wgrad(feats.to(cuda_device), rb.to(cuda_device),
                                         dout.to(cuda_device))
    want = wgrad_schedule(feats, rb, dout, cut[0], fma=fmaf)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_gather_gemm_backward_kernels_refuse_what_they_do_not_take(cuda_device):
    feats, rb, inv, w, dout = _backward_case('random')
    f = _t(feats).to(cuda_device)
    r, iv = rb.to(cuda_device), inv.to(cuda_device)
    ww, d = _t(w).to(cuda_device), _t(dout).to(cuda_device)
    with pytest.raises(TypeError):          # features must be f32 or bf16
        cuda_kernels.gather_gemm_wgrad(f.half(), r, d)
    with pytest.raises(TypeError):          # the output gradient must be f32
        cuda_kernels.gather_gemm_wgrad(f, r, d.double())
    with pytest.raises(TypeError):
        cuda_kernels.gather_gemm_wgrad(f, r.long(), d)
    with pytest.raises(ValueError):         # one device
        cuda_kernels.gather_gemm_wgrad(f, r.cpu(), d)
    with pytest.raises(ValueError, match='not supported'):      # Cin 24
        cuda_kernels.gather_gemm_wgrad(torch.zeros(len(feats), 24, device=cuda_device),
                                       r, d)
    with pytest.raises(ValueError, match='not supported'):      # Cout 48
        cuda_kernels.gather_gemm_wgrad(f, r, d[:, :24].contiguous())
    for ff in (f, f.bfloat16()):            # both routes read the transposed rulebook
        with pytest.raises(ValueError, match='transposed'):     # (V_out, K), not (K, V_out)
            cuda_kernels.gather_gemm_wgrad(ff, r, d, r)
        with pytest.raises(ValueError, match='aligned'):
            cuda_kernels.gather_gemm_wgrad(_misaligned(ff), r, d)
        with pytest.raises(ValueError, match='aligned'):
            cuda_kernels.gather_gemm_wgrad(ff, r, _misaligned(d))
        with pytest.raises(ValueError, match='aligned'):
            cuda_kernels.gather_gemm_wgrad(ff, r, d, _misaligned(r.t().contiguous()))
    with pytest.raises(ValueError, match='inverse'):
        cuda_kernels.gather_gemm_dgrad(d, r, None, ww, len(feats))
    with pytest.raises(ValueError, match='not supported'):      # dgrad Cout 4
        cuda_kernels.gather_gemm_dgrad(d, r, iv, ww[:, :4].contiguous(), len(feats))
    with pytest.raises(ValueError):
        cuda_kernels.gather_gemm_dgrad(d, r, iv.cpu(), ww, len(feats))


@pytest.mark.cuda
def test_sparse_conv_function_on_the_card(cuda_device):
    """SparseConvGatherGemm: gradients of both inputs through the kernels,
    bf16, against the plain versions' gradients on the same card."""
    from crb_active_3ddet_torch.ops.sparse.sparse_ops import (
        gather_gemm_dgrad_plain, gather_gemm_wgrad_plain)
    feats, rb, inv, w, dout = _backward_case('wide')
    f = _t(feats).to(cuda_device, torch.bfloat16).requires_grad_()
    ww = _t(w).to(cuda_device, torch.bfloat16).requires_grad_()
    r, iv, d = rb.to(cuda_device), inv.to(cuda_device), _t(dout).to(cuda_device)
    counts = (cuda_kernels.launches, cuda_kernels.dgrad_launches,
              cuda_kernels.wgrad_launches)
    cuda_kernels.SparseConvGatherGemm.apply(f, ww, r, iv).backward(d)
    torch.cuda.synchronize()
    assert (cuda_kernels.launches, cuda_kernels.dgrad_launches,
            cuda_kernels.wgrad_launches) == tuple(c + 1 for c in counts)
    assert f.grad.dtype == ww.grad.dtype == torch.bfloat16
    ref_f = gather_gemm_dgrad_plain(d, r, ww.detach(), len(feats))
    ref_w = gather_gemm_wgrad_plain(f.detach(), r, d)
    # the Function rounds each gradient to its input's dtype once
    torch.testing.assert_close(f.grad.float(), ref_f, rtol=2 ** -7,
                               atol=ATOL * (1 + ref_f.abs().max().item()))
    torch.testing.assert_close(ww.grad.float(), ref_w, rtol=2 ** -7,
                               atol=ATOL * (1 + ref_w.abs().max().item()))

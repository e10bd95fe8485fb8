"""The NMS's suppression words (K1's mask entry, ``cuda_overlap.nms_mask``)
and the fixpoint over them, port against the JAX package.

On the CPU the mask wrapper runs ``nms_mask_plain``: the overlap of every
pair, the IoU, the threshold, the lower triangle and the alive masks, packed
32 pairs to an int32 word.  The reference is the JAX package's own route:
``boxes_overlap_bev_pallas`` in interpret mode and the formula of
``crb_active_3ddet_tpu/ops/nms.py:214-220``, packed by numpy.  Pairs whose
reference IoU lies within 1e-6 of the threshold are excused (two f32 clips of
the same boxes may round such an IoU to either side); the tests count them.

The early-out of the CUDA kernel skips pairs whose corner bounds are more
than its MARGIN apart; its premise (the plain clip of such a pair gives
exactly 0.0) is checked here on the plain version at the kernel's own
constants, read from ``csrc/overlap_bev.cu``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.ops import nms as jnms
from crb_active_3ddet_tpu.ops.pallas_overlap import boxes_overlap_bev_pallas

from crb_active_3ddet_torch.ops import cuda_overlap
from crb_active_3ddet_torch.ops import nms as tnms

ROOT = Path(__file__).resolve().parent.parent
THRESH = 0.1
NEAR = 1e-6


def _kernel_constant(name):
    src = (ROOT / 'crb_active_3ddet_torch/csrc/overlap_bev.cu').read_text()
    return float(re.search(rf'constexpr float {name} = ([0-9.e+-]+)f;', src).group(1))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scene(rng, k, spread):
    """k boxes in clusters of about four, so that many pairs overlap."""
    b = np.zeros((k, 7), np.float32)
    centres = rng.uniform(-spread, spread, (max(1, k // 4), 2))
    b[:, 0:2] = centres[rng.randint(0, len(centres), k)] + rng.normal(0, 0.6, (k, 2))
    b[:, 2] = rng.uniform(-1, 1, k)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (k, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, k)
    return b


def _jax_o_lower(boxes, alive, thresh):
    """(K, K) bool suppression matrix and IoU by the JAX package's route."""
    ov = np.asarray(boxes_overlap_bev_pallas(jnp.asarray(boxes), jnp.asarray(boxes),
                                             row_tile=16, interpret=True))
    areas = jnp.asarray(boxes[:, 3] * boxes[:, 4])
    iou = ov / jnp.clip(areas[:, None] + areas[None, :] - ov, 1e-8)
    idx = jnp.arange(len(boxes))
    al = jnp.asarray(alive)
    o_lower = (iou > thresh) & (idx[None, :] < idx[:, None]) & al[None, :] & al[:, None]
    return np.asarray(o_lower), np.asarray(iou)


def _np_pack(o_lower):
    k = o_lower.shape[-1]
    w = -(-k // 32)
    pad = np.zeros((*o_lower.shape[:-1], w * 32 - k), bool)
    return np.packbits(np.concatenate([o_lower, pad], -1), axis=-1,
                       bitorder='little').view('<u4')


def _unpack(words, k):
    """(..., W) int32 words → (..., k) bool."""
    w = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(w, axis=-1, bitorder='little')[..., :k].astype(bool)


MASK_CASES = {            # (batch, K, share of dead boxes, tied duplicates)
    'k1_b1': (1, 1, 0.0, False),
    'k33_b3': (3, 33, 0.0, False),
    'k70_b1': (1, 70, 0.0, False),
    'dead_b3': (3, 70, 0.3, False),
    'tied_b3': (3, 40, 0.1, True),
}


@pytest.mark.parametrize('name', list(MASK_CASES))
def test_nms_mask_plain_matches_jax_packing(name):
    """Words, viewed as uint32, equal numpy's packing of the JAX o_lower,
    but for pairs within 1e-6 of the threshold (excused and counted).  The
    boxes enter in the order the NMS gives them (stable descending sort of
    the scores, ties to the lowest index); 'tied' repeats boxes and scores,
    so identical boxes (IoU 1) meet; one frame of 'dead' has no live box."""
    bsz, k, dead, tied = MASK_CASES[name]
    rng = np.random.RandomState(k + bsz)
    boxes = np.stack([_scene(rng, k, 6.0) for _ in range(bsz)])
    scores = rng.rand(bsz, k).astype(np.float32)
    if tied:
        boxes[:, 10:20] = boxes[:, :1]
        scores[:, 10:20] = scores[:, :1]
    alive = rng.rand(bsz, k) >= dead
    if dead and not tied:
        alive[1] = False
    _, order = tnms._top_k(_t(scores), k)
    top = torch.gather(_t(boxes), 1, order[..., None].expand(bsz, k, 7))
    live = torch.gather(_t(alive), 1, order)
    words = cuda_overlap.nms_mask(top, live, THRESH)
    assert words.shape == (bsz, k, -(-k // 32)) and words.dtype == torch.int32
    excused = 0
    for f in range(bsz):
        ref, iou = _jax_o_lower(top[f].numpy(), live[f].numpy(), THRESH)
        near = np.abs(iou - THRESH) <= NEAR
        excused += int(near.sum())
        got = _unpack(words[f].numpy(), k)
        np.testing.assert_array_equal(got[~near], ref[~near])
        if not near.any():
            np.testing.assert_array_equal(words[f].numpy().view(np.uint32), _np_pack(ref))
        if f == 1 and dead and not tied:
            assert not got.any()
        if tied:                       # the live copies suppress each other
            p = np.flatnonzero(np.isin(order[f].numpy(), [0, *range(10, 20)])
                               & live[f].numpy())
            lower = np.tril(np.ones((len(p), len(p)), bool), -1)
            assert len(p) > 5 and (got[np.ix_(p, p)] == lower).all()
    assert excused == 0, f'{excused} pairs within {NEAR} of the threshold'


def test_pack_bits_matches_numpy():
    rng = np.random.RandomState(0)
    bits = rng.rand(4, 5, 70) < 0.5
    bits[..., 31] = bits[..., 63] = True          # the sign bits
    got = cuda_overlap.pack_bits(_t(bits)).numpy()
    assert got.dtype == np.int32 and got.shape == (4, 5, 3)
    np.testing.assert_array_equal(got.view(np.uint32), _np_pack(bits))
    np.testing.assert_array_equal(_unpack(got, 70), bits)


def test_nms_mask_on_cpu_launches_nothing():
    rng = np.random.RandomState(1)
    boxes = _t(_scene(rng, 20, 3.0))[None]
    before = (cuda_overlap.launches, cuda_overlap.mask_launches)
    cuda_overlap.nms_mask(boxes, torch.ones(1, 20, dtype=torch.bool), 0.2)
    assert (cuda_overlap.launches, cuda_overlap.mask_launches) == before


# ---- the early-out's premise, on the plain version ----

def _bounds(cor):
    """(..., 8) corners → x0, x1, y0, y1 of the 4 corners."""
    return (cor[..., :4].min(-1).values, cor[..., :4].max(-1).values,
            cor[..., 4:].min(-1).values, cor[..., 4:].max(-1).values)


@pytest.mark.parametrize('reach', [100.0, 'limit', 'long'])
def test_separated_bounds_give_exactly_zero_overlap(reach):
    """10⁴ random pairs whose corner bounds are just over the kernel's
    MARGIN apart (along x or y, either side, the other axis overlapping),
    with sides drawn log-uniformly over the kernel's MIN_SIDE to MAX_SIDE and
    centres up to ±100 m or up to its MAX_POS; 'long' takes sides from half
    MAX_SIDE up and centres within 60 m of MAX_POS, where the rounding of the
    corners is largest.  Every pair the kernel would skip (bounds apart, both
    boxes inside its size and position limits) gives exactly 0.0 by the
    plain clip, both ways round.  A degenerate B is exempt from the skip: it
    returns area(A)."""
    margin = _kernel_constant('MARGIN')
    min_side, max_side = _kernel_constant('MIN_SIDE'), _kernel_constant('MAX_SIDE')
    max_pos = _kernel_constant('MAX_POS')
    n = 10_000
    rng = np.random.RandomState(5)
    a = np.zeros((n, 7), np.float32)
    b = np.zeros((n, 7), np.float32)
    low = max_side / 2 if reach == 'long' else min_side
    for box in (a, b):
        box[:, 3:5] = np.exp(rng.uniform(np.log(low), np.log(max_side), (n, 2)))
        box[:, 5] = 1.0
        box[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if reach == 'long':
        a[:, 0:2] = rng.choice([-1, 1], (n, 2)) * rng.uniform(max_pos - 60, max_pos, (n, 2))
    else:
        a[:, 0:2] = rng.uniform(-1, 1, (n, 2)) * (max_pos if reach == 'limit' else reach)
    ac = cuda_overlap.corners_cat(_t(a))
    b0 = cuda_overlap.corners_cat(_t(b))          # B's corners about (0, 0)
    ax0, ax1, ay0, ay1 = (v.numpy() for v in _bounds(ac))
    bx0, bx1, by0, by1 = (v.numpy() for v in _bounds(b0))
    gap = margin * (1 + rng.uniform(1e-3, 0.2, n)).astype(np.float32)
    side = rng.randint(0, 4, n)                    # B right, left, above, below
    along = rng.uniform(0, 1, n).astype(np.float32)
    b[:, 0] = np.where(side == 0, ax1 + gap - bx0, np.where(
        side == 1, ax0 - gap - bx1, ax0 + along * (ax1 - ax0)))
    b[:, 1] = np.where(side == 2, ay1 + gap - by0, np.where(
        side == 3, ay0 - gap - by1, ay0 + along * (ay1 - ay0)))
    bc = cuda_overlap.corners_cat(_t(b))
    bx0, bx1, by0, by1 = (v.numpy() for v in _bounds(bc))

    def far_ok(box):
        return ((np.abs(box[:, :2]) <= max_pos).all(1)
                & ((box[:, 3:5] >= min_side) & (box[:, 3:5] <= max_side)).all(1))
    apart = ((ax0 - bx1 > margin) | (bx0 - ax1 > margin)
             | (ay0 - by1 > margin) | (by0 - ay1 > margin))
    skip = apart & far_ok(a) & far_ok(b)
    assert apart.mean() > 0.99                    # f32 rounding of the shift
    assert skip.mean() > (0.3 if reach == 'long' else 0.9)
    ta, tb = _t(a[skip])[:, None], _t(b[skip])[:, None]
    assert np.all(cuda_overlap.overlap_bev_plain(ta, tb).numpy() == 0.0)
    assert np.all(cuda_overlap.overlap_bev_plain(tb, ta).numpy() == 0.0)
    degenerate = tb.clone()
    degenerate[..., 3:5] = 0.0
    area_a = (ta[..., 3] * ta[..., 4]).numpy()
    ov = cuda_overlap.overlap_bev_plain(ta, degenerate)[..., 0].numpy()
    big = area_a > 1.0                 # the shoelace of A far from the origin
    assert big.sum() > 1000 and np.all(np.abs(ov[big] / area_a[big] - 1) < 0.1)


def test_point_boxes_take_the_exact_shortcuts():
    """Point boxes (dx = dy = 0, as the zero-padded gt rows of the recall
    record are), on the plain clip, which the float entry runs for every
    pair: a point A gives exactly 0 against any B, and a point B gives
    exactly A's own shoelace area, summed in the clip's order."""
    rng = np.random.RandomState(9)
    a = np.zeros((500, 7), np.float32)
    a[:, :2] = rng.uniform(-100, 100, (500, 2))
    a[:, 3:5] = rng.uniform(0.5, 6.0, (500, 2))
    a[:, 6] = rng.uniform(-np.pi, np.pi, 500)
    point = a.copy()
    point[:, 3:5] = 0.0
    point[:50] = 0.0                              # the zero-padded rows
    point[50:100, :2] = a[50:100, :2]             # points inside their A
    ta, tp = _t(a)[:, None], _t(point)[:, None]
    assert np.all(cuda_overlap.overlap_bev_plain(tp, ta).numpy() == 0.0)
    cx, cy = cuda_overlap.corners_xy(_t(a))
    acc = torch.zeros(500)
    for e in range(4):
        f = (e + 1) % 4
        acc = acc + (cx[:, e] * cy[:, f] - cx[:, f] * cy[:, e])
    own = 0.5 * torch.abs(acc)
    assert torch.equal(cuda_overlap.overlap_bev_plain(ta, tp)[:, 0, 0], own)


# ---- the fixpoint over words, and the NMS as a whole ----

@pytest.mark.parametrize('k,density', [(1, 0.0), (33, 0.1), (70, 0.3), (130, 0.05)])
def test_suppress_fixpoint_matches_batched(k, density):
    """``_suppress_fixpoint_packed`` (pack, then ``_fixpoint_words``) against
    the JAX package's, per frame of a batch of 3."""
    rng = np.random.RandomState(k)
    o = np.stack([np.tril(rng.rand(k, k) < density, -1) for _ in range(3)])
    got = tnms._suppress_fixpoint_packed(_t(o), 32).numpy()
    for f in range(3):
        ref = np.asarray(jnms._suppress_fixpoint_packed(jnp.asarray(o[f]), 32))
        np.testing.assert_array_equal(got[f], ref)
    keep, rounds = tnms._fixpoint_words(cuda_overlap.pack_bits(_t(o)), 32)
    np.testing.assert_array_equal(keep.numpy(), got)
    assert 1 <= rounds <= 32


@pytest.mark.parametrize('bsz,n,thresh,score_thresh', [
    (1, 33, 0.1, None), (3, 70, 0.2, 0.4), (3, 200, 0.01, None)],
    ids=['k33_b1', 'dead_b3', 'k200_b3'])
def test_rotated_nms_matrix_through_words_matches(bsz, n, thresh, score_thresh):
    """Keep indices, validity and scores equal to the JAX package's, with
    tied scores, boxes under the score threshold (dead) and batch 1 and 3."""
    rng = np.random.RandomState(n)
    boxes = np.stack([_scene(rng, n, 5.0) for _ in range(bsz)])
    scores = rng.rand(bsz, n).astype(np.float32)
    scores[:, 5:12] = scores[:, :1]
    got = tnms.rotated_nms_matrix(_t(boxes), _t(scores), thresh, 4096, 50,
                                  score_thresh=score_thresh)
    for f in range(bsz):
        ref = jnms.rotated_nms_matrix(jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
                                      thresh, 4096, 50, score_thresh=score_thresh)
        np.testing.assert_array_equal(got[1][f].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[0][f].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[2][f].numpy(), np.asarray(ref[2]), atol=1e-4)
        assert 0 < int(ref[1].sum()) < n

"""The port's PointNet++ primitives and point-feature modules vs the JAX
package, from the same seeded numpy inputs.

Farthest point sampling (K3): the port's plain version (what its wrapper runs
on CPU tensors) must equal BOTH the JAX scan (``ops.pointnet2``; what the JAX
package runs on the CPU) and the Pallas kernel in interpret mode, index for
index — one differing index changes every later one.  Points snapped to
multiples of 1/8 make every square and sum exact in f32 and give many exact
ties, so the tie rule (lowest index) is tested and no fused multiply-add can
excuse a difference.  The CUDA kernel itself is held to the plain version on
the card in tests/test_torch_kernels.py.

ball_query: ``idx`` and ``cnt`` must be equal, not close.  StackSAModuleMSG
and bilinear_interpolate from transferred weights: atol 1e-5 (same f32
formulas; only the summation order inside the small matrix products differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.models.backbones_3d import pfe as jpfe
from crb_active_3ddet_tpu.ops import pointnet2 as jpn2
from crb_active_3ddet_tpu.ops.pallas_kernels import farthest_point_sample_pallas

from crb_active_3ddet_torch.models.backbones_3d import pfe as tpfe
from crb_active_3ddet_torch.ops import cuda_fps
from crb_active_3ddet_torch.ops import pointnet2 as tpn2
from crb_active_3ddet_torch.utils.flax_weights import sa_module_from_flax

SIZES = [(300, 32, 300), (1024, 256, 640), (129, 64, 129)]   # N, K, valid
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _points(seed, n, snapped):
    rng = np.random.RandomState(seed)
    if snapped:                     # multiples of 1/8 in [-1, 1]
        return (rng.randint(-8, 9, (n, 3)) / 8).astype(np.float32)
    return (rng.randn(n, 3) * 8).astype(np.float32)


def _tied_steps(pts, valid, idx):
    """Steps of the sequence ``idx`` at which the maximum was attained by
    more than one point (float64 is exact on the snapped points)."""
    dist = np.where(valid, 1e10, -1e10)
    ties = 0
    for last in idx[:-1]:
        d = ((pts.astype(np.float64) - pts[last]) ** 2).sum(1)
        dist = np.minimum(dist, np.where(valid, d, -1e10))
        ties += int((dist == dist.max()).sum() > 1)
    return ties


# ---- farthest point sampling (K3) ----

@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('n,k,nv', SIZES)
def test_fps_plain_equals_scan_and_pallas(n, k, nv, snapped):
    pts = _points(42 + n, n, snapped)
    valid = np.arange(n) < nv
    got = tpn2.farthest_point_sample(_t(pts)[None], _t(valid)[None], k)
    assert got.dtype == torch.int32 and got.shape == (1, k)
    got = got[0].numpy()
    scan = np.asarray(jpn2.farthest_point_sample(jnp.asarray(pts),
                                                 jnp.asarray(valid), k))
    pallas = np.asarray(farthest_point_sample_pallas(
        jnp.asarray(pts), jnp.asarray(valid), k, interpret=True))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)
    assert (got < nv).all()
    if snapped:        # the tie rule really decided a good share of the steps
        assert _tied_steps(pts, valid, got) >= k // 8


@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('n,k', [(1, 4), (7, 12), (2049, 64)])
def test_fps_plain_equals_scan_at_edge_sizes(n, k, snapped):
    """A single point (it repeats), fewer points than samples, and one point
    more than a power of two (the CUDA kernel splits a frame into eighths of
    ceil(N / 8) points, the last of which is then short)."""
    pts = _points(90 + n, n, snapped)
    valid = np.ones(n, bool)
    got = tpn2.farthest_point_sample(_t(pts)[None], _t(valid)[None], k)[0].numpy()
    scan = np.asarray(jpn2.farthest_point_sample(jnp.asarray(pts),
                                                 jnp.asarray(valid), k))
    np.testing.assert_array_equal(got, scan)
    assert got[0] == 0 and (got < n).all()
    assert len(set(got.tolist())) == min(n, k)


@pytest.fixture
def one_torch_thread():
    """Torch ops on one thread: the plain FPS is ~20 000 small ops at this
    size, and on 8 threads each waits at its barrier while the suite's
    workers share the cores (each case took ~450 s of a 6-worker run
    so, against 2-8 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
def test_fps_plain_equals_scan_at_kitti_test_buffer(snapped, one_torch_thread):
    """KITTI's 45 000-point test buffer (past the kernel's narrow instance
    of 24 576 points a frame), partly valid, 2 048 keypoints: the plain
    version against the JAX scan, exactly, with the tie rule deciding steps
    on the snapped points."""
    n, k, nv = 45000, 2048, 30000
    pts = _points(45, n, snapped)
    valid = np.zeros(n, bool)
    valid[np.random.RandomState(4).permutation(n)[:nv]] = True
    got = tpn2.farthest_point_sample(_t(pts)[None], _t(valid)[None], k)[0].numpy()
    scan = np.asarray(jpn2.farthest_point_sample(jnp.asarray(pts), jnp.asarray(valid), k))
    np.testing.assert_array_equal(got, scan)
    assert valid[got].all() and len(set(got.tolist())) == k
    if snapped:
        assert _tied_steps(pts, valid, got) >= k // 8


@pytest.mark.parametrize('snapped', [False, True], ids=['random', 'snapped'])
@pytest.mark.parametrize('part', [0, 3, 7])
def test_fps_plain_valid_points_in_one_eighth(part, snapped):
    """All valid points lie in one eighth of the index range, and there are
    fewer of them than samples: every one is chosen once, then the lowest
    repeats; index 0 is the start even where it is invalid."""
    n, k = 512, 80
    pts = _points(30 + part, n, snapped)
    valid = np.zeros(n, bool)
    valid[part * 64:(part + 1) * 64] = True
    got = tpn2.farthest_point_sample(_t(pts)[None], _t(valid)[None], k)[0].numpy()
    scan = np.asarray(jpn2.farthest_point_sample(jnp.asarray(pts),
                                                 jnp.asarray(valid), k))
    np.testing.assert_array_equal(got, scan)
    assert got[0] == 0
    chosen = got[1:] if part else got
    assert valid[chosen].all()
    assert set(chosen[:64 - (part == 0)].tolist()) <= set(range(part * 64, part * 64 + 64))
    assert (got[66:] == part * 64).all()


def test_fps_batched_equals_per_frame():
    """One call for the whole batch gives each frame's own sequence, with a
    different validity per frame."""
    pts = np.stack([_points(s, 257, s % 2 == 1) for s in range(4)])
    valid = np.arange(257)[None, :] < np.array([257, 200, 40, 1])[:, None]
    got = tpn2.farthest_point_sample(_t(pts), _t(valid), 48).numpy()
    for f in range(4):
        ref = np.asarray(jpn2.farthest_point_sample(
            jnp.asarray(pts[f]), jnp.asarray(valid[f]), 48))
        np.testing.assert_array_equal(got[f], ref)


def test_fps_fewer_valid_than_samples_and_none():
    """With fewer valid points than K every valid point is chosen once and
    then the lowest-index valid point repeats; a frame without valid points
    returns index 0 throughout.  Validity need not be a prefix."""
    pts = _points(7, 64, False)
    valid = np.zeros((3, 64), bool)
    valid[0, [3, 9, 20, 41, 63]] = True          # 5 valid, point 0 invalid
    valid[1, :10] = True
    got = tpn2.farthest_point_sample(_t(np.stack([pts] * 3)), _t(valid), 16).numpy()
    for f in range(3):
        ref = np.asarray(jpn2.farthest_point_sample(
            jnp.asarray(pts), jnp.asarray(valid[f]), 16))
        np.testing.assert_array_equal(got[f], ref)
    assert got[0, 0] == 0                         # the start is index 0
    assert sorted(got[0, 1:6]) == [3, 9, 20, 41, 63]
    assert (got[0, 6:] == 3).all()
    assert sorted(got[1, :10]) == list(range(10)) and (got[1, 10:] == 0).all()
    assert (got[2] == 0).all()


def test_fps_wrapper_checks_and_cpu_path():
    """Bad inputs raise; CPU tensors take the plain version and launch
    nothing."""
    pts, valid = _t(_points(0, 16, False))[None], torch.ones(1, 16, dtype=torch.bool)
    before = cuda_fps.launches
    cuda_fps.farthest_point_sample_cuda(pts, valid, 4)
    assert cuda_fps.launches == before
    with pytest.raises(TypeError):
        cuda_fps.farthest_point_sample_cuda(pts.double(), valid, 4)
    with pytest.raises(TypeError):
        cuda_fps.farthest_point_sample_cuda(pts, valid.float(), 4)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sample_cuda(pts[0], valid[0], 4)
    with pytest.raises(ValueError):
        cuda_fps.farthest_point_sample_cuda(pts, valid, 0)


# ---- ball query and grouping ----

def _ball_case(seed, n, m, n_valid, m_valid):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-2, 2, (2, n, 3)).astype(np.float32)
    new = rng.uniform(-2, 2, (2, m, 3)).astype(np.float32)
    new[:, -3:] += 50.0                           # centres with no hit
    xv = np.arange(n)[None, :] < np.array([n, n_valid])[:, None]
    nv = np.arange(m)[None, :] < np.array([m_valid, m])[:, None]
    return xyz, xv, new, nv


@pytest.mark.parametrize('radius,nsample', [(0.4, 2), (1.0, 8), (3.0, 4)])
def test_ball_query_equal(radius, nsample):
    xyz, xv, new, nv = _ball_case(1, 200, 50, 120, 30)
    idx, cnt = tpn2.ball_query(radius, nsample, _t(xyz), _t(xv), _t(new), _t(nv))
    assert idx.shape == (2, 50, nsample) and cnt.shape == (2, 50)
    for f in range(2):
        ridx, rcnt = jpn2.ball_query(radius, nsample, jnp.asarray(xyz[f]),
                                     jnp.asarray(xv[f]), jnp.asarray(new[f]),
                                     jnp.asarray(nv[f]))
        np.testing.assert_array_equal(idx[f].numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(cnt[f].numpy(), np.asarray(rcnt))
    cnt = cnt.numpy()
    assert (cnt[:, -3:] == 0).all() and (idx[:, -3:].numpy() == 0).all()
    assert (cnt[0, 30:] == 0).all()               # invalid centres
    assert cnt.max() == nsample and 0 < (cnt > 0).mean() < 1
    assert (idx[1].numpy() < 120).all()           # invalid sources never hit


def test_ball_query_on_the_radius_is_outside():
    """Lattice points (multiples of 1/8): many pairs lie exactly on the
    sphere, where every square and sum is exact, so the strict ``<`` decides
    the same way in both packages."""
    rng = np.random.RandomState(8)
    xyz = (rng.randint(-8, 9, (1, 300, 3)) / 8).astype(np.float32)
    new = (rng.randint(-8, 9, (1, 60, 3)) / 8).astype(np.float32)
    ok_x, ok_n = np.ones((1, 300), bool), np.ones((1, 60), bool)
    d2 = ((new[0, :, None].astype(np.float64) - xyz[0, None]) ** 2).sum(-1)
    assert (d2 == 0.25).sum() >= 10
    idx, cnt = tpn2.ball_query(0.5, 32, _t(xyz), _t(ok_x), _t(new), _t(ok_n))
    ridx, rcnt = jpn2.ball_query(0.5, 32, jnp.asarray(xyz[0]), jnp.asarray(ok_x[0]),
                                 jnp.asarray(new[0]), jnp.asarray(ok_n[0]))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray(rcnt))
    np.testing.assert_array_equal(cnt[0].numpy(), np.minimum((d2 < 0.25).sum(1), 32))


def test_ball_query_chunked_equals_whole(monkeypatch):
    xyz, xv, new, nv = _ball_case(2, 90, 41, 90, 41)
    args = (0.9, 8, _t(xyz), _t(xv), _t(new), _t(nv))
    whole = tpn2.ball_query(*args)
    monkeypatch.setattr(tpn2, '_PAIR_CHUNK', 2 * 90 * 7)      # 7 centres a step
    parts = tpn2.ball_query(*args)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


def test_grouping_operation_equal():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 30, 5).astype(np.float32)
    idx = rng.randint(0, 30, (2, 7, 4))
    got = tpn2.grouping_operation(_t(feats), _t(idx)).numpy()
    assert got.shape == (2, 7, 4, 5)
    for f in range(2):
        ref = jpn2.grouping_operation(jnp.asarray(feats[f]), jnp.asarray(idx[f]))
        np.testing.assert_array_equal(got[f], np.asarray(ref))


# ---- StackSAModuleMSG and bilinear interpolation ----

def _fill(rng):
    def fill(path, s):
        name = '/'.join(str(p.key) for p in path)
        if name.endswith('var'):
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if name.endswith(('mean', 'bias')):
            return (0.2 * rng.randn(*s.shape)).astype(np.float32)
        if name.endswith('scale'):
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
    return fill


@pytest.mark.parametrize('use_features', [True, False], ids=['feat', 'xyz_only'])
def test_stack_sa_module_matches(use_features):
    """Two radii, different nsample, empty balls and invalid centres: the
    zeroing before the MLP and after the pool both matter, since the BN
    biases make a zero input non-zero."""
    xyz, xv, new, nv = _ball_case(4, 150, 40, 100, 25)
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 150, 6).astype(np.float32)
    mlps = ((8, 12), (16, 8))
    jmod = jpfe.StackSAModuleMSG(radii=(0.7, 1.5), nsamples=(8, 12), mlps=mlps)
    jargs = [jnp.asarray(a) for a in (xyz, xv, new, nv)]
    # the JAX module with features=None groups xyz only
    jfeats = jnp.asarray(feats) if use_features else None
    shapes = jax.eval_shape(lambda r: jmod.init(r, *jargs, jfeats),
                            jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map_with_path(_fill(rng), shapes)
    ref = np.asarray(jmod.apply(var, *jargs, jfeats))

    in_ch = 6 if use_features else 0
    tmod = tpfe.StackSAModuleMSG((0.7, 1.5), (8, 12), mlps, in_ch).eval()
    sd = {}
    sa_module_from_flax(sd, 'm', var['params'], var['batch_stats'], mlps)
    tmod.load_state_dict({k[2:]: _t(np.array(v)) for k, v in sd.items()})
    tfeats = _t(feats) if use_features else torch.zeros(2, 150, 0)
    with torch.no_grad():
        got = tmod(_t(xyz), _t(xv), _t(new), _t(nv), tfeats).numpy()
    assert got.shape == ref.shape == (2, 40, 20)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (got[:, -3:] == 0).all() and (got[0, 25:] == 0).all()
    assert np.abs(got[1, :25]).max() > 0.1


def test_bilinear_interpolate_matches():
    """Inside, on the border and outside the map (clipped neighbours, the
    weights from the clipped indices)."""
    rng = np.random.RandomState(6)
    im = rng.randn(2, 9, 11, 5).astype(np.float32)
    x = rng.uniform(-1.5, 12.5, (2, 64)).astype(np.float32)
    y = rng.uniform(-1.5, 10.5, (2, 64)).astype(np.float32)
    x[:, :4], y[:, :4] = [0.0, 10.0, 3.0, 10.5], [0.0, 8.0, 8.5, 2.0]
    got = tpfe.bilinear_interpolate(_t(im), _t(x), _t(y)).numpy()
    for f in range(2):
        ref = jpfe.bilinear_interpolate(jnp.asarray(im[f]), jnp.asarray(x[f]),
                                        jnp.asarray(y[f]))
        np.testing.assert_allclose(got[f], np.asarray(ref), atol=ATOL)

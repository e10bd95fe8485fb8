"""PV-RCNN++'s vector pool in the port (``models/backbones_3d/vector_pool.py``)
vs the JAX package's (``crb_active_3ddet_tpu/models/backbones_3d/
vector_pool.py``), from the same numpy inputs and the same weights.

- ``_sub_voxel_offsets`` equal to JAX's at the configs' lattices;
- the interpolation against JAX's ``_chunked_three_interpolate`` (vmapped
  over 2 frames, small chunks): near and far queries (the nearest support
  past 2R zeroes the row), exact ties on a 1/4 m lattice, a frame with
  fewer than 3 valid supports (JAX picks the lowest-index padding at √BIG);
  the three-NN indices of the port's dense form and of its pruned form
  (``three_nn_lattice``) index for index equal to ``jax.lax.top_k``'s, the
  interpolations 1e-6;
- the pruned form against the dense form bit for bit (indices and
  distances) with its candidate cap and pair chunk forced small, so that
  query points take both routes and every step is chunked, and with fewer
  than 3 supports in the buffer;
- ``VectorPoolAggregationMSG`` from the Flax weights in eval and in
  training (outputs 1e-5 of the largest value, BatchNorm statistics over
  every (B, M, G) row, invalid queries included, 1e-5), its gradients in
  float64 on both sides (``jax.enable_x64``) within 1e-9 of their norm;
- ``flax_init`` draws each local kernel as Flax's ``kaiming_normal``: a
  normal truncated at ±2 of its scale, std √(2 / fan_in) with Flax's fan-in
  G·(3 + C) for the (G, 3 + C, 32) shape.

Torch ops run on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import CfgNode
from crb_active_3ddet_tpu.models.backbones_3d import vector_pool as jvp
from crb_active_3ddet_tpu.ops import pointnet2 as jpn2

from crb_active_3ddet_torch.models.backbones_3d import vector_pool as tvp
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.ops import pointnet2 as tpn2
from crb_active_3ddet_torch.utils.flax_weights import vector_pool_from_flax

from test_torch_second_eval import _fill

LAYER = {
    'NUM_GROUPS': 2, 'NUM_REDUCED_CHANNELS': 2, 'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
    'LOCAL_AGGREGATION_TYPE': 'local_interpolation', 'MSG_POST_MLPS': [32],
    'GROUP_CFG_0': {'NUM_LOCAL_VOXEL': [2, 2, 2], 'MAX_NEIGHBOR_DISTANCE': 0.4,
                    'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [16, 16]},
    'GROUP_CFG_1': {'NUM_LOCAL_VOXEL': [3, 3, 3], 'MAX_NEIGHBOR_DISTANCE': 0.8,
                    'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [16, 16]}}
C_IN = 6


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


@pytest.mark.parametrize('r,n', [(0.2, (2, 2, 2)), (0.4, (3, 3, 3)), (1.2, (3, 3, 3)),
                                 (4.8, (3, 3, 3)), (0.8, (2, 3, 4))])
def test_sub_voxel_offsets_equal_jax(r, n):
    got, want = tvp._sub_voxel_offsets(r, n), jvp._sub_voxel_offsets(r, n)
    assert got.shape == (np.prod(n), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(want, jnp.float32)),
                                  got.astype(np.float32))
    assert np.isclose(tvp.lattice_reach(got), np.sqrt(3) * (r - r / max(n)), rtol=1e-6) \
        if len(set(n)) == 1 else tvp.lattice_reach(got) > 0


def _frames(case, n=300, m=40):
    """(supports (2, N, 3), valid (2, N), features (2, N, C), query points
    (2, M, 3)) of one interpolation case."""
    rng = np.random.RandomState({'near': 0, 'far': 1, 'ties': 2, 'few_valid': 3}[case])
    xyz = (rng.rand(2, n, 3) * np.array([6.0, 6.0, 2.0])).astype(np.float32)
    valid = rng.rand(2, n) < 0.85
    new = xyz[:, rng.randint(0, n, m)] + rng.randn(2, m, 3).astype(np.float32) * 0.05
    if case == 'far':                  # nearest support past 2R for part of the rows
        new[:, :m // 2] += np.float32(3.0)
    if case == 'ties':                 # a 1/4 m lattice: equal distances everywhere
        xyz = (rng.randint(0, 12, (2, n, 3)) / 4).astype(np.float32)
        new = (rng.randint(0, 12, (2, m, 3)) / 4).astype(np.float32)
    if case == 'few_valid':
        valid[1] = False
        valid[1, [7, 200]] = True
    feats = rng.randn(2, n, 4).astype(np.float32)
    return xyz, valid, feats, new


@pytest.mark.parametrize('case', ['near', 'far', 'ties', 'few_valid'])
@pytest.mark.parametrize('r,n', [(0.5, (2, 2, 2)), (0.75, (3, 3, 3))])
def test_interpolation_matches_jax(case, r, n):
    """(Lattices of multiples of 1/4 m: on the 1/4 m grid of the ties case
    every squared distance is exact, so the packages' summation orders
    round none of them and the ties are true ties in both.)"""
    xyz, valid, feats, new = _frames(case)
    offsets = tvp._sub_voxel_offsets(r, n).astype(np.float32)
    centres = new[:, :, None] + offsets                     # (2, M, G, 3)
    q = centres.reshape(2, -1, 3)
    jint = jax.vmap(lambda s, v, f, qq: jvp._chunked_three_interpolate(
        s, v, f, qq, max_dist=2.0 * r, chunk=64))(xyz, valid, feats, q)
    _, jidx = jax.vmap(lambda qq, s, v: jpn2.three_nn(qq, jnp.ones(qq.shape[0], bool), s, v))(
        q, xyz, valid)
    jint, jidx = np.asarray(jint), np.asarray(jidx)
    dense = tvp._chunked_three_interpolate(_t(xyz), _t(valid), _t(feats), _t(q), 2.0 * r)
    _, didx = tvp.three_nn_dense(_t(centres), _t(xyz), _t(valid))
    dist, idx = tvp.three_nn_lattice(_t(new), _t(centres), _t(xyz), _t(valid),
                                     tvp.lattice_reach(offsets))
    lattice = tpn2.three_interpolate(_t(feats), idx, dist).masked_fill(
        ~(dist[..., :1] <= 2.0 * r), 0.0)
    np.testing.assert_array_equal(_np(didx), jidx)
    np.testing.assert_array_equal(_np(idx), jidx)
    np.testing.assert_allclose(_np(dense), jint, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(lattice), jint, atol=1e-6, rtol=1e-6)
    zero = (jint == 0).all(-1)
    if case == 'far':
        assert zero.any() and not zero.all()
    if case == 'few_valid':                  # padding picked, at √BIG
        assert not np.take_along_axis(valid[1], jidx[1].reshape(-1), 0).all()
        assert (_np(dist)[1, :, 2] > 1e4).all()
    if case == 'ties':
        d = _np(dist)
        assert (d[..., 0] == d[..., 1]).sum() > 10


@pytest.mark.parametrize('cap,chunk', [(tvp.CANDIDATE_CAP, tpn2._PAIR_CHUNK), (80, 5000),
                                       (3, 4000), (1000, 997)])
@pytest.mark.parametrize('case', ['near', 'far', 'ties', 'few_valid', 'two_supports'])
def test_pruned_three_nn_equals_dense(monkeypatch, case, cap, chunk):
    """Index for index and bit for bit, whatever share of the query points
    takes the dense route (cap) and however the steps are chunked."""
    monkeypatch.setattr(tvp, 'CANDIDATE_CAP', cap)
    monkeypatch.setattr(tpn2, '_PAIR_CHUNK', chunk)
    if case == 'two_supports':
        xyz, valid, _, new = _frames('near', n=2)
        valid[:] = True
    else:
        xyz, valid, _, new = _frames(case)
    for r, n in ((0.4, (2, 2, 2)), (2.4, (3, 3, 3))):
        offsets = tvp._sub_voxel_offsets(r, n).astype(np.float32)
        centres = _t(new[:, :, None] + offsets)
        dist, idx = tvp.three_nn_lattice(_t(new), centres, _t(xyz), _t(valid),
                                         tvp.lattice_reach(offsets))
        ddist, didx = tvp.three_nn_dense(centres, _t(xyz), _t(valid))
        assert torch.equal(idx, didx), (case, r)
        assert torch.equal(dist, ddist), (case, r)


def test_pruned_routes_both_taken(monkeypatch):
    """At a cap of 80 candidates part of the query points go dense."""
    xyz, valid, _, new = _frames('near')
    offsets = tvp._sub_voxel_offsets(0.8, (3, 3, 3)).astype(np.float32)
    counts, ok, _ = tvp._candidates(_t(new[0]), _t(xyz[0]), _t(valid[0]),
                                    tvp.lattice_reach(offsets))
    assert ok.all() and 80 > counts.min() and counts.max() > 80
    monkeypatch.setattr(tvp, "CANDIDATE_CAP", 80)
    _, ok, _ = tvp._candidates(_t(new[0]), _t(xyz[0]), _t(valid[0]),
                               tvp.lattice_reach(offsets))
    assert ok.any() and not ok.all()


# ---- the module ---------------------------------------------------------------------

def _module_inputs(dtype=np.float32):
    rng = np.random.RandomState(7)
    b, n, m = 2, 400, 48
    xyz = (rng.rand(b, n, 3) * np.array([6.0, 6.0, 2.0])).astype(dtype)
    valid = np.arange(n)[None] < np.array([[340], [400]])
    new = xyz[:, rng.randint(0, 340, m)] + (rng.randn(b, m, 3) * 0.1).astype(dtype)
    new[:, :6] += dtype(4.0)                       # beyond 2R of every support
    new_valid = rng.rand(b, m) < 0.8
    feats = rng.randn(b, n, C_IN).astype(dtype)
    return xyz, valid, new, new_valid, feats


class Pair:
    def __init__(self):
        self.inputs = _module_inputs()
        self.jmod = jvp.VectorPoolAggregationMSG(config=CfgNode(LAYER))
        shapes = jax.eval_shape(lambda r, *a: self.jmod.init(r, *a, training=False),
                                jax.random.PRNGKey(0), *self.inputs)
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        self.tmod = tvp.VectorPoolAggregationMSG(LAYER, C_IN)
        sd = {}
        vector_pool_from_flax(sd, 'm', self.var['params'], self.var['batch_stats'], LAYER)
        self.tmod.load_state_dict({k[2:]: _t(v) for k, v in sd.items()})


@pytest.fixture(scope='module')
def pair():
    return Pair()


def test_weight_transfer_is_complete(pair):
    sd = {}
    vector_pool_from_flax(sd, 'm', pair.var['params'], pair.var['batch_stats'], LAYER)
    assert {k[2:] for k in sd} == set(pair.tmod.state_dict())
    assert sum(np.size(x) for x in jax.tree.leaves(pair.var)) == sum(
        np.size(v) for k, v in sd.items() if not k.endswith('num_batches_tracked'))
    assert pair.tmod.layers[1].local_kernel.shape == (27, 3 + 2, 8)
    assert pair.tmod.layers[0].c_red == 2


def _close(got, want, tol, msg=''):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=0, err_msg=msg)


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_forward_matches_jax(pair, training):
    out, mut = jax.jit(lambda v, *a: pair.jmod.apply(v, *a, training=training,
                                                     mutable=['batch_stats']))(
        pair.var, *pair.inputs)
    pair.tmod.load_state_dict(pair.tmod.state_dict())
    pair.tmod.train(training)
    saved = {k: v.clone() for k, v in pair.tmod.state_dict().items()}
    with torch.no_grad():
        got = pair.tmod(*[_t(x) for x in pair.inputs])
    want = np.asarray(out)
    _close(got, want, 1e-5)
    new_valid = pair.inputs[3]
    assert (want[~new_valid] == 0).all() and (_np(got)[~new_valid] == 0).all()
    assert (np.abs(want[new_valid]).sum(-1) > 0).all()
    if training:
        sd = {}
        vector_pool_from_flax(sd, 'm', pair.var['params'],
                              jax.tree.map(np.asarray, mut['batch_stats']), LAYER)
        got_sd = pair.tmod.state_dict()
        names = [k for k in got_sd if k.endswith(('running_mean', 'running_var'))]
        assert len(names) == 2 * (2 * 3 + 1)
        for k in names:
            _close(got_sd[k], np.asarray(sd['m.' + k]), 1e-5, k)
            assert not torch.equal(got_sd[k], saved[k]), k
    pair.tmod.load_state_dict(saved)


def test_gradients_float64(pair):
    """Every parameter's and the features' gradient of a weighted sum of
    the training output, float64 on both sides."""
    inputs = _module_inputs(np.float64)
    rng = np.random.RandomState(3)
    weight = rng.randn(2, inputs[2].shape[1], 32)
    with jax.enable_x64(True):
        var = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), pair.var)

        def loss(params, feats):
            out, _ = pair.jmod.apply({'params': params, 'batch_stats': var['batch_stats']},
                                     *inputs[:4], feats, training=True, mutable=['batch_stats'])
            return (out * weight).sum()
        gp, gf = jax.jit(jax.grad(loss, argnums=(0, 1)))(var['params'], jnp.asarray(inputs[4]))
        gp, gf = jax.tree.map(np.asarray, gp), np.asarray(gf)
    mod = tvp.VectorPoolAggregationMSG(LAYER, C_IN).double()
    mod.load_state_dict(pair.tmod.state_dict())
    mod.train()
    feats = _t(inputs[4]).requires_grad_(True)
    (mod(*[_t(x) for x in inputs[:4]], feats) * _t(weight)).sum().backward()
    sd = {}
    vector_pool_from_flax(sd, 'm', gp, jax.tree.map(np.asarray, pair.var['batch_stats']), LAYER)
    checked = 0
    for name, p in mod.named_parameters():
        ref = np.asarray(sd['m.' + name])
        assert np.linalg.norm(_np(p.grad) - ref) <= 1e-9 * np.linalg.norm(ref), name
        checked += 1
    assert checked == 2 * (1 + 2 + 2 * 3) + 3
    assert np.linalg.norm(_np(feats.grad) - gf) <= 1e-9 * np.linalg.norm(gf)
    assert np.linalg.norm(gf) > 0


def test_flax_init_draws_kaiming_normal():
    """``flax_init`` on a vector pool: each local kernel a normal truncated at
    ±2 of its scale with Flax's std √(2 / (G·(3 + C))); Flax's own
    ``kaiming_normal`` at the same shape has that std too."""
    cfg = {**LAYER, 'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 64}
    mod = flax_init(tvp.VectorPoolAggregationMSG(cfg, C_IN), torch.Generator().manual_seed(0))
    for layer in mod.layers:
        w = layer.local_kernel.detach().numpy()
        g, c, _ = w.shape
        std = np.sqrt(2.0 / (g * c))
        scale = std / .87962566103423978
        assert np.abs(w).max() <= 2 * scale
        assert abs(w.std() / std - 1) < 0.05, (w.shape, w.std(), std)
        jw = np.asarray(jax.nn.initializers.kaiming_normal()(jax.random.PRNGKey(0), w.shape))
        assert abs(jw.std() / std - 1) < 0.05 and np.abs(jw).max() <= 2 * scale
    for bn in (mod.layers[0].local_bn[0], mod.msg_post_mlps[1]):
        assert (bn.weight == 1).all() and (bn.bias == 0).all()

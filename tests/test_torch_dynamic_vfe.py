"""The port's dynamic VFEs (``DynamicMeanVFE``, ``DynamicPillarVFE``) vs the
JAX package, from the same weights, on the cases of
``tests/test_dynamic_vfe.py``: one dense voxel of 40 points past the K cap
of 3 (the dynamic mean covers all 40), a voxel buffer smaller than the
frame's voxels (the points past it carry slot V and are dropped), invalid
(padded) points, and the pillar VFE's options (``USE_ABSLOTE_XYZ`` off,
``WITH_DISTANCE`` on, ``USE_NORM`` off, two layers) in eval and in training
(the BatchNorm's running statistics after the step too).

The batches come from the JAX voxelizer (and the port's ``voxelize_batch``
gives the same ``point_slot``); the Flax variables are drawn from a numpy
seed over ``jax.eval_shape`` of the init and moved with
``pillar_vfe_from_flax``.  Tolerances: the segment means within 1e-6 of
the largest |value| (the same additions in another order), the pillar
VFE's outputs, running statistics and parameter gradients within 1e-5 of
the tensor's largest |value| (f32, other summation orders; the training
BatchNorm's E[x²] − E[x]² cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.models.backbones_3d.vfe import DynamicMeanVFE as JMean
from crb_active_3ddet_tpu.models.backbones_3d.vfe import DynamicPillarVFE as JPillar
from crb_active_3ddet_tpu.ops import voxelize as jvx

from crb_active_3ddet_torch.models.backbones_3d.vfe import DynamicMeanVFE as TMean
from crb_active_3ddet_torch.models.backbones_3d.vfe import DynamicPillarVFE as TPillar
from crb_active_3ddet_torch.models.backbones_3d.vfe import build_vfe
from crb_active_3ddet_torch.ops.voxelize import voxelize_batch
from crb_active_3ddet_torch.utils.flax_weights import pillar_vfe_from_flax

from test_torch_second_eval import _fill

PCR = (0.0, -4.0, -2.0, 8.0, 4.0, 2.0)
VS = (0.5, 0.5, 4.0)
GRID = (16, 16, 1)
MEAN_TOL = 1e-6
VFE_TOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(seed, b=2, n=96):
    """(B, N, 4) points: 40 of frame 0 in one voxel, the rest spread, some
    out of the range; the last 10 of each frame padded (invalid)."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-0.5, 8.5, (b, n, 1)), rng.uniform(-4.5, 4.5, (b, n, 1)),
                          rng.uniform(-1.5, 1.5, (b, n, 1)), rng.rand(b, n, 1)], -1)
    pts[0, :40, 0] = rng.uniform(0.1, 0.4, 40)
    pts[0, :40, 1] = rng.uniform(0.1, 0.4, 40)
    valid = np.ones((b, n), bool)
    valid[:, -10:] = False
    pts[:, -10:] = 0.0
    return pts.astype(np.float32), valid


def _batch(seed, max_voxels=64, k=3):
    pts, valid = _points(seed)
    out = jax.vmap(lambda p, v: jvx.voxelize(p, v, jnp.asarray(PCR), jnp.asarray(VS), GRID,
                                             max_voxels, k))(jnp.asarray(pts),
                                                             jnp.asarray(valid))
    batch = {'points': pts, 'points_valid': valid,
             **{key: np.asarray(val) for key, val in out.items()}}
    port = voxelize_batch(torch.from_numpy(pts), torch.from_numpy(valid), PCR, VS, GRID,
                          max_voxels, k)
    for key in ('point_slot', 'voxel_valid', 'voxel_coords'):
        np.testing.assert_array_equal(port[key].numpy(), batch[key], err_msg=key)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


@pytest.mark.parametrize('max_voxels', [64, 12], ids=['all_voxels', 'past_the_buffer'])
def test_dynamic_mean_matches_jax(max_voxels):
    batch = _batch(0, max_voxels)
    slots = batch['point_slot']
    assert (slots == max_voxels).any() and (np.bincount(slots[0]) > 3).any()
    want = JMean(model_cfg={}, num_point_features=4).apply({}, dict(batch))['voxel_features']
    vfe = build_vfe({'NAME': 'DynMeanVFE'}, 4, VS, PCR)
    assert isinstance(vfe, TMean) and vfe.get_output_feature_dim() == 4
    got = vfe(_torch(batch))['voxel_features']
    _close(got, want, MEAN_TOL, 'voxel_features')
    dense = slots[0, 0]
    if max_voxels == 64:
        # the dense voxel's mean is over its 40 points, not the K cap's 3
        np.testing.assert_allclose(got[0, dense].numpy(), batch['points'][0, :40].mean(0),
                                   atol=1e-6)
    else:
        # the dense voxel lies past the full buffer: its points reach no voxel
        assert dense == 12 and batch['voxel_valid'].all()


PILLAR_CASES = {
    'published': {'NUM_FILTERS': [64, 64]},
    'one_layer': {'NUM_FILTERS': [16]},
    'relative_xyz': {'NUM_FILTERS': [16, 32], 'USE_ABSLOTE_XYZ': False},
    'with_distance': {'NUM_FILTERS': [16, 32], 'WITH_DISTANCE': True},
    'no_norm': {'NUM_FILTERS': [16, 32], 'USE_NORM': False},
}


def _pillar_pair(case, batch):
    cfg = {'NAME': 'DynPillarVFE', 'WITH_DISTANCE': False, 'USE_ABSLOTE_XYZ': True,
           'USE_NORM': True, **PILLAR_CASES[case]}
    jmod = JPillar(model_cfg=cfg, num_point_features=4, voxel_size=VS, point_cloud_range=PCR)
    shapes = jax.eval_shape(lambda r: jmod.init(r, dict(batch)), jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(1)), shapes)
    sd = {}
    pillar_vfe_from_flax(sd, {'vfe': var['params']}, {'vfe': var.get('batch_stats', {})})
    tmod = build_vfe(cfg, 4, VS, PCR)
    assert isinstance(tmod, TPillar)
    tmod.load_state_dict({k[len('vfe.'):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return jmod, var, tmod


@pytest.mark.parametrize('max_voxels', [64, 12], ids=['all_voxels', 'past_the_buffer'])
@pytest.mark.parametrize('case', sorted(PILLAR_CASES))
@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_dynamic_pillar_matches_jax(case, training, max_voxels):
    """Outputs (B, V, F), zero at the padded pillars; in training the
    BatchNorm running statistics after the step; the gradients of a
    weighted sum of the outputs at every parameter."""
    batch = _batch(2, max_voxels, k=1)
    jmod, var, tmod = _pillar_pair(case, batch)
    cot = np.random.RandomState(3).randn(2, max_voxels, PILLAR_CASES[case]['NUM_FILTERS'][-1])
    cot = cot.astype(np.float32)

    def jloss(params):
        v = {**var, 'params': params}
        if training:
            out, mutated = jmod.apply(v, dict(batch), training=True, mutable=['batch_stats'])
        else:
            out, mutated = jmod.apply(v, dict(batch), training=False), {}
        return (out['pillar_features'] * cot).sum(), (out['pillar_features'], mutated)
    (_, (want, mutated)), jgrads = jax.value_and_grad(jloss, has_aux=True)(var['params'])
    tmod.train(training)
    out = tmod(_torch(batch))['pillar_features']
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, VFE_TOL, 'pillar_features')
    assert (out.detach().numpy()[~batch['voxel_valid']] == 0).all()
    if max_voxels == 12:
        assert (batch['point_slot'] == 12).any()
    sd = {}
    pillar_vfe_from_flax(sd, {'vfe': jax.tree.map(np.asarray, jgrads)},
                         {'vfe': var.get('batch_stats', {})})
    for name, p in tmod.named_parameters():
        _close(p.grad, sd[f'vfe.{name}'], VFE_TOL, f'grad {name}')
    if training and 'batch_stats' in mutated:
        for i, layer in enumerate(tmod.pfn_layers):
            js = mutated['batch_stats'][f'BatchNorm_{i}']
            _close(layer.norm.running_mean, js['mean'], VFE_TOL, f'layer {i} mean')
            _close(layer.norm.running_var, js['var'], VFE_TOL, f'layer {i} var')
    assert ('batch_stats' in mutated) == (training and PILLAR_CASES[case].get('USE_NORM', True))

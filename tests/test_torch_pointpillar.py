"""The port's PointPillars vs the JAX package, from the same weights.

Modules: ``PillarVFE`` in eval and in training mode (its outputs and the
BatchNorm running statistics after one step) on pillars with padded points
and padded pillars, with ``USE_ABSLOTE_XYZ`` off, ``WITH_DISTANCE`` on, a
two-layer ``NUM_FILTERS`` [16, 32] (the concat branch) and ``USE_NORM`` off;
``PointPillarScatter``'s canvas and its gradient, exactly 0 at the invalid
pillars.

The slice: ``pointpillar_synth.yaml`` reduced to its published 0.16 m
pillars over a 12.8 × 12.8 m range (80×80), 32 points a pillar, a buffer of
1 024 pillars, BEV ``[1, 1, 1]`` at ``[16, 32, 64]``, NMS matrix 256, batch
2: the eval step and one f32 train step against the JAX ``make_eval_step``
and ``make_train_step``; ``flax_init`` against the JAX init; the entropy
scorer's records and one CRB query's picks on a 9-scene pool (4 labelled, a
pool of 5 at batch 2, as ``tests/test_torch_active.py`` and
``tests/test_torch_crb.py`` do for SECOND).  The Flax variables are made
from a numpy seed over ``jax.eval_shape`` of the JAX init (the cls bias at
0 for eval and the scorers, so that the NMS keeps boxes; at the focal prior
for training) and moved with ``flax_to_state_dict``.

Tolerances (f32, same formulas, other summation orders): the VFE's outputs
and running statistics within 1e-5 of the tensor's largest |value| (the
training BatchNorm's variance, E[x²] − E[x]² as Flax takes it, cancels, and
its rounding reaches 1e-4 of a small element; the largest reading is
3.4e-6); the scatter exactly; the
eval step's intermediate tensors, boxes and scores atol/rtol 1e-4, labels,
validity and recall counts exactly; the train step's loss terms rtol 1e-5,
every gradient ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7 and every updated parameter and BN
statistic within atol 1e-4; the scorer's floats rtol 1e-4 / atol 1e-5,
labels and validity exactly; the CRB picks equal.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.backbones_2d.map_to_bev import \
    PointPillarScatter as JScatter
from crb_active_3ddet_tpu.models.backbones_3d.vfe import PillarVFE as JPillarVFE
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models.backbones_2d.map_to_bev import \
    PointPillarScatter as TScatter
from crb_active_3ddet_torch.models.backbones_3d.vfe import PillarVFE as TPillarVFE
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init, init_weights
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.utils.flax_weights import (flax_to_state_dict,
                                                       pillar_vfe_from_flax)

from test_torch_second_eval import _fill

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/synthetic_models/pointpillar_synth.yaml'
ACTIVE_CFG = ROOT / 'tools/cfgs/synthetic_models/pointpillar_synth_active_entropy.yaml'
PCR = (0.0, -6.4, -3.0, 12.8, 6.4, 1.0)
VOXEL = (0.16, 0.16, 4.0)
TOL = dict(atol=1e-4, rtol=1e-4)
VFE_TOL = 1e-5         # of the tensor's largest |value|
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 40            # the train step's schedule length
LOSS_KEYS = ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss')
TRUNCATED = 2 / .87962566103423978      # lecun-normal's bound over its std


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """This module's torch ops run on one thread: its many small ops
    otherwise wait at every op's thread barrier when the suite's workers
    share the cores (as ``tests/test_torch_crb.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vfe_close(got, want, what):
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err <= VFE_TOL, (what, err)


# ---- PillarVFE ---------------------------------------------------------------

def _pillars(seed, b=2, v=24, k=8):
    """(B, V, K, 4) points in their pillars' cells, as the voxelizer lays
    them out: each pillar's first ``num`` points, zeros after; the last 5
    pillars of a frame padded (no point, invalid), others partly filled."""
    rng = np.random.RandomState(seed)
    num = rng.randint(1, k + 1, (b, v))
    num[:, -5:] = 0
    num[:, 0] = k
    cells = np.stack([rng.choice(80 * 80, v, replace=False) for _ in range(b)])
    cy, cx = cells // 80, cells % 80
    coords = np.stack([np.zeros_like(cy), cy, cx], -1).astype(np.int32)
    u = rng.uniform(0, 1, (b, v, k, 2))
    voxels = np.zeros((b, v, k, 4), np.float32)
    voxels[..., 0] = PCR[0] + (cx[..., None] + u[..., 0]) * VOXEL[0]
    voxels[..., 1] = PCR[1] + (cy[..., None] + u[..., 1]) * VOXEL[1]
    voxels[..., 2] = rng.uniform(-3, 1, (b, v, k))
    voxels[..., 3] = rng.uniform(0, 1, (b, v, k))
    voxels *= (np.arange(k) < num[..., None])[..., None]
    coords *= (num > 0)[..., None]
    return {'voxels': voxels, 'voxel_num_points': num.astype(np.int32),
            'voxel_coords': coords, 'voxel_valid': num > 0}


VFE_CASES = {
    'published': {'NUM_FILTERS': [64]},
    'relative_xyz': {'NUM_FILTERS': [64], 'USE_ABSLOTE_XYZ': False},
    'with_distance': {'NUM_FILTERS': [64], 'WITH_DISTANCE': True},
    'two_layers': {'NUM_FILTERS': [16, 32]},
    'no_norm': {'NUM_FILTERS': [64], 'USE_NORM': False},
}


def _vfe_pair(case):
    cfg = {'NAME': 'PillarVFE', 'WITH_DISTANCE': False, 'USE_ABSLOTE_XYZ': True,
           'USE_NORM': True, **VFE_CASES[case]}
    jmod = JPillarVFE(model_cfg=cfg, num_point_features=4, voxel_size=VOXEL,
                      point_cloud_range=PCR)
    batch = _pillars(1)
    # the JAX module writes its output into the dict it is given
    shapes = jax.eval_shape(lambda r: jmod.init(r, dict(batch)), jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
    stats = var.get('batch_stats', {})
    sd = {}
    pillar_vfe_from_flax(sd, {'vfe': var['params']}, {'vfe': stats})
    tmod = TPillarVFE(cfg, 4, VOXEL, PCR)
    tmod.load_state_dict({k[len('vfe.'):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return jmod, var, tmod, batch


@pytest.mark.parametrize('case', sorted(VFE_CASES))
@pytest.mark.parametrize('training', [False, True])
def test_pillar_vfe_matches_jax(case, training):
    """Outputs (B, V, F) and, after a training step, the BN running
    statistics; padded points and padded pillars included."""
    jmod, var, tmod, batch = _vfe_pair(case)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if training:
        jout, mutated = jmod.apply(var, dict(batch), training=True,
                                    mutable=['batch_stats'])
        tmod.train()
    else:
        jout, mutated = jmod.apply(var, dict(batch), training=False), {}
        tmod.eval()
    with torch.no_grad():
        tout = tmod(tbatch)
    want = np.asarray(jout['pillar_features'])
    assert tout['pillar_features'].shape == want.shape
    _vfe_close(tout['pillar_features'], want, 'pillar_features')
    # the padded pillars' features are relu(BN(0)) paths, not zero
    padded = ~batch['voxel_valid']
    assert np.abs(want[padded]).max() > 0 or VFE_CASES[case].get('USE_NORM') is False
    stats = mutated.get('batch_stats', {}).get('PFNLayer_0', None)
    if training and stats is not None:
        for i, layer in enumerate(tmod.pfn_layers):
            js = mutated['batch_stats'][f'PFNLayer_{i}']['BatchNorm_0']
            _vfe_close(layer.norm.running_mean, np.asarray(js['mean']), f'layer {i} mean')
            _vfe_close(layer.norm.running_var, np.asarray(js['var']), f'layer {i} var')
            old = var['batch_stats'][f'PFNLayer_{i}']['BatchNorm_0']['var']
            assert not np.array_equal(np.asarray(js['var']), old)
    assert (stats is not None) == (training and VFE_CASES[case].get('USE_NORM', True))


# ---- PointPillarScatter --------------------------------------------------------

def test_point_pillar_scatter_matches_jax():
    """The canvas exactly; the gradient at the pillar features exactly JAX's
    (its ``vjp``), and exactly 0 at the invalid pillars, whose coordinates
    here repeat valid pillars' cells."""
    rng = np.random.RandomState(3)
    b, v, c, nx, ny = 2, 12, 8, 7, 6
    feats = rng.randn(b, v, c).astype(np.float32)
    cells = np.stack([rng.choice(nx * ny, v, replace=False) for _ in range(b)])
    coords = np.stack([np.zeros_like(cells), cells // nx, cells % nx], -1).astype(np.int32)
    valid = np.ones((b, v), bool)
    valid[:, -4:] = False
    coords[:, -4:] = coords[:, :4]
    cfg = {'NAME': 'PointPillarScatter', 'NUM_BEV_FEATURES': c}
    jmod = JScatter(model_cfg=cfg, grid_size=(nx, ny, 1))

    def jcanvas(f):
        return jmod.apply({}, {'pillar_features': f, 'voxel_coords': coords,
                               'voxel_valid': valid})['spatial_features']
    want, vjp = jax.vjp(jcanvas, feats)
    cot = rng.randn(*want.shape).astype(np.float32)
    (jgrad,) = vjp(cot)
    tf = torch.from_numpy(feats).requires_grad_()
    out = TScatter(cfg, (nx, ny, 1))({'pillar_features': tf,
                                      'voxel_coords': torch.from_numpy(coords),
                                      'voxel_valid': torch.from_numpy(valid)})
    assert out['spatial_features_stride'] == 1
    np.testing.assert_array_equal(_np(out['spatial_features']), np.asarray(want))
    out['spatial_features'].backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(_np(tf.grad), np.asarray(jgrad))
    assert (_np(tf.grad)[~valid] == 0).all() and (_np(tf.grad)[valid] != 0).any()


# ---- the reduced pointpillar_synth.yaml ---------------------------------------

def _reduced(load):
    c = load(CFG)
    d = c.DATA_CONFIG
    d.POINT_CLOUD_RANGE = list(PCR)                     # 80×80 pillars of 0.16 m
    # 600 background points: 350-900 real pillars, the buffer partly padded
    d.NUM_SCENES, d.NUM_BG_POINTS, d.MAX_OBJECTS = 4, 600, 4
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = c.MODEL
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 256
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1, 1], [16, 32, 64]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16, 16]
    return c


def _geom(ds):
    return (ds.voxel_cfg, tuple(int(g) for g in ds.grid_size),
            tuple(float(x) for x in ds.point_cloud_range),
            tuple(float(v) for v in ds.voxel_size))


def _variables(jmodel, geom, host, cls_bias):
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                 training=False),
        jax.random.PRNGKey(0), jtrain.host_to_device_batch(host))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
    head = var['params']['dense_head']['conv_cls']
    head['bias'] = np.full_like(head['bias'], cls_bias)
    return var


class Pair:
    """The JAX and the port PointPillars of the reduced config, same weights
    (cls bias 0), same test batch: the JAX forward and the port's."""

    def __init__(self):
        jc, tc = _reduced(jload), _reduced(tload)
        self.jc, self.tc = jc, tc
        self.jset, self.jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2,
                                            workers=0, training=False)
        self.tset, self.tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2,
                                            workers=0, training=False)
        self.host = next(iter(self.tloader))
        self.geom = _geom(self.jset)
        self.jmodel = jdet(jc.MODEL, num_class=3, dataset=self.jset)
        self.variables = _variables(self.jmodel, self.geom, self.host, 0.0)
        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.variables['params'],
                                                       self.variables['batch_stats']))
        self.tmodel.eval()
        self.jbatch = jtrain.host_to_device_batch(self.host)
        self.jout = jax.jit(lambda v, h: self.jmodel.apply(
            v, jtrain.prepare_device_batch(h, *self.geom), training=False))(
                self.variables, self.jbatch)
        with torch.no_grad():
            self.tout = self.tmodel(ttrain.prepare_device_batch(
                ttrain.host_to_device_batch(self.host, 'cpu'), *self.geom))


@pytest.fixture(scope='module')
def pair():
    return Pair()


def test_model_builds_and_transfers(pair):
    """No 3D backbone; the state dict the Flax variables give is the
    model's, every Flax value moved, under OpenPCDet's PFN names."""
    assert pair.tmodel.module_topology == ('vfe', 'map_to_bev', 'backbone_2d', 'dense_head')
    assert not hasattr(pair.tmodel, 'backbone_3d')
    assert tuple(int(g) for g in pair.tset.grid_size) == (80, 80, 1)
    sd = flax_to_state_dict(pair.variables['params'], pair.variables['batch_stats'])
    assert set(sd) == set(pair.tmodel.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(pair.variables))
    assert n_flax == sum(v.numel() for k, v in sd.items()
                         if not k.endswith('num_batches_tracked'))
    assert {'vfe.pfn_layers.0.linear.weight', 'vfe.pfn_layers.0.norm.running_var'} <= set(sd)
    assert sd['vfe.pfn_layers.0.linear.weight'].shape == (64, 10)


def test_forward_matches_jax(pair):
    """The pillars (with padded points and pillars), the PFN output, the
    BEV canvas, the 2D backbone, the head's raw and decoded outputs."""
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid'):
        np.testing.assert_array_equal(_np(pair.tout[k]), _np(pair.jout[k]), err_msg=k)
    valid = _np(pair.tout['voxel_valid'])
    npts = _np(pair.tout['voxel_num_points'])
    assert (~valid).any() and (npts[valid] < 32).any()
    for k in ('pillar_features', 'spatial_features', 'spatial_features_2d', 'cls_preds',
              'box_preds', 'dir_cls_preds', 'batch_cls_preds', 'batch_box_preds'):
        np.testing.assert_allclose(_np(pair.tout[k]), _np(pair.jout[k]), **TOL, err_msg=k)
    assert pair.tout['spatial_features'].shape == (2, 80, 80, 64)
    assert pair.tout['batch_cls_preds'].shape == (2, 40 * 40 * 6, 3)


def test_eval_step_matches_jax(pair):
    """Port make_eval_step vs JAX make_eval_step on the same host batch."""
    jstep = jeval.make_eval_step(pair.jmodel, pair.jset, pair.jc.MODEL.POST_PROCESSING, 3)
    tstep = teval.make_eval_step(pair.tmodel, pair.tset, pair.tc.MODEL.POST_PROCESSING, 3)
    jp, jr = jstep(pair.variables, pair.jbatch)
    tp, tr = tstep(ttrain.host_to_device_batch(pair.host, 'cpu'))
    assert set(tp) == set(jp)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_array_equal(_np(tr[k]), _np(jr[k]), err_msg=k)
    live = (_np(torch.sigmoid(pair.tout['batch_cls_preds']).max(-1).values)
            >= float(pair.tc.MODEL.POST_PROCESSING.SCORE_THRESH)).sum(-1)
    kept = _np(tp['pred_valid']).sum(-1)
    assert np.all(kept > 0) and np.all(kept < live), (kept, live)


class TrainPair:
    """One f32 train step of each package from the same weights (cls bias at
    the focal prior) and the same host batch of the train split, with the
    JAX step's gradients beside it."""

    def __init__(self):
        jc, tc = _reduced(jload), _reduced(tload)
        jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=True)
        tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0,
                                  training=True)
        torch.manual_seed(0)
        np.random.seed(0)
        host = next(iter(tloader))
        geom = _geom(jset)
        jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
        var = _variables(jmodel, geom, host, -np.log((1 - 0.01) / 0.01))
        jbatch = jtrain.host_to_device_batch(host)

        def loss_fn(params):
            out, _ = jmodel.apply({'params': params, 'batch_stats': var['batch_stats']},
                                  jtrain.prepare_device_batch(jbatch, *geom),
                                  training=True, mutable=['batch_stats'])
            return jmodel.compute_loss(out)
        (_, jtb), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            var['params'])
        self.jtb = {k: float(jtb[k]) for k in LOSS_KEYS}
        self.jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads),
                                         var['batch_stats'])
        joptim, _ = jopt(jc.OPTIMIZATION, total_steps=STEPS)
        state = jtrain.TrainState(params=var['params'], batch_stats=var['batch_stats'],
                                  opt_state=joptim.init(var['params']),
                                  step=jax.numpy.asarray(0, jax.numpy.int32))
        state, m = jtrain.make_train_step(jmodel, joptim, jset)(
            state, jbatch, jax.random.PRNGKey(1))
        self.jmetrics = {k: float(m[k]) for k in LOSS_KEYS}
        self.jafter = flax_to_state_dict(jax.tree.map(np.asarray, state.params),
                                         jax.tree.map(np.asarray, state.batch_stats))

        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats']))
        self.before = {k: v.clone() for k, v in self.tmodel.state_dict().items()}
        optim, _ = topt(tc.OPTIMIZATION, STEPS, self.tmodel.parameters())
        update = optim.step

        def keep_grads_then_update():
            # the gradients as the backward left them (the clip scales in place)
            self.tgrads = {n: p.grad.clone() for n, p in self.tmodel.named_parameters()}
            update()
        optim.step = keep_grads_then_update
        _, m = ttrain.make_train_step(self.tmodel, optim, tset)(
            ttrain.init_train_state(self.tmodel, optim),
            ttrain.host_to_device_batch(host, 'cpu'))
        self.tmetrics = {k: float(m[k]) for k in LOSS_KEYS}
        self.tafter = {k: v.clone() for k, v in self.tmodel.state_dict().items()}


@pytest.fixture(scope='module')
def train_pair():
    return TrainPair()


def test_train_losses_match_jax(train_pair):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(train_pair.tmetrics[k], train_pair.jmetrics[k],
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(train_pair.jtb[k], train_pair.jmetrics[k], rtol=1e-6)
    assert train_pair.tmetrics['rpn_loss_loc'] > 0        # targets were assigned


def test_train_gradients_match_jax(train_pair):
    assert set(train_pair.tgrads) == set(train_pair.jgrads) - {
        k for k in train_pair.jgrads if k.endswith(('running_mean', 'running_var',
                                                     'num_batches_tracked'))}
    worst = 0.0
    for name, g in train_pair.tgrads.items():
        ref = train_pair.jgrads[name].numpy()
        d = np.linalg.norm(_np(g) - ref)
        worst = max(worst, d / (np.linalg.norm(ref) + 1e-30))
        assert d <= 1e-4 * np.linalg.norm(ref) + 1e-7, name
        assert np.linalg.norm(ref) > 0, name
    print(f'largest relative gradient difference {worst:.2e}')


def test_train_updates_match_jax(train_pair):
    """Every updated parameter and BN running statistic within 1e-4 of the
    JAX step's; each moved."""
    for name, v in train_pair.tafter.items():
        if name.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(_np(v), train_pair.jafter[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)
        assert not torch.equal(v, train_pair.before[name]), name


# ---- the init ----------------------------------------------------------------

def test_flax_init_matches_jax_init():
    """``flax_init`` against the JAX model's ``init`` (jitted): the same
    tensors, the PFN's Linear and BatchNorm included; BatchNorm terms and
    biases exactly; each kernel's std within 5/√n of JAX's and truncated
    where JAX's is.  Every parameter and buffer set (none left NaN), by
    ``flax_init`` and by ``init_weights`` alike (which keeps the cls bias
    the head was built with, its focal prior)."""
    jc, tc = _reduced(jload), _reduced(tload)
    jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=True)
    tset, _, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0, training=True)
    jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
    dummy = {'points': np.zeros((2, jset.data_processor.max_points_per_frame,
                                 jset.num_point_features), np.float32),
             'num_points': np.full((2,), 16, np.int32),
             'gt_boxes': np.zeros((2, jset.max_gt_boxes, 8), np.float32)}
    geom = _geom(jset)
    var = jax.jit(lambda r, h: jmodel.init(
        {'params': r, 'dropout': r}, jtrain.prepare_device_batch(h, *geom),
        training=True))(jax.random.PRNGKey(0), dummy)
    want = flax_to_state_dict(jax.tree.map(np.asarray, var['params']),
                              jax.tree.map(np.asarray, var['batch_stats']))
    for init in (flax_init, init_weights):
        model = tdet(tc.MODEL, num_class=3, dataset=tset, device='cpu')
        keep = model.dense_head.conv_cls.bias
        prior = keep.detach().clone()
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                if t.is_floating_point() and (t is not keep or init is flax_init):
                    t.fill_(float('nan'))
        got = init(model, torch.Generator().manual_seed(0)).state_dict()
        assert set(got) == set(want)
        assert all(bool(torch.isfinite(v).all()) for v in got.values()), init.__name__
        assert torch.equal(got['dense_head.conv_cls.bias'], prior)
    model = flax_init(tdet(tc.MODEL, num_class=3, dataset=tset, device='cpu'),
                      torch.Generator().manual_seed(0))
    got = model.state_dict()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith(('.bias', 'running_mean', 'running_var', 'num_batches_tracked')) \
                or w.ndim == 1:
            assert torch.equal(g, w), k
            continue
        sg, sw = g.std().item(), w.std().item()
        assert abs(sg / sw - 1) < 5 / np.sqrt(w.numel()), (k, sg, sw)
        truncated = w.abs().max().item() <= TRUNCATED * sw * 1.1
        assert (g.abs().max().item() <= TRUNCATED * sg * 1.1) == truncated, k
    assert want['dense_head.conv_cls.bias'].min() < -4.5      # the focal prior


# ---- the entropy scorer and a CRB query on a 9-scene pool ---------------------

def _cfg(load, method):
    """The reduced PointPillars over 9 scenes with the AL config's
    ACTIVE_TRAIN: 4 labelled frames, rounds of 2."""
    c = _reduced(load)
    c.DATA_CONFIG.NUM_SCENES = 9
    c.ACTIVE_TRAIN = load(ACTIVE_CFG).ACTIVE_TRAIN
    a = c.ACTIVE_TRAIN
    a.METHOD = method
    a.PRE_TRAIN_SAMPLE_NUMS, a.SELECT_NUMS, a.TOTAL_BUDGET_NUMS = 4, 2, 4
    return c


class Pool:
    """The JAX and the port model over one active split, same weights (cls
    bias 0)."""

    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload, 'crb'), _cfg(tload, 'crb')
        jlab_set, _, self.jlab, self.junlab, _, _ = jactive(
            self.jc.DATA_CONFIG, self.jc.CLASS_NAMES, 2, workers=0, training=True,
            pre_train_sample_nums=4, seed=0)
        tlab_set, _, self.tlab, self.tunlab, _, _ = tactive(
            self.tc.DATA_CONFIG, self.tc.CLASS_NAMES, 2, workers=0, training=True,
            pre_train_sample_nums=4, seed=0)
        self.jmodel = jdet(self.jc.MODEL, num_class=3, dataset=jlab_set)
        self.variables = _variables(self.jmodel, _geom(jlab_set),
                                    next(iter(self.tunlab)), 0.0)
        self.tmodel = tdet(self.tc.MODEL, num_class=3, dataset=tlab_set, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.variables['params'],
                                                       self.variables['batch_stats']))
        self.tmodel.eval()
        self.tmp = str(tmp)

    def strategies(self, method):
        return (jstrategy(method, self.jmodel, self.variables, self.jlab, self.junlab, 0,
                          self.tmp, self.jc),
                tstrategy(method, self.tmodel, self.tlab, self.tunlab, 0, self.tmp,
                          self.tc))


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    return Pool(tmp_path_factory.mktemp('pointpillar_pool'))


def test_entropy_scorer_matches_jax(pool):
    """Every signal of every pool frame (the last batch wrap-padded)."""
    jstrat, tstrat = pool.strategies('entropy')
    assert jstrat.mesh is None
    jrec, trec = jstrat.scan_pool(signals=None), tstrat.scan_pool(signals=None)
    assert list(trec) == [str(f) for f in jrec] and len(trec) == 5
    for fid in trec:
        j = jrec[fid]
        assert set(trec[fid]) == set(j)
        for k in ('box_entropy', 'label_entropy', 'confidence_entropy', 'pred_density'):
            np.testing.assert_allclose(trec[fid][k], np.asarray(j[k]), **FLOAT_TOL,
                                       err_msg=f'{fid} {k}')
        np.testing.assert_allclose(trec[fid]['embeddings'], np.asarray(j['embeddings']),
                                   rtol=1e-4, atol=1e-4, err_msg=fid)
        for k in ('pred_labels', 'pred_valid', 'num_bbox', 'median_points'):
            np.testing.assert_array_equal(trec[fid][k], np.asarray(j[k]),
                                          err_msg=f'{fid} {k}')
        for k in ('mean_points', 'variance_points'):
            np.testing.assert_allclose(trec[fid][k], np.asarray(j[k]), rtol=1e-6,
                                       err_msg=f'{fid} {k}')
    kept = [int(r['pred_valid'].sum()) for r in trec.values()]
    assert min(kept) > 0 and np.ptp([float(r['box_entropy']) for r in trec.values()]) > 0


def test_crb_query_picks_the_jax_ids(pool):
    """One unpatched CRB query of each package (MC scan, stage-2 gradients of
    ``conv_cls``, k-means++, GPDB): the same frames; the port's buffers and
    parameters as before."""
    jstrat, tstrat = pool.strategies('crb')
    before = {k: v.clone() for k, v in pool.tmodel.state_dict().items()}
    want = [str(f) for f in jstrat.query(cur_epoch=0)]
    got = tstrat.query(cur_epoch=0)
    assert got == want and len(set(got)) == 2
    after = pool.tmodel.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(m.training for m in pool.tmodel.modules())

"""The port's PV-RCNN train step vs the JAX package, from the same weights,
the same host batch and the same RoI targets.

The reduced PV-RCNN of ``tests/test_torch_pvrcnn_eval.py`` (128×128×40 grid,
narrow widths, 256 keypoints, a 4³ RoI grid, batch 2, f32) on the train
split, with the TRAIN proposal NMS cut to 128 → 32 boxes (MATRIX_CAP 128),
``ROI_PER_IMAGE`` 16 and ``DP_RATIO`` 0 for the parity step.  The Flax
variables are made from a numpy seed and moved into the port with
``utils/flax_weights.py``.

The RoI sampler draws: the JAX package from its key, the port from a
``torch.Generator``, so no two draws agree.  The parity step therefore runs
both packages from one set of targets: 32 proposals a frame made from the
batch's gt boxes (8 jittered copies, foreground; 8 shifted copies, hard
background; 12 random boxes; 4 all-zero padded rows with ``roi_valid``
False), sampled by the JAX ``assign_targets`` with a fixed key, then given
to both models as ``rois`` and ``roi_targets_dict`` (the JAX head's branch
for precomputed RoIs).  One jitted JAX program (the only model compile of
the file) runs the JAX ``train_step``'s body: ``model.apply`` in training,
``compute_loss``, ``jax.value_and_grad``, the optax update, and the
per-frame ``reduce=False`` losses.  It also taps the detector's stages
(``vfe``, ``backbone_3d``, ..., ``roi_head``, each a dict in, a dict out):
a Flax method interceptor adds a zero to every float entry of each stage's
output, so that the gradient with respect to those zeros is the loss's
gradient at that stage's outputs, and keeps the outputs.  The port runs its
own ``make_train_step`` on the same inputs, and each of its stages again on
the JAX step's inputs to that stage with the JAX gradient at its outputs.
The sampler itself is held to its contract against the JAX one, and its
gather is held to the JAX targets from the JAX draw ``sel``.

Tolerances (f32, the same formulas, other summation orders):
  * each loss term and each per-frame loss: rtol 1e-5;
  * the gradient of every parameter ahead of the grouped max-pools (dense
    head, BEV backbone, the RoI head's FC tower), from the whole step:
    ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7;
  * behind them (sparse backbone, pfe, point head, RoI-grid pool) the whole
    steps part by up to ~1e-2 in norm: a max over a group routes the
    gradient to its argmax, and the two forwards differ by ~1e-5
    (summation order), which flips the argmax of near-tied slots (the JAX
    gradients there lie up to ~1e-2 from the exact f64 one of the same
    forward, the port's within 6e-5).  So every parameter's gradient is
    held stage by stage: each port stage, run on the JAX step's inputs to
    it with the JAX step's gradient at its outputs, gives its parameters'
    gradients and its inputs' gradients within 1e-4·‖ref‖ + 1e-7 of the
    JAX step's, and the port's compute_loss gives the JAX gradient at the
    last stage's outputs; the stages' input gradients chain them into the
    whole step.  The port's own whole-step f32 gradient is also held
    within 1e-4 of its f64 gradient from the same weights, batch and
    targets (a check of the port alone);
  * BN running statistics after the step: atol 1e-5;
  * updated parameters: atol 1e-5 wherever both clipped |g| ≥ 1e-5 and
    the two gradients agree in sign (Adam's first step is about
    lr·sign(g) where |g| ≫ eps = 1e-8); the other entries within 2·lr
    (two gradients of opposite signs move a weight 2·lr apart).  Entries
    of opposite signs (both |g| ≥ 1e-5) lie behind the max-pools only, at
    most 0.2 % of their entries, each |g| within 5e-3 of its parameter's
    largest (read: 61 of 737 121 entries, each within 1.05e-3; 298 before
    the stage taps entered the JAX program, which moved its rounding);
  * the TRAIN proposal layer, the sample's slot counts, the integer
    targets and the point labels: exactly.
"""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.point_heads import point_head_simple as jphs
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt
from crb_active_3ddet_tpu.utils import loss_utils as jloss

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models import flax_layers
from crb_active_3ddet_torch.models.backbones_3d import pfe as pfe_module
from crb_active_3ddet_torch.models.backbones_3d.pfe import run_pointwise
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import init_weights
from crb_active_3ddet_torch.models.detectors.detector3d import _DRAWS
from crb_active_3ddet_torch.models.point_heads import point_head_simple as tphs
from crb_active_3ddet_torch.models.roi_heads import roi_head_template as trht
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.utils import loss_utils as tloss
from crb_active_3ddet_torch.utils.flax_weights import (flax_to_state_dict,
                                                       optax_to_optimizer_state)

from test_torch_pvrcnn_eval import _fill
from test_torch_pvrcnn_eval import _reduced as _reduced_eval

STEPS = 40            # the schedule's length
# parameters whose gradient reaches them through a grouped max-pool (the
# SA modules of the pfe and the RoI-grid pool)
BEHIND_MAX_POOL = ('backbone_3d.', 'pfe.', 'point_head.', 'roi_head.roi_grid_pool_layer.')
LOSS_KEYS = ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss', 'point_loss',
             'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'loss')
TARGET_KEYS = ('rois', 'roi_labels', 'roi_scores', 'gt_iou_of_rois',
               'gt_of_rois', 'gt_of_rois_src', 'reg_valid_mask', 'rcnn_cls_labels')
# updated entries whose two gradients differ in sign: their share of the
# entries behind the max-pools, and each |g| over its parameter's largest
SIGN_FLIPS = {'share': 2e-3, 'size': 5e-3}


def _reduced(load, dp=0.0):
    c = _reduced_eval(load)
    r = c.MODEL.ROI_HEAD
    r.DP_RATIO = dp
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 128
    r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
    r.NMS_CONFIG.TRAIN.MATRIX_CAP = 128
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return c


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _path(keys):
    return tuple(getattr(k, 'key', getattr(k, 'idx', None)) for k in keys)


def _jax_leaves(tree):
    """{path: leaf} of a JAX pytree, a path being the tuple of dict keys
    and sequence indices."""
    return {_path(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _is_float(v):
    return hasattr(v, 'dtype') and jnp.issubdtype(v.dtype, jnp.floating)


def apply_stages(jmodel, variables, batch, zeros=None):
    """``jmodel.apply`` in training with each stage of the detector (the
    modules one level down, called with the batch dict) intercepted: its
    output's float entries get ``zeros[stage][path]`` added, when given,
    and a copy of the output is kept.  Returns (out, mutated, {stage:
    output})."""
    outs = {}

    def tap(next_fun, args, kwargs, context):
        if context.method_name != '__call__' or len(context.module.path) != 1:
            return next_fun(*args, **kwargs)
        stage = context.module.path[0]
        out = next_fun(*args, **kwargs)
        if zeros is not None:
            add = zeros[stage]
            out = jax.tree_util.tree_map_with_path(
                lambda p, v: v + add[_path(p)] if _path(p) in add else v, out)
        outs[stage] = jax.tree_util.tree_map(lambda v: v, out)   # a copy of the dicts
        return out
    with fnn.intercept_methods(tap):
        out, mutated = jmodel.apply(variables, batch, training=True,
                                    mutable=['batch_stats'])
    return out, mutated, outs


def _walk(x, pre=()):
    """(path, leaf) of a nested dict/list/tuple of the port."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _walk(v, pre + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _walk(v, pre + (i,))
    else:
        yield pre, x


def _rebuild(x, leaf, pre=()):
    """``x`` with each leaf replaced by ``leaf(path, value)``."""
    if isinstance(x, dict):
        return {k: _rebuild(v, leaf, pre + (k,)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v, leaf, pre + (i,)) for i, v in enumerate(x))
    return leaf(pre, x)


def make_proposals(gt_boxes, rng, per_frame=32):
    """RoIs a frame from the frame's valid gts: 8 jittered copies (IoU
    above the fg threshold), 8 shifted copies (hard background), 12 random
    boxes and 4 all-zero padded rows with roi_valid False; labels of the
    gt's class for the copies, random for the rest."""
    b = gt_boxes.shape[0]
    rois = np.zeros((b, per_frame, 7), np.float32)
    labels = np.zeros((b, per_frame), np.int32)
    for f in range(b):
        gt = gt_boxes[f][np.abs(gt_boxes[f]).sum(-1) > 0]
        pick = rng.randint(0, len(gt), 16)
        src = gt[pick]
        rois[f, :16] = src[:, :7]
        rois[f, :8, :3] += rng.uniform(-0.05, 0.05, (8, 3)) * src[:8, 3:6]
        rois[f, :8, 6] += rng.uniform(-0.1, 0.1, 8)
        rois[f, 8:16, 0] += rng.choice([-1, 1], 8) * rng.uniform(0.3, 0.5, 8) * src[8:, 3]
        labels[f, :16] = src[:, 7]
        rois[f, 16:28, :2] = rng.uniform([0.5, -2.7], [5.9, 2.7], (12, 2))
        rois[f, 16:28, 2] = rng.uniform(-2, 0, 12)
        rois[f, 16:28, 3:6] = rng.uniform(0.5, 4, (12, 3))
        rois[f, 16:28, 6] = rng.uniform(-np.pi, np.pi, 12)
        labels[f, 16:28] = rng.randint(1, 4, 12)
    valid = np.zeros((b, per_frame), bool)
    valid[:, :28] = True
    return {'rois': rois, 'roi_labels': labels,
            'roi_scores': rng.randn(b, per_frame).astype(np.float32) * valid,
            'roi_valid': valid, 'gt_boxes': gt_boxes}


class TrainPair:
    """JAX and port PV-RCNN of one config, same weights, same host batch,
    same RoI targets; one train step on each, then a second step, each
    from the JAX state before it."""

    def __init__(self):
        jc, tc = _reduced(jload), _reduced(tload)
        self.tc, self.jc = tc, jc
        jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0,
                            training=True)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2,
                                       workers=0, training=True)
        torch.manual_seed(0)
        np.random.seed(0)
        self.host = next(iter(tloader))
        jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
        geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
                tuple(float(x) for x in jset.point_cloud_range),
                tuple(float(v) for v in jset.voxel_size))
        self.geom = geom
        jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                     training=False),
            jax.random.PRNGKey(0), jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)),
                                               shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.full_like(head['bias'], -np.log((1 - 0.01) / 0.01))
        self.var = var

        # the proposals, the JAX sample of them (a fixed key) and its draw
        self.proposals = make_proposals(self.host['gt_boxes'], np.random.RandomState(1))
        sampler = jc.MODEL.ROI_HEAD.TARGET_CONFIG
        key = jax.random.PRNGKey(5)

        @jax.jit
        def sample(props):
            t = jrht.assign_targets(key, dict(props), sampler)
            gt = props['gt_boxes']
            mo, ga = jax.vmap(jrht.get_max_iou_with_same_class)(
                props['rois'], props['roi_labels'], gt, gt[..., -1].astype(jnp.int32),
                jnp.abs(gt).sum(-1) > 0)
            sel, _ = jax.vmap(lambda k, m, v: jrht.subsample_rois(k, m, v, sampler))(
                jax.random.split(key, gt.shape[0]), mo, props['roi_valid'])
            return t, mo, ga, sel
        self.jtargets, self.j_overlaps, self.j_assignment, self.j_sel = jax.tree.map(
            np.asarray, sample(self.proposals))

        joptim, _ = jopt(jc.OPTIMIZATION, total_steps=STEPS)
        nms_train = jc.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN

        def batch_of(host, targets):
            return {**jtrain.prepare_device_batch(host, *geom),
                    'rois': targets['rois'], 'roi_targets_dict': dict(targets)}
        # a zero for every float entry of every stage's output (traced, not
        # compiled)
        _, _, stage_shapes = jax.eval_shape(
            lambda v, h, t: apply_stages(jmodel, v, batch_of(h, t)), var, jbatch,
            self.jtargets)
        zeros = {stage: {p: np.zeros(v.shape, v.dtype)
                         for p, v in _jax_leaves(out).items() if _is_float(v)}
                 for stage, out in stage_shapes.items()}

        @jax.jit
        def jstep(params, batch_stats, opt_state, host, targets, zeros):
            """The JAX train_step's body (runtime/train.py:96-118) with the
            RoIs and their targets given, and what the tests read: among it
            each stage's output and the loss's gradient there."""
            batch = batch_of(host, targets)

            def loss_fn(p, z):
                out, mutated, stages = apply_stages(
                    jmodel, {'params': p, 'batch_stats': batch_stats}, batch, z)
                loss, tb = jmodel.compute_loss(out)
                return loss, (tb, mutated, out, stages)
            (_, (tb, mutated, out, stages)), (grads, at_stages) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(params, zeros)
            _, per_frame = jmodel.compute_loss(out, reduce=False)
            updates, new_opt = joptim.update(grads, opt_state, params)
            new_params = optax.apply_updates(params, updates)
            props = jrht.proposal_layer(
                {'batch_box_preds': out['batch_box_preds'],
                 'batch_cls_preds': out['batch_cls_preds']}, nms_train, 1)
            keep = ('batch_box_preds', 'batch_cls_preds', 'point_coords',
                    'point_coords_valid', 'point_cls_labels', 'gt_boxes',
                    'multi_scale_3d_features')
            stages = {stage: {p: v for p, v in _jax_leaves(o).items() if hasattr(v, 'dtype')}
                      for stage, o in stages.items()}
            return (tb, per_frame, grads, new_params, mutated['batch_stats'], new_opt,
                    {k: out[k] for k in keep},
                    {k: props[k] for k in ('rois', 'roi_labels', 'roi_valid')},
                    stages, at_stages)

        opt0 = joptim.init(var['params'])
        self.jstates = [(var['params'], var['batch_stats'], opt0)]
        self.jruns = []
        for _ in range(2):
            params, stats, opt = self.jstates[-1]
            r = jax.tree.map(np.asarray, jstep(params, stats, opt, jbatch,
                                               self.jtargets, zeros))
            self.jruns.append(r)
            self.jstates.append((r[3], r[4], r[5]))
        (tb, per_frame, grads, _, _, _, self.jout, self.jprops, self.jstages,
         self.jstage_grads) = self.jruns[0]
        self.jtb = {k: float(v) for k, v in tb.items()}
        self.jper = {k: np.asarray(v) for k, v in per_frame.items()}
        self.jgrads = flax_to_state_dict(grads, var['batch_stats'], tc.MODEL)

        # the port: the same step from the same weights and targets
        self.tmodel = self.port_model(0)
        self.before = {k: v.clone() for k, v in self.tmodel.state_dict().items()}
        optim, self.schedule = topt(tc.OPTIMIZATION, STEPS, self.tmodel.parameters())
        self.tb, self.per, self.tgrads, self.tout = self.port_step(self.tmodel, optim)
        self.tafter = {k: v.clone() for k, v in self.tmodel.state_dict().items()}
        self.clip = float(tc.OPTIMIZATION.GRAD_NORM_CLIP)

    def state_dict_of(self, i):
        """The JAX state after ``i`` steps as a port state_dict."""
        params, stats, _ = self.jstates[i]
        return flax_to_state_dict(params, stats, self.tc.MODEL)

    def port_model(self, i):
        model = tdet(self.tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        model.load_state_dict(self.state_dict_of(i))
        return model

    def batch_with_targets(self, dtype=torch.float32):
        """The prepared batch with the JAX targets given as ``rois`` and
        ``roi_targets_dict``, its floats in ``dtype``."""
        batch = ttrain.prepare_device_batch(
            ttrain.host_to_device_batch(self.host, 'cpu'), *self.geom)
        targets = {k: _t(v) for k, v in self.jtargets.items()}
        batch.update(rois=targets['rois'], roi_targets_dict=targets)

        def cast(d):
            return {k: cast(v) if isinstance(v, dict) else
                    v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point()
                    else v for k, v in d.items()}
        batch = cast(batch)
        batch['rois'] = batch['roi_targets_dict']['rois']
        return batch

    def f64_grads(self):
        """The port's first-step gradients in f64 (the voxel centres too)
        from the same weights, batch and targets: the exact gradient of
        the port's forward, up to f64 rounding."""
        if not hasattr(self, '_g64'):
            model = self.port_model(0).double()
            model.train()
            centers = pfe_module.get_voxel_centers
            with mock.patch.object(pfe_module, 'get_voxel_centers',
                                   lambda *a: centers(*a).double()):
                loss, _ = model.compute_loss(model(self.batch_with_targets(torch.float64)))
            loss.backward()
            self._g64 = {n: p.grad.numpy() for n, p in model.named_parameters()}
        return self._g64

    def port_step(self, model, optim):
        """The port's ``make_train_step`` on the host batch with the JAX
        targets given (``rois`` and ``roi_targets_dict``): (loss terms,
        per-frame losses, gradients before the clip, the forward's
        output), the last two read as the step runs."""
        seen = {}
        hook = model.register_forward_hook(lambda m, args, out: seen.update(out=out))
        update = optim.step

        def step():
            seen['grads'] = {n: p.grad.clone() for n, p in model.named_parameters()}
            update()
        targets = {k: _t(v) for k, v in self.jtargets.items()}
        batch = {**ttrain.host_to_device_batch(self.host, 'cpu'),
                 'rois': targets['rois'], 'roi_targets_dict': targets}
        with mock.patch.object(optim, 'step', step):
            _, tb = ttrain.make_train_step(model, optim, self.tset)(
                ttrain.init_train_state(model, optim), batch,
                torch.Generator().manual_seed(0))
        hook.remove()
        with torch.no_grad():
            _, per = model.compute_loss(seen['out'], reduce=False)
        return ({k: float(v) for k, v in tb.items()},
                {k: _np(v) for k, v in per.items()}, seen['grads'], seen['out'])

    def stage_gradients(self):
        """Each port stage after the first run on the JAX step's inputs to
        it (the previous stage's output; its float tensors as leaves), then
        backward from the JAX step's gradient at its outputs; the port's
        compute_loss likewise on the last stage's output.  Returns
        ({parameter: gradient}, {(stage, path): (the port's gradient of
        that input, the JAX step's)})."""
        if hasattr(self, '_stage_grads'):
            return self._stage_grads
        gen = torch.Generator().manual_seed(0)

        def run(model, stage, x):
            module = getattr(model, stage)
            return module(x, gen) if stage in _DRAWS else module(x)
        model = self.port_model(0)
        model.train()
        topology = list(model.module_topology)
        own, x = {}, self.batch_with_targets()      # the port's inputs: keys, dtypes
        with torch.no_grad():
            for stage in topology:
                own[stage] = _rebuild(x, lambda p, v: v)
                x = run(model, stage, x)
        own['loss'] = x
        model = self.port_model(0)                  # statistics as before the step
        model.train()
        params, inputs = {}, {}
        for before, stage in zip(topology, topology[1:] + ['loss']):
            jin, leaves = self.jstages[before], {}

            def take(path, v):
                if not isinstance(v, torch.Tensor):
                    return v
                assert path in jin, (stage, path)   # every input tensor from JAX
                t = _t(jin[path]).to(v.dtype)
                if t.is_floating_point():
                    leaves[path] = t.requires_grad_(True)
                return t
            x = _rebuild(own[stage], take)
            if stage == 'loss':
                model.compute_loss(x)[0].backward()
            else:
                at = self.jstage_grads[stage]
                outs = [(p, v) for p, v in _walk(run(model, stage, x))
                        if isinstance(v, torch.Tensor) and v.requires_grad]
                assert all(p in at for p, _ in outs), stage
                torch.autograd.backward([v for _, v in outs],
                                        [_t(at[p]).to(v.dtype) for p, v in outs])
                for n, prm in getattr(model, stage).named_parameters():
                    params[f'{stage}.{n}'] = (np.zeros(tuple(prm.shape), np.float32)
                                              if prm.grad is None else _np(prm.grad))
            for p, t in leaves.items():
                ref = self.jstage_grads[before][p]
                inputs[(stage, p)] = (np.zeros_like(ref) if t.grad is None
                                      else _np(t.grad), ref)
        self._stage_grads = params, inputs
        return self._stage_grads


@pytest.fixture(scope='module')
def pair():
    return TrainPair()


def _clip_factor(pair):
    norm = np.sqrt(sum(float(np.sum(pair.jgrads[k].double().numpy() ** 2))
                       for k in pair.tgrads))
    return min(1.0, pair.clip / norm)


def test_losses_match_f32(pair):
    """Every loss term, and every per-frame loss of ``reduce=False``."""
    assert set(pair.tb) == set(pair.jtb) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(pair.tb[k], pair.jtb[k], rtol=1e-5, err_msg=k)
        assert pair.tb[k] > 0, k            # every head has targets of its own
    assert set(pair.per) == set(pair.jper)
    for k, v in pair.per.items():
        assert v.shape == (2,), k
        np.testing.assert_allclose(v, pair.jper[k], rtol=1e-5, err_msg=k)


def test_gradients_match_f32(pair):
    """Ahead of the grouped max-pools: within 1e-4 of the JAX gradient."""
    assert set(pair.tgrads) == set(n for n, _ in pair.tmodel.named_parameters())
    worst, n = 0.0, 0
    for name, g in pair.tgrads.items():
        ref = pair.jgrads[name].numpy()
        assert np.linalg.norm(ref) > 0, name          # every parameter learns
        if name.startswith(BEHIND_MAX_POOL):
            continue
        d = np.linalg.norm(_np(g) - ref)
        worst = max(worst, d / (np.linalg.norm(ref) + 1e-30))
        assert d <= 1e-4 * np.linalg.norm(ref) + 1e-7, name
        n += 1
    assert n == 6 + 18 + 22                 # dense head, BEV backbone, RoI tower
    print(f'{n} parameters ahead of the max-pools, largest relative gradient '
          f'difference {worst:.2e}')


def test_gradients_behind_the_max_pools(pair):
    """Every parameter, stage by stage: the port's stage on the JAX step's
    inputs to it, with the JAX step's gradient at its outputs, within 1e-4
    of the JAX step's gradient (the parameters behind the max-pools are
    held only so; module docstring).  Also the port's whole f32 step within
    1e-4 of its own f64 gradient behind them (the port alone)."""
    params, _ = pair.stage_gradients()
    assert set(params) == set(pair.tgrads)
    worst = {True: (0.0, ''), False: (0.0, '')}
    for name, g in params.items():
        ref = pair.jgrads[name].numpy()
        d = np.linalg.norm(g - ref)
        assert d <= 1e-4 * np.linalg.norm(ref) + 1e-7, (name, d / np.linalg.norm(ref))
        behind = name.startswith(BEHIND_MAX_POOL)
        worst[behind] = max(worst[behind], (d / np.linalg.norm(ref), name))
    n_behind = sum(1 for n in params if n.startswith(BEHIND_MAX_POOL))
    assert n_behind == len(params) - (6 + 18 + 22)
    g64, own = pair.f64_grads(), 0.0
    for name, g in pair.tgrads.items():
        if name.startswith(BEHIND_MAX_POOL):
            e = g64[name]
            d = np.linalg.norm(_np(g) - e)
            assert d <= 1e-4 * np.linalg.norm(e) + 1e-7, (name, d / np.linalg.norm(e))
            own = max(own, d / np.linalg.norm(e))
    print(f'stage by stage vs JAX, largest ||g - g_jax|| / ||g_jax||: behind the '
          f'max-pools {worst[True][0]:.2e} ({worst[True][1]}, {n_behind} parameters), '
          f'ahead {worst[False][0]:.2e} ({worst[False][1]}); the port\'s whole step vs '
          f'its f64 gradient behind them {own:.2e}')


def test_point_branch_gradient_follows_its_inputs(pair):
    """The stages chain into the whole step: each port stage's gradients
    with respect to its inputs (the JAX step's inputs to it), and the port
    compute_loss's with respect to the last stage's outputs, within 1e-4 of
    the JAX step's gradients at those tensors.  Among them, non-zero: the
    point branch's inputs from the sparse backbone, the keypoint features
    into the point head and the RoI-grid pool, the point scores that weight
    the keypoints there, and the heads' predictions into the losses.  A
    detach placed otherwise than the JAX package's stop_gradient breaks
    this chain."""
    _, inputs = pair.stage_gradients()
    worst = (0.0, None)
    for key, (got, ref) in inputs.items():
        d = np.linalg.norm(got - ref)
        assert d <= 1e-4 * np.linalg.norm(ref) + 1e-7, (key, d / np.linalg.norm(ref))
        if d > worst[0] * np.linalg.norm(ref):
            worst = (d / np.linalg.norm(ref), key)
    live = [('backbone_3d', ('voxel_features',)),
            ('pfe', ('multi_scale_3d_features', 'x_conv3', 'features')),
            ('pfe', ('multi_scale_3d_features', 'x_conv4', 'features')),
            ('pfe', ('spatial_features',)), ('backbone_2d', ('spatial_features',)),
            ('point_head', ('point_features_before_fusion',)),
            ('roi_head', ('point_features',)), ('roi_head', ('point_cls_scores',)),
            ('loss', ('cls_preds',)), ('loss', ('box_preds',)),
            ('loss', ('point_cls_preds',)), ('loss', ('roi_targets', 'rcnn_cls')),
            ('loss', ('roi_targets', 'rcnn_reg'))]
    for key in live:
        got, ref = inputs[key]
        assert np.linalg.norm(ref) > 0 and np.linalg.norm(got) > 0, key
    print(f'{len(inputs)} stage inputs, largest ||g - g_jax|| / ||g_jax|| '
          f'{worst[0]:.2e} ({worst[1]})')


def test_batch_stats_match_f32(pair):
    """Every BN running statistic after the step, the point branch's (Flax
    statistics over all leading axes, no mask) included."""
    ref = pair.state_dict_of(1)
    n = 0
    for name, v in pair.tafter.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(_np(v), ref[name].numpy(), atol=1e-5,
                                       err_msg=name)
            assert not torch.equal(v, pair.before[name]), name
            n += 1
    n_bn = sum(1 for m in pair.tmodel.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))
    assert n == 2 * n_bn and n_bn > 18 + 20


def _check_update(got_sd, ref_sd, grads_ref, lr, params, tag, grads=None):
    """Updated parameters: atol 1e-5 where |g_ref| ≥ 1e-5 (and, given the
    port's gradients, its |g| ≥ 1e-5 too, of the same sign: Adam's first
    step is about lr·sign(g)), else within 2·lr; the entries of opposite
    signs held to ``SIGN_FLIPS``.  Returns (the count of entries not held
    to 1e-5 that differ by more than it, the count of opposite signs, the
    entries behind the max-pools, the largest |g| of opposite signs over
    its parameter's largest)."""
    loose, flips, behind, largest = 0, 0, 0, 0.0
    for name in params:
        got, want = _np(got_sd[name]), ref_sd[name].numpy()
        firm = np.abs(grads_ref[name]) >= 1e-5
        if grads is not None:
            firm &= np.abs(grads[name]) >= 1e-5
            flip = firm & (np.sign(grads[name]) != np.sign(grads_ref[name]))
            firm &= ~flip
            if flip.any():
                size = np.maximum(np.abs(grads[name]), np.abs(grads_ref[name]))[flip].max() \
                    / np.abs(grads_ref[name]).max()
                assert name.startswith(BEHIND_MAX_POOL) and size <= SIGN_FLIPS['size'], \
                    (tag, name, size)
                largest = max(largest, size)
            flips += int(flip.sum())
        behind += got.size if name.startswith(BEHIND_MAX_POOL) else 0
        np.testing.assert_allclose(got[firm], want[firm], atol=1e-5, rtol=0,
                                   err_msg=f'{tag} {name}')
        assert np.all(np.abs(got - want) <= 2 * lr + 1e-7), name
        loose += int((~firm & (np.abs(got - want) > 1e-5)).sum())
    assert flips <= SIGN_FLIPS['share'] * behind, (tag, flips, behind)
    return loose, flips, behind, largest


def test_updated_params_match_f32(pair):
    clip = _clip_factor(pair)
    params = [n for n, _ in pair.tmodel.named_parameters()]
    grads = {n: pair.jgrads[n].numpy() * clip for n in params}
    loose, flips, behind, largest = _check_update(pair.tafter, pair.state_dict_of(1), grads,
                                 pair.schedule(0), params, 'step 1',
                                 {n: _np(g) * clip for n, g in pair.tgrads.items()})
    for name in params:
        assert not torch.equal(pair.tafter[name], pair.before[name]), name
    print(f'entries not held to 1e-5 that are apart by more than 1e-5: {loose}; '
          f'gradients of opposite signs: {flips} of {behind} entries behind the '
          f'max-pools, |g| up to {largest:.2e} of their parameter\'s largest')


def test_step_from_the_jax_optimizer_state(pair):
    """The second step, taken from the JAX state after the first (the
    parameters, batch statistics and optax state moved with
    ``optax_to_optimizer_state``, which maps PV-RCNN's point branch through
    the model config): losses rtol 1e-5, updated parameters and BN
    statistics as after the first step, with Adam's moments as the bound's
    gradient scale (√ν̂)."""
    model = pair.port_model(1)
    optim, schedule = topt(pair.tc.OPTIMIZATION, STEPS, model.parameters())
    _, _, opt1 = pair.jstates[1]
    optim.load_state_dict(optax_to_optimizer_state(
        opt1, pair.jstates[1][1], optim, model, pair.tc.MODEL))
    assert optim.count == 1
    tb, _, _, _ = pair.port_step(model, optim)
    jtb = pair.jruns[1][0]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(tb[k], float(jtb[k]), rtol=1e-5, err_msg=k)
    _, stats2, opt2 = pair.jstates[2]
    nu = optax_to_optimizer_state(opt2, stats2, optim, model, pair.tc.MODEL)
    params = [n for n, _ in model.named_parameters()]
    scale = {n: np.sqrt(s['exp_avg_sq'].numpy() / (1 - 0.999 ** 2))
             for n, s in zip(params, nu['inner']['state'].values())}
    ref = pair.state_dict_of(2)
    got = model.state_dict()
    loose, _, _, _ = _check_update(got, ref, scale, schedule(1), params, 'step 2')
    for name, v in got.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(_np(v), ref[name].numpy(), atol=1e-5,
                                       err_msg=name)
    print(f'step 2: entries not held to 1e-5 that are apart by more than 1e-5: {loose}')


def test_train_proposal_layer_equal(pair):
    """NMS_CONFIG.TRAIN on the JAX dense head's training outputs: the
    RoIs, labels and validity equal to the JAX proposal layer's."""
    d = {k: _t(pair.jout[k]) for k in ('batch_box_preds', 'batch_cls_preds')}
    out = trht.proposal_layer(d, pair.tc.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN)
    for k in ('rois', 'roi_labels', 'roi_valid'):
        np.testing.assert_array_equal(_np(out[k]), pair.jprops[k], err_msg=k)
    assert out['rois'].shape == (2, 32, 7) and _np(out['roi_valid']).all()


def test_point_targets_of_the_step(pair):
    """The point head's labels in the step: equal to the JAX step's, with
    fg, bg and ignored keypoints present."""
    labels = _np(pair.tout['point_cls_labels'])
    np.testing.assert_array_equal(labels, pair.jout['point_cls_labels'])
    assert set(np.unique(labels)) >= {0, 1}


def test_assign_point_targets_at_faces():
    """Points on box faces (heading 0, where the face is exact in both
    frameworks) and 1e-4 outside them, 1e-3 inside and outside the faces of
    rotated boxes, inside and outside the enlarged margin; a point at the
    centre of a padded (all-zero) gt row; invalid points."""
    rng = np.random.RandomState(3)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, :3, :3] = rng.uniform(-5, 5, (2, 3, 3))
    gt[:, :3, 3:6] = rng.uniform(1, 4, (2, 3, 3))
    gt[:, :3, 6] = [0.0, 0.7, -2.1]
    gt[:, :3, 7] = [1, 2, 3]
    pts = []
    for f in range(2):
        p = []
        for j in range(3):
            c, size, h = gt[f, j, :3], gt[f, j, 3:6], gt[f, j, 6]
            for axis in range(3):
                for s in (-1, 1):
                    # the enlarged box reaches 0.1 beyond each face
                    for off in ((0.0, 1e-4, 0.05, 0.09, 0.11, 0.2) if j == 0
                                else (-1e-3, 1e-3, 0.05, 0.09, 0.11, 0.2)):
                        local = np.zeros(3, np.float32)
                        local[axis] = s * (size[axis] / 2 + off)
                        x = local[0] * np.cos(h) - local[1] * np.sin(h)
                        y = local[0] * np.sin(h) + local[1] * np.cos(h)
                        p.append(c + np.array([x, y, local[2]], np.float32))
        p.append(np.zeros(3, np.float32))     # the centre of the padded gt row
        pts.append(np.stack(p).astype(np.float32))
    pts = np.stack(pts)
    valid = np.ones(pts.shape[:2], bool)
    valid[:, -6:-1] = False
    extra = (0.2, 0.2, 0.2)
    got = _np(tphs.assign_point_targets(_t(pts), _t(valid), _t(gt), extra))
    want = np.stack([np.asarray(jphs.assign_point_targets(pts[f], valid[f], gt[f], extra))
                     for f in range(2)])
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {-1, 0, 1}


def test_sample_gathered_from_the_jax_draw(pair):
    """The port's overlaps equal the JAX ones, and its gather from the JAX
    draw ``sel`` gives the JAX targets (integers exactly, floats 1e-5)."""
    props = {k: _t(v) for k, v in pair.proposals.items()}
    cfg = pair.tc.MODEL.ROI_HEAD.TARGET_CONFIG
    mo, ga = trht.roi_gt_overlaps(props, cfg)
    np.testing.assert_allclose(_np(mo), pair.j_overlaps, atol=1e-6)
    np.testing.assert_array_equal(_np(ga), pair.j_assignment)
    assert np.all(_np(mo)[:, 28:] == 0)           # padded RoIs
    t = trht.targets_from_sel(props, _t(pair.j_sel).long(), mo, ga, cfg)
    assert set(t) == set(TARGET_KEYS)
    for k in TARGET_KEYS:
        if pair.jtargets[k].dtype.kind in 'iub':
            np.testing.assert_array_equal(_np(t[k]), pair.jtargets[k], err_msg=k)
        else:
            np.testing.assert_allclose(_np(t[k]), pair.jtargets[k], atol=1e-5,
                                       err_msg=k)
    fg = _np(t['reg_valid_mask']).sum(-1)
    assert np.all(fg > 0) and np.all(fg < 16), fg


@pytest.mark.parametrize('by_class, score_type', [(False, 'roi_iou'), (True, 'cls')])
def test_targets_of_the_other_sampler_options(pair, by_class, score_type):
    """``SAMPLE_ROI_BY_EACH_CLASS`` off (any class's gt) and
    ``CLS_SCORE_TYPE: cls`` (hard labels, −1 between the thresholds): the
    port's gather from the JAX draw equals the JAX
    ``proposal_target_single``'s targets (before the canonical
    transform, which ``test_sample_gathered_from_the_jax_draw`` holds)."""
    cfg = _reduced(tload).MODEL.ROI_HEAD.TARGET_CONFIG
    jcfg = _reduced(jload).MODEL.ROI_HEAD.TARGET_CONFIG
    for c in (cfg, jcfg):
        c.SAMPLE_ROI_BY_EACH_CLASS, c.CLS_SCORE_TYPE = by_class, score_type
    props = pair.proposals
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    want = jax.jit(jax.vmap(lambda k, r, lab, sc, v, g: jrht.proposal_target_single(
        k, r, lab, sc, v, g, jcfg)))(keys, props["rois"], props["roi_labels"],
                                    props['roi_scores'], props['roi_valid'],
                                    props['gt_boxes'])
    tprops = {k: _t(v) for k, v in props.items()}
    mo, ga = trht.roi_gt_overlaps(tprops, cfg)
    jsel, _ = jax.jit(jax.vmap(lambda k, m, v: jrht.subsample_rois(k, m, v, jcfg)))(
        keys, _np(mo), props['roi_valid'])
    got = trht.targets_from_sel(tprops, _t(jsel).long(), mo, ga, cfg)
    for k, v in want.items():       # the JAX gt_of_rois is before the transform
        mine = got['gt_of_rois_src' if k == 'gt_of_rois' else k]
        np.testing.assert_allclose(_np(mine), np.asarray(v), atol=1e-5, err_msg=k)
    labels = _np(got['rcnn_cls_labels'])
    assert set(np.unique(labels)) <= ({-1.0, 0.0, 1.0} if score_type == 'cls'
                                      else set(np.unique(labels)))
    assert (labels == 1).any() and (labels == 0).any()


def _slot_pools(sel, mo, valid, cfg):
    """Each slot's pool: 0 fg, 1 hard bg, 2 easy bg (disjoint by the
    thresholds), 3 an invalid RoI."""
    m = np.take_along_axis(mo, sel, 1)
    v = np.take_along_axis(valid, sel, 1)
    fg_t = min(cfg.REG_FG_THRESH, cfg.CLS_FG_THRESH)
    pool = np.where(m >= fg_t, 0, np.where(m >= cfg.CLS_BG_THRESH_LO, 1, 2))
    return np.where(v, pool, 3)


@pytest.mark.parametrize('case', ['mixed', 'no fg', 'no bg', 'no hard', 'none valid'])
def test_sampler_contract(case):
    """The port's draw against the JAX draw on the same overlaps: the same
    slot layout [fg × nf | hard × hard_num | easy × rest] (counts per frame
    equal); every slot from its pool; the fg slots distinct and in the fg
    pool when there is background, drawn with replacement when there is
    none; with no valid RoI, every slot is RoI 0 in both."""
    cfg = _reduced(tload).MODEL.ROI_HEAD.TARGET_CONFIG
    jcfg = _reduced(jload).MODEL.ROI_HEAD.TARGET_CONFIG
    rng = np.random.RandomState(11)
    b, r = 4, 32
    mo = rng.uniform(0, 1, (b, r)).astype(np.float32)
    valid = np.ones((b, r), bool)
    valid[:, 28:] = False
    if case == 'no fg':
        mo *= 0.5
    elif case == 'no bg':
        mo = 0.6 + 0.4 * mo
    elif case == 'no hard':
        mo = np.where(mo < 0.5, 0.05 * mo, 0.6 + 0.4 * mo).astype(np.float32)
    elif case == 'none valid':
        valid[:] = False
    sel, is_fg = trht.subsample_rois(torch.Generator().manual_seed(0), _t(mo),
                                     _t(valid), cfg)
    sel, is_fg = _np(sel), _np(is_fg)
    jsel, jfg = jax.jit(jax.vmap(lambda k, m, v: jrht.subsample_rois(k, m, v, jcfg)))(
        jax.random.split(jax.random.PRNGKey(2), b), mo, valid)
    jsel, jfg = np.asarray(jsel), np.asarray(jfg)
    assert sel.shape == (b, 16) and sel.dtype == np.int64
    np.testing.assert_array_equal(is_fg, jfg)
    pools, jpools = _slot_pools(sel, mo, valid, cfg), _slot_pools(jsel, mo, valid, cfg)
    for f in range(b):
        counts = np.bincount(pools[f], minlength=4)
        np.testing.assert_array_equal(counts, np.bincount(jpools[f], minlength=4))
        assert np.all(np.diff(pools[f]) >= 0), pools[f]        # slot layout
        assert np.array_equal(pools[f] == 0, is_fg[f])
        fg = sel[f][is_fg[f]]
        if counts[1] + counts[2] > 0:
            assert len(np.unique(fg)) == len(fg)               # in order, no repeat
    if case == 'none valid':
        assert np.all(sel == 0) and np.all(jsel == 0)
    elif case == 'no bg':                                       # with replacement
        assert is_fg.all() and any(len(np.unique(s)) < 16 for s in sel)
    elif case == 'no fg':
        assert not is_fg.any()
    else:
        assert np.all(is_fg.sum(-1) > 0) and np.all(is_fg.sum(-1) <= 8)
    again, _ = trht.subsample_rois(torch.Generator().manual_seed(0), _t(mo),
                                   _t(valid), cfg)
    np.testing.assert_array_equal(_np(again), sel)             # seeded draw


def test_flax_batch_norm_matches_flax():
    """The helper against ``flax.linen.BatchNorm`` in training: the output
    and the updated running statistics, for an NCHW tensor (channel axis 1)
    and a channels-last (B, M, ns, C) tensor with zeroed rows, which count
    in the statistics."""
    import flax.linen as fnn
    rng = np.random.RandomState(4)
    for shape, axis in (((3, 6, 5, 7), 1), ((2, 9, 4, 6), -1)):
        x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
        if axis == -1:
            x[:, 3:6] = 0.0
        c = shape[axis]
        variables = {'params': {'scale': 1 + 0.1 * rng.randn(c).astype(np.float32),
                                'bias': 0.1 * rng.randn(c).astype(np.float32)},
                     'batch_stats': {'mean': 0.1 * rng.randn(c).astype(np.float32),
                                     'var': 0.5 + rng.rand(c).astype(np.float32)}}
        y, new = fnn.BatchNorm(use_running_average=False, axis=axis, momentum=0.99,
                               epsilon=1e-3).apply(variables, x, mutable=['batch_stats'])
        bn = torch.nn.BatchNorm2d(c, eps=1e-3)
        with torch.no_grad():
            bn.weight.copy_(_t(variables['params']['scale']))
            bn.bias.copy_(_t(variables['params']['bias']))
            bn.running_mean.copy_(_t(variables['batch_stats']['mean']))
            bn.running_var.copy_(_t(variables['batch_stats']['var']))
        got = flax_layers.flax_batch_norm(_t(x), bn, channel_dim=axis)
        np.testing.assert_allclose(_np(got), np.asarray(y), atol=2e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(bn.running_mean),
                                   np.asarray(new['batch_stats']['mean']), atol=1e-7)
        np.testing.assert_allclose(_np(bn.running_var),
                                   np.asarray(new['batch_stats']['var']), atol=1e-6)


def test_dropout_on_an_explicit_generator():
    """p = 0.3: the keep share within 3σ of 0.7, the kept entries 1/0.7
    (Flax's scale), equal masks for equal seeds and other masks for
    another; the identity in eval mode and at p = 0; a live draw without a
    generator raises."""
    x = torch.ones(200, 500)
    y = flax_layers.flax_dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    keep = y != 0
    share = keep.float().mean().item()
    assert abs(share - 0.7) <= 3 * np.sqrt(0.7 * 0.3 / x.numel()), share
    assert torch.all(y[keep] == torch.tensor(1.0) / 0.7)
    again = flax_layers.flax_dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    assert torch.equal(again, y)
    other = flax_layers.flax_dropout(x, 0.3, True, torch.Generator().manual_seed(8))
    assert not torch.equal(other, y)
    assert flax_layers.flax_dropout(x, 0.3, False, None) is x
    assert flax_layers.flax_dropout(x, 0.0, True, None) is x
    with pytest.raises(RuntimeError, match='Generator'):
        flax_layers.flax_dropout(x, 0.3, True, None)
    stack = torch.nn.Sequential(torch.nn.Dropout(0.3))
    stack.eval()
    assert run_pointwise(stack, x) is x
    stack.train()
    with pytest.raises(RuntimeError, match='Generator'):
        run_pointwise(stack, x)


def test_loss_utils_match_jax():
    rng = np.random.RandomState(5)
    logits = (rng.randn(64) * 4).astype(np.float32)
    target = rng.uniform(0, 1, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tloss.binary_cross_entropy_with_logits(_t(logits), _t(target))),
        np.asarray(jloss.binary_cross_entropy_with_logits(logits, target)),
        rtol=1e-6, atol=1e-7)
    gt = np.concatenate([rng.uniform(-5, 5, (32, 3)), rng.uniform(0.5, 4, (32, 3)),
                         rng.uniform(-np.pi, np.pi, (32, 1))], 1).astype(np.float32)
    pred = gt + (rng.randn(32, 7) * 0.3).astype(np.float32)
    pred[::4, 6] += np.pi                       # the flipped gt is nearer
    np.testing.assert_allclose(
        _np(tloss.get_corner_loss_lidar(_t(pred), _t(gt))),
        np.asarray(jloss.get_corner_loss_lidar(jnp.asarray(pred), jnp.asarray(gt))),
        rtol=1e-5, atol=1e-6)


def test_masked_corner_loss_nan_from_an_overflowed_background_slot():
    """The reference behaviour the port keeps: ``get_box_reg_layer_loss``
    takes the corner loss of every slot and masks the background ones, so a
    background RoI of 1e26 m (its decode overflows) leaves the loss finite
    and equal in both packages but gives that slot's ``rcnn_reg`` a NaN
    gradient in both; the other slots' gradients agree (1e-5)."""
    tc, jc = _reduced(tload), _reduced(jload)
    rng = np.random.RandomState(6)
    gt = np.concatenate([rng.uniform(-5, 5, (2, 4, 3)), rng.uniform(1, 4, (2, 4, 3)),
                         rng.uniform(-3, 3, (2, 4, 1)), np.ones((2, 4, 1))],
                        -1).astype(np.float32)
    rois = gt[..., :7] + 0.1 * rng.randn(2, 4, 7).astype(np.float32)
    rois[1, 3, 3:6] = 1e26
    fg = np.ones((2, 4), np.float32)
    fg[:, 3] = 0.0                                        # background slots
    reg = (0.1 * rng.randn(8, 7)).astype(np.float32)
    t = {'reg_valid_mask': fg, 'gt_of_rois': gt, 'gt_of_rois_src': gt, 'rois': rois}
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jloss_, jgrad = jax.value_and_grad(lambda x: jrht.get_box_reg_layer_loss(
        {**jt, 'rcnn_reg': x}, jc.MODEL.ROI_HEAD.LOSS_CONFIG))(jnp.asarray(reg))
    x = _t(reg).requires_grad_(True)
    loss = trht.get_box_reg_layer_loss({**{k: _t(v) for k, v in t.items()}, 'rcnn_reg': x},
                                       tc.MODEL.ROI_HEAD.LOSS_CONFIG)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss_), rtol=1e-5)
    tgrad, jgrad = _np(x.grad), np.asarray(jgrad)
    bad = np.zeros(8, bool)
    bad[7] = True                                         # frame 1, slot 3
    np.testing.assert_array_equal(~np.isfinite(tgrad).all(-1), bad)
    np.testing.assert_array_equal(~np.isfinite(jgrad).all(-1), bad)
    np.testing.assert_allclose(tgrad[~bad], jgrad[~bad], rtol=1e-5, atol=1e-7)


def test_make_train_step_draws_from_its_generator(pair):
    """The port's own path: ``make_train_step`` at DP_RATIO 0.3 with the
    TRAIN proposal layer and its own sample, over ``train_one_epoch``:
    finite positive losses, every head's loss present, equal results for
    equal seeds, and a raise without a generator (the sampler and the
    Dropout each); ``device='cpu'`` is explicit, and the CUDA default
    raises without a card."""
    tc = _reduced(tload, dp=0.3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tdet(tc.MODEL, 3, pair.tset)

    def run(seed):
        model = tdet(tc.MODEL, 3, pair.tset, device='cpu')
        init_weights(model, torch.Generator().manual_seed(3))
        optim, _ = topt(tc.OPTIMIZATION, STEPS, model.parameters())
        state, loss = ttrain.train_one_epoch(
            ttrain.init_train_state(model, optim),
            ttrain.make_train_step(model, optim, pair.tset), [pair.host],
            device='cpu', generator=torch.Generator().manual_seed(seed))
        return state, loss
    state, loss = run(0)
    assert state.step == 1 and np.isfinite(loss) and loss > 0
    _, again = run(0)
    assert again == loss
    model = state.model
    batch = ttrain.prepare_device_batch(
        ttrain.host_to_device_batch(pair.host, 'cpu'), *pair.geom)
    out = model(batch, torch.Generator().manual_seed(1))
    t = out['roi_targets']
    assert t['rois'].shape == (2, 16, 7) and out['roi_valid'].all()
    _, tb = model.compute_loss(out)
    assert all(torch.isfinite(v) for v in tb.values())
    with pytest.raises(RuntimeError, match='Generator'):
        model(batch)                                     # the sampler
    given = {**batch, 'rois': t['rois'], 'roi_targets_dict': t}
    with pytest.raises(RuntimeError, match='Generator'):
        model(given)                                     # the Dropout

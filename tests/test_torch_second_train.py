"""The port's SECOND train step vs the JAX package, from the same weights and
the same host batch.

The reduced SECOND of ``tests/test_torch_second_eval.py`` (128×128×40 grid,
narrow BEV widths, batch 2), on the train split (shuffled points, the
synthetic augmentor), ``adam_onecycle`` at LR 0.003 over a 40-step schedule
(the first update runs at LR/10), weight decay 0.01, ``GRAD_NORM_CLIP`` 10.
The Flax variables come from a numpy seed (the cls bias at the focal-loss
prior, as the models' own init sets it) and go into the port with
``utils/flax_weights.py``.  The JAX side runs its own ``make_train_step``;
its gradients come from ``jax.value_and_grad`` of the step's own loss
function (model.apply in training mode + ``compute_loss``).

Tolerances, f32 (``USE_BF16: False``; same f32 formulas, other summation
orders):
  * ``rpn_loss_cls``, ``rpn_loss_loc``, ``rpn_loss``: rtol 1e-5;
  * every parameter's gradient: ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-7;
  * BN running statistics after the step: atol 1e-5;
  * updated parameters: atol 1e-6 wherever the reference's |g| ≥ 1e-5 (g
    as Adam sees it, after the global-norm clip); the
    other entries within 2·lr (Adam's first step moves a weight by about
    lr·sign(g) wherever |g| ≫ eps = 1e-8, so a gradient that the two
    frameworks round to opposite signs moves it by 2·lr), counted and
    printed;
  * three steps, each from the JAX state before it (``optax`` state moved
    with ``optax_to_optimizer_state``): losses within rtol 1e-5, updated
    parameters as above; three steps run freely: losses within rtol 1e-2
    (``test_three_steps_f32`` says why not closer).
bf16 (``USE_BF16`` in both backbones): each sparse layer and BEV conv
rounds its operands to bf16, and the two frameworks round the backward in
other places (the JAX VJP rounds each tap's product to bf16 before the
scatter-add; the port sums a row's taps in f32 and rounds once).  At this
random init both frameworks' bf16 backbone gradients lie 15-45 % (in norm)
from the f64 gradient, so they are not held to each other but to it: the
port's within 2× the JAX distance + 0.03·‖g64‖, and its losses within
2× the JAX distance + 3e-3·|loss64| (readings in the test's output).
"""

import jax
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.utils.flax_weights import (flax_to_state_dict,
                                                       optax_to_optimizer_state)

from test_torch_second_eval import _fill, _reduced

STEPS = 40            # the schedule's length
LOSS_KEYS = ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss')


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TrainPair:
    """JAX and port SECOND of one config, same weights, same host batch; one
    train step taken on each, with the JAX gradients beside it."""

    def __init__(self, bf16, n_steps=1):
        jc, tc = _reduced(jload, bf16), _reduced(tload, bf16)
        self.jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0,
                                 training=True)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2,
                                       workers=0, training=True)
        # each pass over the small split is a new shuffle (torch's RNG) and
        # augmentation (numpy's): seeded, so that the batches repeat
        torch.manual_seed(0)
        np.random.seed(0)
        self.hosts = [next(iter(tloader)) for _ in range(n_steps)]
        jmodel = jdet(jc.MODEL, num_class=3, dataset=self.jset)
        geom = (self.jset.voxel_cfg, tuple(int(g) for g in self.jset.grid_size),
                tuple(float(x) for x in self.jset.point_cloud_range),
                tuple(float(v) for v in self.jset.voxel_size))
        jbatches = [jtrain.host_to_device_batch(h) for h in self.hosts]
        shapes = jax.eval_shape(
            lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                     training=False),
            jax.random.PRNGKey(0), jbatches[0])
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)),
                                               shapes)
        # the focal-loss prior of the models' own init on the cls bias
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.full_like(head['bias'], -np.log((1 - 0.01) / 0.01))
        self.var = var
        joptim, _ = jopt(jc.OPTIMIZATION, total_steps=STEPS)
        state = jtrain.TrainState(params=var['params'],
                                  batch_stats=var['batch_stats'],
                                  opt_state=joptim.init(var['params']),
                                  step=jax.numpy.asarray(0, jax.numpy.int32))

        def loss_fn(params, batch_stats, host):
            out, mutated = jmodel.apply(
                {'params': params, 'batch_stats': batch_stats},
                jtrain.prepare_device_batch(host, *geom), training=True,
                mutable=['batch_stats'])
            loss, tb = jmodel.compute_loss(out)
            return loss, tb
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, jtb), jgrads = grad_fn(var['params'], var['batch_stats'], jbatches[0])
        self.jtb0 = {k: float(jtb[k]) for k in LOSS_KEYS}
        self.jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads),
                                         var['batch_stats'])
        jstep = jtrain.make_train_step(jmodel, joptim, self.jset)
        self.jmetrics = []
        self.jstates = [jax.tree.map(np.asarray, state)]     # before each step
        for b in jbatches:
            state, m = jstep(state, b, jax.random.PRNGKey(1))
            self.jmetrics.append({k: float(m[k]) for k in LOSS_KEYS})
            self.jstates.append(jax.tree.map(np.asarray, state))
        self.jafter = self.state_dict_of(1)

        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'],
                                                       var['batch_stats']))
        self.before = {k: v.clone() for k, v in self.tmodel.state_dict().items()}
        optim, self.schedule = topt(tc.OPTIMIZATION, STEPS, self.tmodel.parameters())
        update = optim.step

        def keep_grads_then_update():
            # the first step's gradients as the backward left them (the
            # clip scales them in place)
            if not hasattr(self, 'tgrads'):
                self.tgrads = {n: p.grad.clone()
                               for n, p in self.tmodel.named_parameters()}
            update()
        optim.step = keep_grads_then_update
        tstate = ttrain.init_train_state(self.tmodel, optim)
        tstep = ttrain.make_train_step(self.tmodel, optim, self.tset)
        self.tmetrics = []
        for h in self.hosts:
            tstate, m = tstep(tstate, ttrain.host_to_device_batch(h, 'cpu'))
            self.tmetrics.append({k: float(m[k]) for k in LOSS_KEYS + ('loss',)})
            if len(self.tmetrics) == 1:
                self.tafter = {k: v.clone() for k, v in self.tmodel.state_dict().items()}
        self.clip = float(tc.OPTIMIZATION.GRAD_NORM_CLIP)
        self.step_of = tstate.step
        self.tc = tc

    def state_dict_of(self, i):
        """The JAX state after ``i`` steps as a port state_dict."""
        st = self.jstates[i]
        return flax_to_state_dict(st.params, st.batch_stats)

    def f64_grads(self):
        """First-step gradients of the port's f64 model (USE_BF16 off) from
        the same weights and batch: the reference for the bf16 paths."""
        tc = _reduced(tload, False)
        m = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu').double()
        m.load_state_dict(flax_to_state_dict(self.var['params'],
                                             self.var['batch_stats']))
        m.train()
        batch = ttrain.prepare_device_batch(
            ttrain.host_to_device_batch(self.hosts[0], 'cpu'),
            self.tset.voxel_cfg, self.tset.grid_size, self.tset.point_cloud_range,
            self.tset.voxel_size)
        batch = {k: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point()
                 else v for k, v in batch.items()}
        loss, tb = m.compute_loss(m(batch))
        loss.backward()
        return ({k: float(tb[k].detach()) for k in LOSS_KEYS},
                {n: p.grad.numpy() for n, p in m.named_parameters()})


@pytest.fixture(scope='module')
def f32():
    return TrainPair(bf16=False, n_steps=3)


def _clip_factor(pair):
    """The global-norm clip's factor on the reference gradients, and
    their norm."""
    norm = np.sqrt(sum(float(np.sum(pair.jgrads[k].double().numpy() ** 2))
                       for k in pair.tgrads))
    return min(1.0, pair.clip / norm), norm


def test_losses_match_f32(f32):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(f32.tmetrics[0][k], f32.jmetrics[0][k],
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(f32.jtb0[k], f32.jmetrics[0][k], rtol=1e-6)
    assert f32.tmetrics[0]['rpn_loss_loc'] > 0      # targets were assigned


def test_gradients_match_f32(f32):
    grads = f32.tgrads
    print(f'global gradient norm {_clip_factor(f32)[1]:.4f} (clip {f32.clip})')
    assert set(grads) <= set(f32.jgrads)
    worst = 0.0
    for name, g in grads.items():
        ref = f32.jgrads[name].numpy()
        d = np.linalg.norm(_np(g) - ref)
        worst = max(worst, d / (np.linalg.norm(ref) + 1e-30))
        assert d <= 1e-4 * np.linalg.norm(ref) + 1e-7, name
    print(f'largest relative gradient difference {worst:.2e}')


def test_batch_stats_match_f32(f32):
    n = 0
    for name, v in f32.tafter.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(_np(v), f32.jafter[name].numpy(), atol=1e-5,
                                       err_msg=name)
            assert not torch.equal(v, f32.before[name]), name    # they moved
            n += 1
    n_bn = sum(1 for m in f32.tmodel.modules() if isinstance(m, torch.nn.BatchNorm1d)
               or isinstance(m, torch.nn.BatchNorm2d))
    assert n == 2 * n_bn and n_bn == 12 + 6     # 12 sparse layers, 6 BEV BNs


def _firm_and_apart(pair, name):
    """After the first step, for one parameter: where the reference's
    clipped |g| ≥ 1e-5 (what Adam sees), and where the two updated
    parameters differ by more than 1e-6."""
    clip, _ = _clip_factor(pair)
    got, ref = _np(pair.tafter[name]), pair.jafter[name].numpy()
    return (np.abs(pair.jgrads[name].numpy()) * clip >= 1e-5,
            np.abs(got - ref) > 1e-6)


def test_updated_params_match_f32(f32):
    lr = f32.schedule(0)
    loose = 0
    for name, p in f32.tmodel.named_parameters():
        got, ref = _np(f32.tafter[name]), f32.jafter[name].numpy()
        firm, apart = _firm_and_apart(f32, name)
        np.testing.assert_allclose(got[firm], ref[firm], atol=1e-6, rtol=0,
                                   err_msg=name)
        assert np.all(np.abs(got - ref)[~firm] <= 2 * lr + 1e-7), name
        loose += int((~firm & apart).sum())
        assert not np.array_equal(got, _np(f32.before[name])), name
    print(f'entries with |g_ref| < 1e-5 that differ by more than 1e-6: {loose}')


def test_three_steps_f32(f32):
    """Three steps run freely on each side: losses within rtol 1e-2.  The
    first step's ~30 weights whose clipped |g| is near Adam's eps (1e-7 to
    1e-8) move by up to 2·lr in opposite directions, and this small random
    model carries that on: the losses part by ~1e-7, ~1e-4, ~2e-3 at steps
    1-3 (readings in the output), while the port's step-2 loss at the JAX
    step-1 parameters matches to ~1e-6 (``test_steps_from_the_jax_state``
    holds each step from one common state).  What parts the two runs is
    checked here: after step 1 the parameters differ by more than 1e-6
    only at entries whose clipped reference |g| is below 1e-5, and at some
    of those, and the BN statistics agree within 1e-5."""
    assert f32.step_of == 3
    apart_firm = apart_near_eps = 0
    for name, _ in f32.tmodel.named_parameters():
        firm, apart = _firm_and_apart(f32, name)
        apart_firm += int((firm & apart).sum())
        apart_near_eps += int((~firm & apart).sum())
    for name, v in f32.tafter.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(_np(v), f32.jafter[name].numpy(), atol=1e-5,
                                       err_msg=name)
    print(f'after step 1, entries apart by more than 1e-6: {apart_near_eps} with '
          f'clipped |g_ref| < 1e-5, {apart_firm} others')
    assert apart_firm == 0 and apart_near_eps > 0
    worst = []
    for t, j in zip(f32.tmetrics, f32.jmetrics):
        worst.append(max(abs(t[k] - j[k]) / abs(j[k]) for k in LOSS_KEYS))
        for k in LOSS_KEYS:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-2, err_msg=k)
    print('free-running steps, largest relative loss difference:',
          ', '.join(f'{w:.2e}' for w in worst))


def test_three_steps_f32_part_by_rounding(f32):
    """Why the free-running steps part (``test_three_steps_f32``): only f32
    rounding, in both frameworks.  Against the port's f64 gradient from the
    same weights and batch, every parameter's f32 gradient lies within f32
    rounding in both packages (max |g − g64| ≤ 2e-5·max |g64|; the largest
    reading is 1.1e-5, JAX's conv_box), the port's
    no farther than the JAX one (rms, at most 1.2×), so no formula differs;
    the entries whose sign the two f32 gradients disagree on all have
    clipped |g| < 1e-5 and a |g64| below one of the two frameworks' own
    rounding error there, so their sign is rounding noise, and they lie in
    weights of the convolutions, whose gradients are sums over thousands
    of voxels or pixels."""
    clip, _ = _clip_factor(f32)
    _, g64 = f32.f64_grads()
    flips = {}
    rms = []
    for name, g in f32.tgrads.items():
        got, ref = _np(g).astype(np.float64), f32.jgrads[name].numpy().astype(np.float64)
        e = g64[name]
        dp, dj = np.abs(got - e), np.abs(ref - e)
        assert max(dp.max(), dj.max()) <= 2e-5 * np.abs(e).max(), name
        rms.append((np.sqrt((dp ** 2).mean()), np.sqrt((dj ** 2).mean())))
        assert rms[-1][0] <= 1.2 * rms[-1][1] + 1e-12, name
        flip = np.sign(got) != np.sign(ref)
        if flip.any():
            assert np.all(np.abs(ref[flip]) * clip < 1e-5), name
            assert np.all(np.abs(e[flip]) <= np.maximum(dp[flip], dj[flip])), name
            flips[name] = int(flip.sum())
    assert flips and all(n.endswith('.weight') and ('conv' in n or 'blocks' in n)
                         for n in flips)
    print('f32 gradients vs the f64 gradient, rms |g - g64| over the parameters: '
          f'port {np.median([r[0] for r in rms]):.2e} median, '
          f'JAX {np.median([r[1] for r in rms]):.2e} median; sign flips: {flips}')


def test_steps_from_the_jax_state(f32):
    """Each of the three steps taken from the JAX state before it —
    parameters, batch statistics and the optax state (Adam's mu, nu and
    count, the schedule's count), moved with ``optax_to_optimizer_state``,
    so steps 2 and 3 run mid-schedule with Adam's moments: losses within
    rtol 1e-5, updated parameters within atol 1e-6 where the reference's
    bias-corrected √ν̂ ≥ 1e-5 (at step 1 that is the clipped |g|; Adam's
    update divides by √ν̂ + eps), the rest within 2·lr; batch statistics
    within atol 1e-5."""
    model = tdet(f32.tc.MODEL, num_class=3, dataset=f32.tset, device='cpu')
    optim, schedule = topt(f32.tc.OPTIMIZATION, STEPS, model.parameters())
    step = ttrain.make_train_step(model, optim, f32.tset)
    for i, host in enumerate(f32.hosts):
        st = f32.jstates[i]
        model.load_state_dict(f32.state_dict_of(i))
        optim.load_state_dict(optax_to_optimizer_state(
            st.opt_state, st.batch_stats, optim, model))
        assert optim.count == i
        state = ttrain.TrainState(model, optim, step=i)
        state, m = step(state, ttrain.host_to_device_batch(host, 'cpu'))
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(m[k]), f32.jmetrics[i][k], rtol=1e-5,
                                       err_msg=f'step {i + 1} {k}')
        ref = f32.state_dict_of(i + 1)
        after = f32.jstates[i + 1]
        nu = [s['exp_avg_sq'] for s in optax_to_optimizer_state(
            after.opt_state, after.batch_stats, optim, model)['inner']['state'].values()]
        lr = schedule(i)
        params = [n for n, _ in model.named_parameters()]
        for name, v in model.state_dict().items():
            got, want = _np(v), ref[name].numpy()
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
            elif name in params:
                v_hat = nu[params.index(name)].numpy() / (1 - 0.999 ** (i + 1))
                firm = np.sqrt(v_hat) >= 1e-5
                np.testing.assert_allclose(got[firm], want[firm], atol=1e-6,
                                           rtol=0, err_msg=f'step {i + 1} {name}')
                assert np.all(np.abs(got - want) <= 2 * lr + 1e-7), name


def test_train_one_epoch(f32):
    """``train_one_epoch`` over two host batches from the same weights:
    the step count, and its one mean loss equal (rtol 1e-6) to the mean of
    the losses that two single steps gave."""
    model = tdet(f32.tc.MODEL, num_class=3, dataset=f32.tset, device='cpu')
    model.load_state_dict(flax_to_state_dict(f32.var['params'], f32.var['batch_stats']))
    optim, _ = topt(f32.tc.OPTIMIZATION, STEPS, model.parameters())
    state, loss = ttrain.train_one_epoch(
        ttrain.init_train_state(model, optim),
        ttrain.make_train_step(model, optim, f32.tset), f32.hosts[:2], device='cpu')
    assert state.step == optim.count == 2
    np.testing.assert_allclose(loss, np.mean([m['loss'] for m in f32.tmetrics[:2]]),
                               rtol=1e-6)


def test_train_step_bf16():
    """bf16 in both backbones, held against the port's f64 step from the
    same weights and batch (which the f32 tests tie to the JAX step): each
    loss term and each parameter's gradient of the port lies within 2·(the
    JAX bf16 distance) + 3e-3·|loss64| (losses) or + 0.03·‖g64‖ (gradients)
    of the f64 values (module docstring)."""
    pair = TrainPair(bf16=True)
    l64, g64 = pair.f64_grads()
    for k in LOSS_KEYS:
        port = abs(pair.tmetrics[0][k] - l64[k])
        jax_ = abs(pair.jmetrics[0][k] - l64[k])
        print(f'bf16 {k}: f64 {l64[k]:.6f}, port off by {port:.3e}, JAX by {jax_:.3e}')
        assert port <= 2 * jax_ + 3e-3 * abs(l64[k]), k
    grads = pair.tgrads
    ratios = []
    for name, g in grads.items():
        ref = g64[name]
        n = np.linalg.norm(ref)
        port = np.linalg.norm(_np(g) - ref) / n
        jax_ = np.linalg.norm(pair.jgrads[name].numpy() - ref) / n
        ratios.append((port, jax_, name))
        assert port <= 2 * jax_ + 0.03, (name, port, jax_)
    port, jax_, name = max(ratios)
    print(f'bf16 gradients vs f64 (‖Δ‖/‖g64‖): port at most {port:.3e} ({name}; '
          f'JAX {jax_:.3e} there); JAX at most {max(r[1] for r in ratios):.3e}')

"""llal on PV-RCNN, the port vs the JAX package: the LossNet's weights and
init, one LossNet-fitting step against the JAX ``make_lossnet_train_step``,
llal's picks, and ``train_model_active`` with METHOD llal on the CPU.

The reduced PV-RCNN of ``tests/test_torch_pvrcnn_active.py`` (``_cfg``: a
LossNet over the shared layers [64, 64], 16 RoIs, DP_RATIO 0.3, 9 scenes, 4
labelled at batch 2).  The fitting step runs from one JAX state (variables
of ``_fill(RandomState(0))``, a fresh optax state) on one labelled batch
with one common RoI sample (``rois`` + ``roi_targets_dict``, the JAX
sampler at a fixed key) and given Dropout masks in both packages
(``GivenMasks``); the JAX step is compiled once, in the module fixture.

Tolerances: the margin-ranking loss rtol 1e-4, atol 1e-5 (its predictions
read latents behind the grouped max-pools, where the two forwards part by
~1e-5); every updated parameter and
BN statistic atol 1e-5 against JAX; outside ``loss_net`` each parameter
equal to its value times (1 − lr·wd), the weight decay alone; picks equal.
"""

import logging
import random

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use: import it while
# collecting (see tests/test_torch_pvrcnn_train.py)
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.runtime import active as jactive_rt
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.runtime import active as tactive_rt
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_active import _finite, _run
from test_torch_pvrcnn_active import GivenMasks, _cfg, _mask_shapes, _masks, _np
from test_torch_pvrcnn_eval import _fill
from test_torch_pvrcnn_train import make_proposals

STEPS = 8             # the fitting schedule's length
LOGGER = logging.getLogger('test_torch_pvrcnn_llal')
LOGGER.addHandler(logging.NullHandler())


def _given_rois(hb, targets):
    """``hb`` with the RoI sample as flat entries (``rt_*``): the JAX step
    takes a flat dict of arrays; ``_roi_tap`` hands the head its dict."""
    return {**hb, 'rois': targets['rois'], **{f'rt_{k}': v for k, v in targets.items()}}


def _roi_tap(next_fun, args, kwargs, context):
    if context.method_name == '__call__' and context.module.name == 'roi_head':
        b = dict(args[0])
        b['roi_targets_dict'] = {k[3:]: b.pop(k) for k in list(b) if k.startswith('rt_')}
        args = (b,) + tuple(args[1:])
    return next_fun(*args, **kwargs)


class LLALPair:
    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload, 'llal'), _cfg(tload, 'llal')
        (jlab_set, _, self.jlab, self.junlab, _, _) = jactive(
            self.jc.DATA_CONFIG, self.jc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        (self.tset, _, self.tlab, self.tunlab, _, _) = tactive(
            self.tc.DATA_CONFIG, self.tc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        self.jmodel = jmodel = jdet(self.jc.MODEL, num_class=3, dataset=jlab_set)
        geom = (jlab_set.voxel_cfg, tuple(int(g) for g in jlab_set.grid_size),
                tuple(float(x) for x in jlab_set.point_cloud_range),
                tuple(float(v) for v in jlab_set.voxel_size))
        torch.manual_seed(0)
        np.random.seed(0)
        self.host = next(iter(self.tlab))
        jbatch = jtrain.host_to_device_batch(self.host)
        shapes = jax.eval_shape(
            lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                     training=False),
            jax.random.PRNGKey(0), jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.full_like(head['bias'], -np.log((1 - 0.01) / 0.01))
        self.var, self.tmp = var, tmp
        props = make_proposals(self.host['gt_boxes'], np.random.RandomState(1))
        self.targets = jax.tree.map(np.asarray, jrht.assign_targets(
            jax.random.PRNGKey(5), dict(props), self.jc.MODEL.ROI_HEAD.TARGET_CONFIG))
        self.given = GivenMasks(_masks(2, _mask_shapes(32, self.tc)), np.float32(1 / 0.7))

        # the JAX fitting step, the RoI sample and the masks given
        joptim, _ = jopt(self.jc.OPTIMIZATION, total_steps=STEPS)
        real_prep = jtrain.prepare_device_batch

        def prep(hb, *g):
            return {**real_prep(hb, *g), **{k: v for k, v in hb.items()
                                             if k == 'rois' or k.startswith('rt_')}}
        jtrain.prepare_device_batch = prep
        try:
            with self.given.jax(), fnn.intercept_methods(_roi_tap):
                step = jactive_rt.make_lossnet_train_step(jmodel, joptim, jlab_set)
                state = jtrain.TrainState(params=var['params'], batch_stats=var['batch_stats'],
                                          opt_state=joptim.init(var['params']),
                                          step=jnp.asarray(0))
                new, loss = step(state, _given_rois(jbatch, self.targets),
                                 jax.random.PRNGKey(3))
        finally:
            jtrain.prepare_device_batch = real_prep
        self.jloss = float(loss)
        self.jafter = flax_to_state_dict(jax.tree.map(np.asarray, new.params),
                                         jax.tree.map(np.asarray, new.batch_stats), self.tc.MODEL)
        assert self.given.i == 3

    def port_model(self):
        model = tdet(self.tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        model.load_state_dict(flax_to_state_dict(self.var['params'], self.var['batch_stats'],
                                                 self.tc.MODEL))
        return model


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair(tmp_path_factory, one_torch_thread):
    return LLALPair(tmp_path_factory.mktemp('llal'))


def test_loss_net_weights_and_init(pair):
    """The transfer fills every key of the port model, the LossNet's
    included, with its shape, using every Flax leaf once; ``flax_init``
    draws the LossNet as the JAX init does (lecun-normal kernels, zero
    biases, BatchNorm 1/0/0/1)."""
    sd = flax_to_state_dict(pair.var['params'], pair.var['batch_stats'], pair.tc.MODEL)
    model = pair.port_model()
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(pair.var))
    assert n_flax == sum(v.numel() for k, v in sd.items()
                         if not k.endswith('num_batches_tracked'))
    net = model.roi_head.loss_net
    assert net.linear.weight.shape == (1, 16 * 2)
    assert [tuple(s[0].weight.shape) for s in net.conv_layers] == [(1, 64, 1)] * 2
    flax_init(model, torch.Generator().manual_seed(0))
    assert net.linear.bias.item() == 0.0
    for stack in net.conv_layers:
        w, bn = stack[0].weight.detach(), stack[1]
        # a normal of std 1/√64 truncated at ±2 of its scale, 1/√64/0.8796
        assert abs(w.std().item() * 8 - 1) < 0.3
        assert w.abs().max().item() <= 2 / 8 / 0.87962566103423978 + 1e-6
        assert bn.weight.item() == 1 and bn.bias.item() == 0
        assert bn.running_mean.item() == 0 and bn.running_var.item() == 1


def test_lossnet_step_matches_jax(pair):
    """One fitting step from one JAX state: the margin-ranking loss; the
    LossNet's parameters updated; every other parameter moved by AdamW's
    weight decay alone; the BN statistics of the training forward kept."""
    model = pair.port_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optim, schedule = topt(pair.tc.OPTIMIZATION, STEPS, model.parameters())
    step = tactive_rt.make_lossnet_train_step(model, optim, pair.tset)
    t = {k: torch.from_numpy(np.array(v)) for k, v in pair.targets.items()}
    batch = {**ttrain.host_to_device_batch(pair.host, 'cpu'), 'rois': t['rois'],
             'roi_targets_dict': t}
    with pair.given.port():
        state, metrics = step(ttrain.init_train_state(model, optim), batch, torch.Generator())
    assert pair.given.i == 3 and state.step == 1 and optim.count == 1
    np.testing.assert_allclose(float(metrics['loss']), pair.jloss, rtol=1e-4, atol=1e-5)
    after = model.state_dict()
    decay = 1 - schedule(0) * float(pair.tc.OPTIMIZATION.WEIGHT_DECAY)
    params = {n for n, _ in model.named_parameters()}
    for k, v in after.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(_np(v), _np(pair.jafter[k]), rtol=0, atol=1e-5, err_msg=k)
        if k in params and '.loss_net.' not in k:
            torch.testing.assert_close(v, before[k] * decay, rtol=1e-6, atol=0)
    net = [k for k in params if '.loss_net.' in k]
    moved = {k for k in net if (after[k] - before[k] * decay).abs().max() > 1e-4}
    assert moved == {k for k in net
                     if (pair.jafter[k] - before[k] * decay).abs().max() > 1e-4}
    assert len(net) == 8 and len(moved) >= 6, moved
    stats = [k for k in after if k.endswith('running_mean') and 'backbone_2d' in k]
    assert stats and all(not torch.equal(after[k], before[k]) for k in stats)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_llal_selects_the_jax_ids(pair, monkeypatch, seed):
    """From common loss predictions (seed 0: all tied) both strategies pick
    the same ids; a model without a LossNet raises in both."""
    rng = np.random.RandomState(seed)
    fids = [str(f) for f in pair.tunlab.dataset.sample_id_list]
    preds = [np.float32(1.0)] * len(fids) if seed == 0 else \
        list(rng.rand(len(fids)).astype(np.float32))
    if seed == 2:
        preds[1] = preds[3] = max(preds)
    records = {f: {'loss_predictions': np.asarray([p])} for f, p in zip(fids, preds)}
    picked = []
    for strat in (jstrategy('llal', pair.jmodel, pair.var, pair.jlab, pair.junlab, 0,
                            str(pair.tmp), pair.jc),
                  tstrategy('llal', pair.port_model(), pair.tlab, pair.tunlab, 0,
                            str(pair.tmp), pair.tc)):
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
        picked.append([str(f) for f in strat.query(cur_epoch=0)])
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: {f: {} for f in fids})
        with pytest.raises(RuntimeError, match='LossNet'):
            strat.query(cur_epoch=0)
    assert picked[0] == picked[1] and len(set(picked[1])) == 2


def test_train_model_active_llal_cpu(tmp_path, monkeypatch):
    """``train_model_active`` with METHOD llal on the reduced PV-RCNN: before
    each round's query the LossNet is fitted over LOSS_NET_TRAIN_EPOCH
    epochs of the labelled pool; two rounds pick pool ids; every parameter
    and BN statistic finite."""
    cfg = _cfg(tload, 'llal')
    out = tmp_path / 'out'
    (out / 'ckpt').mkdir(parents=True)
    fits, real_fit = [], tactive_rt.train_loss_net

    def fit(state, model, loader, *a, **k):
        net = {n: p.clone() for n, p in model.roi_head.loss_net.named_parameters()}
        state = real_fit(state, model, loader, *a, **k)
        fits.append((len(loader.dataset), any(
            not torch.equal(p, net[n]) for n, p in model.roi_head.loss_net.named_parameters())))
        return state
    monkeypatch.setattr(tactive_rt, 'train_loss_net', fit)
    seen = []
    random.seed(0)
    state = _run(cfg, out, monkeypatch, seen)
    assert [r[:3] for r in seen] == [(0, 4, 0), (1, 4, 2), (2, 6, 0), (3, 8, 0)]
    assert fits == [(4, True), (6, True)]
    assert _finite(state.model.state_dict().values())
    picks = sorted((out / 'active_labels').glob('selected_frames_*.pkl'))
    assert len(picks) == 2

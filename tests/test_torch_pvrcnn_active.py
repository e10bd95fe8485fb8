"""The port's active-learning path on PV-RCNN vs the JAX package: the RoI
head's MC-dropout rounds, the two-stage MC scorer, the ``shared_features``
embeddings and coreset, the LossNet's forward and ``loss_pred_loss``, the
hypothetical losses, CRB's stage 2 at ``shared_fc_1`` and a whole CRB query
(llal's fitting step, picks and loop: tests/test_torch_pvrcnn_llal.py).

The reduced PV-RCNN of ``tests/test_torch_pvrcnn_train.py`` (128×128×40
grid, narrow widths, 256 keypoints, 16 RoIs on a 4³ grid, SHARED_FC [64,
64], DP_RATIO 0.3, SAMPLING_ROUND 5), with a LossNet (``LOSS_NET``) and
``EMBEDDING_REQUIRED`` on, over 9 scenes: 4 labelled, a pool of 5 at batch
2.  The Flax variables come from ``_fill(RandomState(0))`` (the cls bias
from one port forward, as ``tests/test_torch_pvrcnn_eval.py``), carried over
by ``flax_to_state_dict``.

Random draws: the port's generator never reproduces JAX's keys, so every
Dropout mask is given.  A Flax method interceptor on ``nn.Dropout`` puts a
given mask in place of the drawn one (``jnp.where(mask, x·scale, 0)``), and
the port's ``flax_dropout`` is patched to replay the same masks in the same
order (3 a tower call: the shared layer's, the cls head's, the reg head's);
a scale of 1 with every mask set is the deterministic forward.  The RoI
sample of a training forward is given too, as ``rois`` + ``roi_targets_dict``
(``make_proposals`` and the JAX sampler at a fixed key, as the train test).

JAX programs: the eval forward with the full MC scorer inlined (masks and
scale are arguments), compiled once in the module fixture, and the stage-2
``_build_grad_fn``, compiled in its test.

Tolerances (f32; the same formulas, other summation orders): floats rtol
1e-4, atol 1e-5; labels and validity exactly; the stage-2 embeddings within
1e-4 of the row's norm; picks equal (compared as ``str``).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.models.roi_heads import roi_head_template as jrht
from crb_active_3ddet_tpu.models.roi_heads.loss_net import LossNet as JLossNet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.query_strategies import crb_sampling as jcrb_mod
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.utils import loss_utils as jloss

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.models.backbones_3d import pfe as pfe_module
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.roi_heads import roi_head_template as trht
from crb_active_3ddet_torch.models.roi_heads.loss_net import LossNet as TLossNet
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.utils import loss_utils as tloss
from crb_active_3ddet_torch.utils import flax_weights as fw
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_pvrcnn_eval import _fill
from test_torch_pvrcnn_train import _reduced as _reduced_train
from test_torch_pvrcnn_train import make_proposals

CRB_CFG = 'tools/cfgs/synthetic_models/second_synth_active_crb.yaml'
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
EMB_TOL = 1e-4
S = 5                      # SAMPLING_ROUND
KEEP = ('rcnn_cls', 'rcnn_reg', 'batch_cls_preds', 'batch_box_preds', 'rois',
        'roi_labels', 'shared_features', 'loss_predictions')
MC_FLOATS = ('mc_cls_var', 'mc_box_var', 'batch_rcnn_cls', 'batch_rcnn_reg',
             'label_entropy', 'box_entropy', 'pred_density', 'loss_predictions',
             'embeddings', 'confidence_entropy')
EXACT = ('pred_labels', 'pred_valid', 'num_bbox', 'median_points')


def _cfg(load, method='crb'):
    """The reduced PV-RCNN over 9 scenes with a LossNet and the shared
    features on; 4 labelled frames, rounds of 2 (CRB: K1 2, K2 1)."""
    c = _reduced_train(load, dp=0.3)
    c.DATA_CONFIG.NUM_SCENES = 9
    c.ACTIVE_TRAIN = load(CRB_CFG).ACTIVE_TRAIN
    a = c.ACTIVE_TRAIN
    a.METHOD = method
    a.PRE_TRAIN_SAMPLE_NUMS, a.PRE_TRAIN_EPOCH_NUMS = 4, 2
    a.SELECT_NUMS, a.TOTAL_BUDGET_NUMS, a.SELECT_LABEL_EPOCH_INTERVAL = 2, 4, 1
    r = c.MODEL.ROI_HEAD
    assert r.SAMPLING_ROUND == S and r.TARGET_CONFIG.ROI_PER_IMAGE == \
        r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE == 16
    r.LOSS_NET = {'SHARED_FC': [64, 64]}
    r.EMBEDDING_REQUIRED = True
    r.LOSS_NET_TRAIN_EPOCH = 2
    return c


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


class GivenMasks:
    """The JAX interceptor and the port's replay of one list of masks."""

    def __init__(self, masks, scale):
        self.masks, self.scale = masks, scale
        self.i = 0

    @contextlib.contextmanager
    def jax(self):
        """Inside: every live Flax Dropout call takes the next mask."""
        self.i = 0

        def tap(next_fun, args, kwargs, context):
            if not isinstance(context.module, fnn.Dropout) or \
                    context.method_name != '__call__' or kwargs.get('deterministic'):
                return next_fun(*args, **kwargs)
            mask = self.masks[self.i % len(self.masks)]
            self.i += 1
            return jnp.where(mask, args[0] * self.scale, 0.0)
        with fnn.intercept_methods(tap):
            yield

    @contextlib.contextmanager
    def port(self):
        """Inside: every live port Dropout takes the next mask."""
        self.i = 0
        masks = [torch.from_numpy(np.asarray(m)) for m in self.masks]
        scale = torch.tensor(np.float32(self.scale))
        real = pfe_module.flax_dropout

        def replay(x, p, live, generator):
            if not live or p == 0:
                return x
            mask = masks[self.i % len(masks)]
            self.i += 1
            return torch.where(mask, x * scale, torch.zeros_like(x))
        pfe_module.flax_dropout = replay
        try:
            yield
        finally:
            pfe_module.flax_dropout = real


def _mask_shapes(rows, cfg):
    r = cfg.MODEL.ROI_HEAD
    return [(rows, r.SHARED_FC[0]), (rows, r.CLS_FC[0]), (rows, r.REG_FC[0])]


def _masks(seed, shapes, keep=0.7):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s) < keep for s in shapes]


class ActivePair:
    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload), _cfg(tload)
        (jlab_set, _, self.jlab, self.junlab, _, _) = jactive(
            self.jc.DATA_CONFIG, self.jc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        (tlab_set, _, self.tlab, self.tunlab, _, _) = tactive(
            self.tc.DATA_CONFIG, self.tc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        self.jset, self.tset = jlab_set, tlab_set
        self.jmodel = jdet(self.jc.MODEL, num_class=3, dataset=jlab_set)
        self.geom = (jlab_set.voxel_cfg, tuple(int(g) for g in jlab_set.grid_size),
                     tuple(float(x) for x in jlab_set.point_cloud_range),
                     tuple(float(v) for v in jlab_set.voxel_size))
        self.hosts = list(self.tunlab)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(
                r, jtrain.prepare_device_batch(h, *self.geom), training=False),
            jax.random.PRNGKey(0), jtrain.host_to_device_batch(self.hosts[0]))
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        assert 'loss_net' in var['params']['roi_head']
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.tmodel = tdet(self.tc.MODEL, num_class=3, dataset=tlab_set, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'],
                                                       self.tc.MODEL))
        self.tmodel.eval()
        with torch.no_grad():
            logits = self.tmodel(self.port_batch(self.hosts[0]))['cls_preds']
        head['bias'] = -logits.mean(dim=(0, 1, 2)).numpy()
        self.variables = var
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'],
                                                       self.tc.MODEL))
        self.tmp = tmp
        rows = 2 * 16
        self.live = GivenMasks(_masks(0, _mask_shapes(rows, self.tc) * S), np.float32(1 / 0.7))
        self.still = GivenMasks([np.ones(s, bool) for s in _mask_shapes(rows, self.tc) * S],
                                np.float32(1.0))

        # the eval forward and the full MC scorer, one program
        score = self.jax_strategy('montecarlo').build_score_fn(True, S, signals=None)
        score = getattr(score, '__wrapped__', score)
        jmodel, geom, given = self.jmodel, self.geom, GivenMasks(None, None)

        @jax.jit
        def jfwd(v, hb, rng, masks, scale):
            given.masks, given.scale = masks, scale
            with given.jax():
                out = jmodel.apply(v, jtrain.prepare_device_batch(hb, *geom),
                                   training=False, rngs={'dropout': rng})
            with given.jax():
                sig = score(v, hb, rng)
            return {k: out[k] for k in KEEP}, sig
        self.jfwd = jfwd
        self.jout, self.jrec, self.jlab_emb = [], {}, []
        for host in self.hosts:
            out, sig = jax.tree.map(np.asarray, self.run_jax(host, self.live))
            self.jout.append(out)
            for i, fid in enumerate(host['frame_id']):
                self.jrec[str(fid)] = {k: v[i] for k, v in sig.items()}
        # the labelled loader shuffles and augments: one draw of it for both
        self.lab_hosts = list(self.tlab)
        for host in self.lab_hosts:
            out, _ = self.run_jax(host, self.still)
            self.jlab_emb.append(np.asarray(out['shared_features']).reshape(2, -1))
        self.jstill = [jax.tree.map(np.asarray, self.run_jax(h, self.still))
                       for h in self.hosts]

    def run_jax(self, host, given):
        return self.jfwd(self.variables, jtrain.host_to_device_batch(host),
                         jax.random.PRNGKey(0), given.masks, given.scale)

    def port_batch(self, host):
        return ttrain.prepare_device_batch(ttrain.host_to_device_batch(host, 'cpu'),
                                           *self.geom)

    def port_strategy(self, method='crb', cfg=None):
        return tstrategy(method, self.tmodel, self.tlab, self.tunlab, 0,
                         str(self.tmp), cfg or self.tc)

    def jax_strategy(self, method='crb', cfg=None):
        return jstrategy(method, self.jmodel, self.variables, self.jlab,
                         self.junlab, 0, str(self.tmp), cfg or self.jc)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Many small ops a forward: one torch thread a worker (as
    tests/test_torch_crb.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair(tmp_path_factory, one_torch_thread):
    return ActivePair(tmp_path_factory.mktemp('pvrcnn_active'))


# ---- the head's MC rounds and the two-stage scorer --------------------------

def test_head_mc_rounds_match_jax(pair):
    """An eval forward given a generator runs SAMPLING_ROUND tower rounds
    with live Dropout (the JAX masks replayed); the decoded predictions, the
    shared features and the LossNet read round 1."""
    for host, jout in zip(pair.hosts, pair.jout):
        with pair.live.port(), torch.no_grad():
            out = pair.tmodel(pair.port_batch(host), torch.Generator())
        assert pair.live.i == 3 * S
        assert out['rcnn_cls'].shape == (S, 32, 1) and out['rcnn_reg'].shape == (S, 32, 7)
        for k in KEEP:
            if k == 'roi_labels':
                np.testing.assert_array_equal(_np(out[k]), jout[k])
            else:
                np.testing.assert_allclose(_np(out[k]), jout[k], **FLOAT_TOL, err_msg=k)
        # the rounds differ; the decoded scores are round 1's
        assert np.ptp(_np(out['rcnn_cls']), axis=0).max() > 1e-3
        np.testing.assert_array_equal(_np(out['batch_cls_preds']).reshape(-1),
                                      _np(out['rcnn_cls'][0]).reshape(-1))
    assert not any(m.training for m in pair.tmodel.modules())


def test_head_without_generator_runs_one_deterministic_round(pair):
    for host, (jout, _) in zip(pair.hosts, pair.jstill):
        with torch.no_grad():
            out = pair.tmodel(pair.port_batch(host))
        assert out['rcnn_cls'].shape == (32, 1)
        for k in ('batch_cls_preds', 'batch_box_preds', 'shared_features',
                  'loss_predictions'):
            np.testing.assert_allclose(_np(out[k]), jout[k], **FLOAT_TOL, err_msg=k)
        np.testing.assert_allclose(_np(out['rcnn_cls']), jout['rcnn_cls'][0], **FLOAT_TOL)


def test_two_stage_mc_scorer_matches_jax(pair):
    """mc_cls_var, mc_box_var (the encoded rcnn_reg's), batch_rcnn_cls
    (the mean sigmoid, (R, 1)), batch_rcnn_reg, and the round-1
    predictions after the NMS: labels and validity exactly."""
    strat = pair.port_strategy('montecarlo')
    with pair.live.port():
        trec = strat.scan_pool(mc_dropout=True, num_mc=S)
    assert list(trec) == list(pair.jrec) and len(trec) == 5
    for fid, jr in pair.jrec.items():
        assert set(trec[fid]) == set(jr), fid
        for k in MC_FLOATS:
            np.testing.assert_allclose(trec[fid][k], jr[k], **FLOAT_TOL, err_msg=f'{fid} {k}')
        for k in EXACT:
            np.testing.assert_array_equal(trec[fid][k], jr[k], err_msg=f'{fid} {k}')
        assert trec[fid]['batch_rcnn_cls'].shape == (16, 1)
        assert trec[fid]['batch_rcnn_reg'].shape == (16, 7)
        assert trec[fid]['embeddings'].shape == (16 * 64,)
    assert min(int(r['pred_valid'].sum()) for r in trec.values()) > 0
    assert min(float(r['mc_cls_var']) for r in trec.values()) > 0


def test_embeddings_and_coreset_match_jax(pair, monkeypatch):
    """``embeddings`` are the deterministic shared features (B, R·C); the
    port's coreset query, unpatched, picks the ids of the JAX query given
    the JAX embeddings of the pool and of the labelled set."""
    strat = pair.port_strategy('coreset')
    trec = strat.scan_pool(signals=('embeddings',))
    for (_, jsig), host in zip(pair.jstill, pair.hosts):
        for i, fid in enumerate(host['frame_id']):
            np.testing.assert_allclose(trec[str(fid)]['embeddings'], jsig['embeddings'][i],
                                       **FLOAT_TOL)
    strat = pair.port_strategy('coreset')
    strat.labelled_loader = pair.lab_hosts
    got = strat.query(cur_epoch=0)
    jstrat = pair.jax_strategy('coreset')
    records = {fid: {**r, 'embeddings': sig['embeddings'][i]}
               for (_, sig), host in zip(pair.jstill, pair.hosts)
               for i, (fid, r) in enumerate(
                   (str(f), pair.jrec[str(f)]) for f in host['frame_id'])}
    monkeypatch.setattr(jstrat, 'scan_pool', lambda *a, **k: records)
    calls = iter(pair.jlab_emb)
    jstrat._score_fns[(False, 0, frozenset(('embeddings',)))] = \
        lambda v, b, r: {'embeddings': next(calls)}
    want = [str(f) for f in jstrat.query(cur_epoch=0)]
    assert got == want and len(set(got)) == 2


# ---- CRB: stage 2 at shared_fc_1, the query --------------------------------

def _chunk_targets(host, key):
    """RoIs a frame from the frame's gt boxes, sampled by the JAX sampler at
    ``key`` (test_torch_pvrcnn_train.make_proposals)."""
    props = make_proposals(host['gt_boxes'], np.random.RandomState(1))
    t = jrht.assign_targets(key, dict(props), _cfg(jload).MODEL.ROI_HEAD.TARGET_CONFIG)
    return jax.tree.map(np.asarray, t)


def test_stage2_embeddings_match_jax(pair, monkeypatch):
    """The port's ``grad_embeddings`` over four pool frames against the JAX
    ``_build_grad_fn`` (chunk 2): one common RoI sample a frame (given as
    ``rois`` + ``roi_targets_dict``), the same Dropout masks, the stage-1
    MC means as targets; each row within 1e-4 of its norm.  Every
    parameter, buffer, flag and ``requires_grad`` as before."""
    frames = list(pair.jrec)[:4]
    jstrat, tstrat = pair.jax_strategy(), pair.port_strategy()
    given = GivenMasks(_masks(3, _mask_shapes(16, pair.tc)), np.float32(1 / 0.7))
    targets, rows = {}, {}
    for i0 in (0, 2):
        t = _chunk_targets(jtrain.host_to_device_batch(jstrat._load_frames(frames[i0:i0 + 2])),
                           jax.random.PRNGKey(5 + i0))
        for j, fid in enumerate(frames[i0:i0 + 2]):
            rows[fid] = {k: v[j:j + 1] for k, v in t.items()}
        targets[(i0, 'rois')] = t
    hyp = {f: (pair.jrec[f]['batch_rcnn_cls'], pair.jrec[f]['batch_rcnn_reg']) for f in frames}
    # the JAX grad_fn slices every batch entry per frame: the targets ride
    # as flat entries, and an interceptor hands the head its dict
    real_prep = jcrb_mod.prepare_device_batch

    def prep(hb, *geom):
        return {**real_prep(hb, *geom), **{k: v for k, v in hb.items()
                                           if k == 'rois' or k.startswith('rt_')}}

    def tap(next_fun, args, kwargs, context):
        if context.method_name == '__call__' and context.module.name == 'roi_head':
            b = dict(args[0])
            b['roi_targets_dict'] = {k[3:]: b.pop(k) for k in list(b) if k.startswith('rt_')}
            args = (b,) + tuple(args[1:])
        return next_fun(*args, **kwargs)
    monkeypatch.setattr(jcrb_mod, 'prepare_device_batch', prep)
    with given.jax(), fnn.intercept_methods(tap):
        grad_fn = jstrat._build_grad_fn(2)
        want = []
        for i0 in (0, 2):
            fids = frames[i0:i0 + 2]
            hb = dict(jstrat._load_frames(fids))
            t = targets[(i0, 'rois')]
            hb.update({'rois': t['rois'], **{f'rt_{k}': v for k, v in t.items()}})
            g = grad_fn(pair.variables, hb, jax.random.PRNGKey(1),
                        {'cls': np.stack([hyp[f][0] for f in fids]),
                         'reg': np.stack([hyp[f][1] for f in fids])})
            want += list(np.asarray(g))
    want = np.stack(want)

    real_frames = tstrat.single_frames

    def single_frames(ids, drop=()):
        for fid, b1 in zip(ids, real_frames(ids, drop)):
            t = {k: torch.from_numpy(np.array(v)) for k, v in rows[fid].items()}
            yield {**b1, 'rois': t['rois'], 'roi_targets_dict': t}
    monkeypatch.setattr(tstrat, 'single_frames', single_frames)
    before = _state(pair.tmodel)
    with given.port():
        got = tstrat.grad_embeddings(frames, hyp)
    assert given.i == 3 * len(frames)
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 64 * 64)
    norm = np.linalg.norm(want, axis=1)
    err = np.abs(got - want).max(axis=1)
    assert (norm > 0).all() and (err <= EMB_TOL * norm).all(), (err, norm)
    assert np.ptp(norm) > 1e-3 * norm.max()
    after = pair.tmodel.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(m.training for m in pair.tmodel.modules())
    assert all(p.requires_grad for p in pair.tmodel.parameters())


def test_stage2_gradient_is_autograd_at_shared_fc_1(pair, monkeypatch):
    """One frame's embedding is autograd's gradient of the hypothetical loss
    through the whole training forward at ``shared_fc_layer.4.weight``, in
    the Flax (in, out) order."""
    fid = list(pair.jrec)[1]
    hyp = {fid: (pair.jrec[fid]['batch_rcnn_cls'], pair.jrec[fid]['batch_rcnn_reg'])}
    strat = pair.port_strategy()
    (b1,) = list(strat.single_frames([fid]))
    model = tdet(pair.tc.MODEL, num_class=3, dataset=pair.tset, device='cpu')
    model.load_state_dict(pair.tmodel.state_dict())
    model.train()
    out = model(b1, torch.Generator().manual_seed(1))
    cls, reg = out['rcnn_cls'].reshape(-1), out['rcnn_reg'].reshape(-1, 7)
    loss = trht.get_box_cls_layer_loss_hyp(cls, torch.from_numpy(hyp[fid][0])) \
        + trht.get_box_reg_layer_loss_hyp(reg, torch.from_numpy(hyp[fid][1])).mean()
    (g,) = torch.autograd.grad(loss, model.roi_head.shared_fc_layer[4].weight)
    got = strat.grad_embeddings([fid], hyp)[0]
    np.testing.assert_allclose(got, g[:, :, 0].t().reshape(-1).numpy(), rtol=1e-5, atol=1e-8)


def _common(pair, seed):
    rng = np.random.RandomState(seed)
    rec, emb = {}, {}
    for fid, r in pair.jrec.items():
        rec[fid] = dict(r)
        rec[fid]['label_entropy'] = np.float32(0.0 if seed == 0 else rng.rand())
        rec[fid]['pred_density'] = rng.uniform(0, 120, r['pred_density'].shape) \
            .astype(np.float32)
        rec[fid]['loss_predictions'] = np.float32(rng.rand() if seed != 0 else 1.0)
        emb[fid] = rng.randn(64 * 64).astype(np.float32)
    return rec, emb


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_crb_query_selects_the_jax_ids(pair, monkeypatch, seed):
    """From one common set of MC records and embeddings both CRB queries on
    PV-RCNN pick the same ids; the port's stage 2 gets the records' MC means
    as its targets."""
    records, emb = _common(pair, seed)
    jstrat, tstrat = pair.jax_strategy(), pair.port_strategy()
    loaded, seen = [], {}
    for strat in (jstrat, tstrat):
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
    monkeypatch.setattr(jstrat, '_load_frames', lambda ids: loaded.append(list(ids)))
    jstrat._grad_fns[2] = lambda v, b, r, t: np.stack([emb[str(f)] for f in loaded[-1]])

    def grads(ids, targets=None):
        seen['targets'] = targets
        return np.stack([emb[f] for f in ids])
    monkeypatch.setattr(tstrat, 'grad_embeddings', grads)
    want = [str(f) for f in jstrat.query(cur_epoch=0)]
    got = tstrat.query(cur_epoch=0)
    assert got == want and len(set(got)) == 2
    assert set(seen['targets']) == set(records)
    for fid, (c, r) in seen['targets'].items():
        assert c is records[fid]['batch_rcnn_cls'] and r is records[fid]['batch_rcnn_reg']


def test_crb_query_leaves_every_buffer_and_parameter(pair):
    """An unpatched CRB query on PV-RCNN: stage 2's training forwards update
    the BN statistics in place and take the gradient at one weight; every
    buffer and parameter is bit-equal afterwards, and the flags as before."""
    before = _state(pair.tmodel)
    strat = pair.port_strategy()
    sel = strat.query(cur_epoch=0)
    assert len(set(sel)) == 2 and set(sel) <= set(pair.jrec)
    after = pair.tmodel.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], v)
                                             for k, v in before.items())
    assert all(p.requires_grad for p in pair.tmodel.parameters())
    assert not any(m.training for m in pair.tmodel.modules())
    assert set(strat.stage_times) == {'crb_stage1_s', 'crb_stage2_s', 'crb_stage3_s'}


# ---- the hypothetical losses, the LossNet and llal --------------------------

def test_hypothetical_losses_match_jax():
    rng = np.random.RandomState(4)
    cls = (rng.randn(48, 1) * 3).astype(np.float32)
    hyp_cls = rng.uniform(0, 1, (48, 1)).astype(np.float32)
    reg = rng.randn(48, 7).astype(np.float32) * 0.3
    hyp_reg = rng.randn(48, 7).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        _np(trht.get_box_cls_layer_loss_hyp(torch.from_numpy(cls), torch.from_numpy(hyp_cls))),
        np.asarray(jrht.get_box_cls_layer_loss_hyp(cls, hyp_cls, None)), rtol=1e-6)
    got = _np(trht.get_box_reg_layer_loss_hyp(torch.from_numpy(reg), torch.from_numpy(hyp_reg)))
    want = np.asarray(jrht.get_box_reg_layer_loss_hyp(reg, hyp_reg, None))
    assert got.shape == want.shape == (48 * 7,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # both branches of the smooth-L1
    assert (np.abs(reg - hyp_reg) < 1 / 9).any() and (np.abs(reg - hyp_reg) > 1 / 9).any()


@pytest.mark.parametrize('b', [1, 2, 5, 8])
def test_loss_pred_loss_matches_jax(b):
    """Frame i paired with b/2 + i, an odd last frame dropped (b = 1: the
    mean of nothing, NaN in both); equal true losses count as -1."""
    rng = np.random.RandomState(b)
    inp = rng.randn(b).astype(np.float32)
    tgt = rng.rand(b).astype(np.float32)
    if b == 8:
        tgt[4] = tgt[0]
    got = float(tloss.loss_pred_loss(torch.from_numpy(inp), torch.from_numpy(tgt)))
    want = float(jloss.loss_pred_loss(inp, tgt))
    if b == 1:
        assert np.isnan(got) and np.isnan(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize('training', [False, True])
def test_loss_net_forward_matches_jax(training):
    """The LossNet alone from the JAX module's variables: (B,) predictions,
    in training the Flax batch statistics and the running ones updated."""
    cfg = _cfg(tload).MODEL.ROI_HEAD
    rng = np.random.RandomState(7)
    latents = [np.maximum(rng.randn(3 * 16, 64), 0).astype(np.float32) for _ in range(2)]
    jnet = JLossNet(model_cfg=None)
    shapes = jax.eval_shape(lambda r: jnet.init(r, latents, batch_size=3), jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(8)), shapes)
    if training:
        want, mutated = jnet.apply(var, latents, batch_size=3, training=True,
                                   mutable=['batch_stats'])
    else:
        want, mutated = jnet.apply(var, latents, batch_size=3), None
    net = TLossNet(cfg.SHARED_FC, 16)
    sd = {}
    for k in range(2):
        sd[f'conv_layers.{k}.0.weight'] = fw._dense(var['params'][f'conv_{k}']['kernel'], 1)
        fw._bn(sd, f'conv_layers.{k}.1', var['params'][f'bn_{k}'], var['batch_stats'][f'bn_{k}'])
    sd['linear.weight'] = fw._dense(var['params']['linear']['kernel'])
    sd['linear.bias'] = var['params']['linear']['bias']
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    net.train(training)
    got = net([torch.from_numpy(x) for x in latents], 3)
    assert got.shape == (3,)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FLOAT_TOL)
    if training:
        for k in range(2):
            bn = net.conv_layers[k][1]
            st = mutated['batch_stats'][f'bn_{k}']
            np.testing.assert_allclose(_np(bn.running_mean), st['mean'], atol=1e-6)
            np.testing.assert_allclose(_np(bn.running_var), st['var'], atol=1e-6)

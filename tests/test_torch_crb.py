"""The port's CRB query (and the MC-dropout strategies montecarlo and bald)
vs the JAX package: the MC-dropout scorer's one-stage branch, the stage-2
gradient embeddings, the k-means++ copy against scikit-learn, GPDB's device
and host forms against the JAX host oracle, the whole query from common
records and end to end, and ``train_model_active`` with METHOD crb.

The reduced SECOND of ``tests/test_torch_active.py`` (``_cfg``, method
``'crb'``: 9 scenes, 4 labelled, a pool of 5 at batch 2, SELECT_NUMS 2, K1 2,
K2 1, kmeans++) with the Flax variables of ``_fill(RandomState(0))``, the cls
bias at 0, carried over by ``flax_to_state_dict``.  The JAX MC scorer and
the JAX stage-2 gradient are compiled once, in a module-scoped fixture, where
each package's query also runs once end to end (the JAX one's scan gives the
JAX MC records).

Tolerances (f32; same formulas, other summation orders): the MC records'
floats rtol 1e-4, atol 1e-5, labels and validity exactly, as
``test_torch_active.py``; each stage-2 embedding within 1e-5 + 1e-4 of its
row's norm; k-means++ indices, GPDB picks and the queries' ids equal (the
JAX query returns ``np.str_``, the port plain ``str``: compared as ``str``).
"""

import random
import warnings

import jax
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use (the loop test steps
# the port's optimizer); import it while collecting, before
# tests/test_vis_html.py puts tools/ (and its profile.py) on sys.path
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import CfgNode as JCfgNode
from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.query_strategies.crb_sampling import CRBSampling as JCRB
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import CfgNode as TCfgNode
from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.query_strategies import crb_sampling as tcrb_mod
from crb_active_3ddet_torch.query_strategies import strategy as tstrategy_mod
from crb_active_3ddet_torch.query_strategies.crb_sampling import CRBSampling as TCRB
from crb_active_3ddet_torch.query_strategies.kmeans_pp import kmeans_plusplus
from crb_active_3ddet_torch.runtime import active as tactive_rt
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_active import _cfg, _finite, _run
from test_torch_second_eval import _fill

FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
CRB_SIGNALS = ('label_entropy', 'pred_density', 'pred_labels', 'pred_valid',
               'batch_rcnn_cls', 'batch_rcnn_reg')
MC_SIGNALS = CRB_SIGNALS + ('mc_cls_var', 'mc_box_var')
FLOATS = ('label_entropy', 'pred_density', 'mc_cls_var', 'mc_box_var')
EXACT = ('pred_labels', 'pred_valid', 'num_bbox', 'median_points')


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


class CRBPair:
    """The JAX and the port CRB strategy over one pool, from the same
    weights: the MC scan of each, and one unpatched query of each."""

    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload, 'crb'), _cfg(tload, 'crb')
        (jlab_set, _, self.jlab, self.junlab, _, _) = jactive(
            self.jc.DATA_CONFIG, self.jc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        (tlab_set, _, self.tlab, self.tunlab, _, _) = tactive(
            self.tc.DATA_CONFIG, self.tc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        self.jmodel = jdet(self.jc.MODEL, num_class=3, dataset=jlab_set)
        host = next(iter(self.tunlab))
        geom = (jlab_set.voxel_cfg, tuple(int(g) for g in jlab_set.grid_size),
                tuple(float(x) for x in jlab_set.point_cloud_range),
                tuple(float(v) for v in jlab_set.voxel_size))
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(
                r, jtrain.prepare_device_batch(h, *geom), training=False),
            jax.random.PRNGKey(0), jtrain.host_to_device_batch(host))
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.variables = var
        self.tmodel = tdet(self.tc.MODEL, num_class=3, dataset=tlab_set, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats']))
        self.tmodel.eval()
        self.tmp = tmp
        self.jstrat = self.jax_strategy()
        self.tstrat = self.port_strategy()
        assert self.jstrat.mesh is None
        # each package's MC scan is its query's own: the scorer is built at
        # CRB's signals + mc_* (a superset of what the query reads), so that
        # it compiles and runs once, and a pass-through keeps its records
        recs = []
        for strat in (self.jstrat, self.tstrat):
            strat._score_fns[(True, 5, frozenset(CRB_SIGNALS))] = \
                strat.build_score_fn(True, 5, signals=frozenset(MC_SIGNALS))
            scan, seen = strat.scan_pool, {}
            strat.scan_pool = lambda *a, _s=scan, _r=seen, **k: _r.setdefault('rec', _s(*a, **k))
            recs.append(seen)
        # one query each, end to end; the port's buffers and flags around it
        self.before = _state(self.tmodel)
        self.jpick = [str(f) for f in self.jstrat.query(cur_epoch=0)]
        self.tpick = self.tstrat.query(cur_epoch=0)
        self.jrec, self.trec = recs[0]['rec'], recs[1]['rec']
        self.after = _state(self.tmodel)
        self.training_after = {m.training for m in self.tmodel.modules()}

    def port_strategy(self, method='crb', cfg=None):
        return tstrategy(method, self.tmodel, self.tlab, self.tunlab, 0,
                         str(self.tmp), cfg or self.tc)

    def jax_strategy(self, method='crb', cfg=None):
        return jstrategy(method, self.jmodel, self.variables, self.jlab,
                         self.junlab, 0, str(self.tmp), cfg or self.jc)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """This module's torch ops run on one thread: its many small ops
    (five forwards a scored batch) otherwise wait at every op's thread
    barrier when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair(tmp_path_factory, one_torch_thread):
    return CRBPair(tmp_path_factory.mktemp('crb'))


# ---- the MC-dropout scorer's one-stage branch ------------------------------

def test_mc_scorer_matches_jax(pair):
    jrec, trec = pair.jrec, pair.trec
    assert list(trec) == list(jrec) and len(trec) == 5
    for fid in jrec:
        # batch_rcnn_* emit nothing on a one-stage model, in both packages
        assert set(trec[fid]) == set(jrec[fid])
        assert not {'batch_rcnn_cls', 'batch_rcnn_reg'} & set(trec[fid])
        for k in FLOATS:
            np.testing.assert_allclose(trec[fid][k], np.asarray(jrec[fid][k]),
                                       **FLOAT_TOL, err_msg=f'{fid} {k}')
        for k in EXACT:
            np.testing.assert_array_equal(trec[fid][k], np.asarray(jrec[fid][k]),
                                          err_msg=f'{fid} {k}')
    kept = [int(r['pred_valid'].sum()) for r in trec.values()]
    assert min(kept) > 0
    # five equal forwards: the variances are rounding-sized
    assert max(float(r['mc_cls_var']) for r in trec.values()) < 1e-10


def test_mc_scorer_forwards_and_generator(pair, monkeypatch):
    """num_mc forwards a batch, each given one generator seeded MC_SEED;
    num_mc=1 one forward and no MC signals; the logit of the clipped MC mean
    replaces ``batch_cls_preds`` before the NMS."""
    strat = pair.port_strategy('entropy')
    seen, nms_in = [], []
    hook = strat.model.register_forward_pre_hook(
        lambda m, args: seen.append(args[1] if len(args) > 1 else None))
    real = tstrategy_mod.pp.post_processing

    def captured(out, *a, **k):
        nms_in.append((out['batch_cls_preds'], out.get('mc_cls_mean')))
        return real(out, *a, **k)
    monkeypatch.setattr(tstrategy_mod.pp, 'post_processing', captured)
    try:
        one = strat.scan_pool(mc_dropout=True, num_mc=1,
                              signals=('box_entropy', 'mc_cls_var'))
        n_one = len(seen)
        two = strat.scan_pool(mc_dropout=True, num_mc=2,
                              signals=('label_entropy', 'mc_cls_var'))
    finally:
        hook.remove()
    assert n_one == 3 and len(seen) == 3 + 6
    assert all(isinstance(g, torch.Generator) for g in seen)
    assert len({id(g) for g in seen[:3]}) == 1 and len({id(g) for g in seen[3:]}) == 1
    assert all(set(r) == {'box_entropy', 'num_bbox', 'mean_points', 'median_points',
                          'variance_points'} for r in one.values())
    for fid, r in two.items():
        assert set(r) == {'label_entropy', 'mc_cls_var', 'num_bbox', 'mean_points',
                          'median_points', 'variance_points'}
        np.testing.assert_allclose(r['label_entropy'], pair.trec[fid]['label_entropy'],
                                   **FLOAT_TOL)
    # equal forwards: the mean is the one forward's sigmoid, and the NMS
    # ranks the logit of its clip
    assert len(nms_in) == 3 + 3
    for (raw, none), (mc, mean) in zip(nms_in[:3], nms_in[3:]):
        assert none is None and mean is not None
        torch.testing.assert_close(mean, torch.sigmoid(raw), rtol=0, atol=1e-7)
        torch.testing.assert_close(mc, torch.logit(torch.clamp(mean, 1e-6, 1 - 1e-6)),
                                   rtol=0, atol=0)
        assert float(mean.min()) < 0.5 < float(mean.max())


# ---- stage 2: the gradient embeddings --------------------------------------

def test_grad_embeddings_match_jax(pair):
    """The port's embeddings of every pool frame against the JAX
    ``_build_grad_fn`` the unpatched query compiled (chunk 2, padded with
    the last frame), row by row; the model's state and flags as before."""
    frames = list(pair.trec)
    chunk = pair.tstrat.grad_chunk()
    assert chunk == 2 and chunk in pair.jstrat._grad_fns
    grad_fn = pair.jstrat._grad_fns[chunk]
    want, rng = [], jax.random.PRNGKey(1)
    for i0 in range(0, len(frames), chunk):
        fids = frames[i0:i0 + chunk]
        load = fids + [fids[-1]] * (chunk - len(fids))
        rng, sub = jax.random.split(rng)
        g = np.asarray(grad_fn(pair.variables, pair.jstrat._load_frames(load), sub, {}))
        want += [g[j].reshape(-1) for j in range(len(fids))]
    want = np.stack(want)
    before = _state(pair.tmodel)
    got = pair.tstrat.grad_embeddings(frames)
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 32 * 18)
    norm = np.linalg.norm(want, axis=1)
    assert (norm > 0).all()
    err = np.abs(got - want).max(axis=1)
    assert (err <= EMB_TOL['atol'] + EMB_TOL['rtol'] * norm).all(), (err, norm)
    # the frames differ: the rows are not one vector
    assert np.ptp(norm) > 1e-3 * norm.max()
    after = pair.tmodel.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(m.training for m in pair.tmodel.modules())


def test_grad_embedding_is_the_train_mode_head_gradient(pair):
    """One frame's embedding is autograd's gradient of the whole train-mode
    forward's cls loss at conv_cls.weight, in the Flax kernel's order."""
    from crb_active_3ddet_torch.models.dense_heads import anchor_head_single as ahs
    from crb_active_3ddet_torch.runtime.train import (host_to_device_batch,
                                                      prepare_device_batch)
    fid = list(pair.trec)[2]
    ds = pair.tunlab.dataset
    model = tdet(pair.tc.MODEL, num_class=3, dataset=ds, device='cpu')
    model.load_state_dict(pair.tmodel.state_dict())
    model.train()
    batch = prepare_device_batch(
        host_to_device_batch(pair.tstrat._load_frames([fid]), 'cpu'),
        ds.voxel_cfg, ds.grid_size, ds.point_cloud_range, ds.voxel_size)
    del batch['gt_boxes']
    out = model(batch)
    labels = out['cls_preds'].detach().reshape(1, -1, 3).argmax(-1)
    loss = ahs.get_cls_layer_loss(out, model.dense_head, new_data={
        'cls_preds': out['cls_preds'], 'box_cls_labels': labels})
    (g,) = torch.autograd.grad(loss, model.dense_head.conv_cls.weight)
    want = g.permute(2, 3, 1, 0).reshape(-1).numpy()
    got = pair.tstrat.grad_embeddings([fid])[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---- k-means++ -------------------------------------------------------------

def _kmeans_data(case):
    rng = np.random.RandomState(case[0])
    kind, (n, d, k) = case[1], case[2:]
    x = rng.randn(n, d).astype(np.float32)
    if kind == 'duplicates':
        x[1::2] = x[0]
    elif kind == 'collapsed':
        x[:n // 2] = x[0]
    elif kind == 'scaled':
        x *= rng.uniform(1e-4, 1e2, (n, 1)).astype(np.float32)
    return x, k


@pytest.mark.parametrize('case', [
    (0, 'plain', 8, 9216, 4), (1, 'plain', 24, 64, 6), (2, 'plain', 200, 32, 12),
    (3, 'plain', 5, 3, 5), (4, 'duplicates', 16, 40, 6), (5, 'collapsed', 30, 12, 8),
    (6, 'scaled', 50, 576, 10), (7, 'plain', 600, 1024, 3)])
def test_kmeans_plusplus_equals_sklearn(case):
    sklearn_cluster = pytest.importorskip('sklearn.cluster')
    x, k = _kmeans_data(case)
    want = sklearn_cluster.kmeans_plusplus(x, n_clusters=k, random_state=0)[1]
    got = kmeans_plusplus(x, k, random_state=0)
    np.testing.assert_array_equal(got, want)
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(
        kmeans_plusplus(x64, k, random_state=3),
        sklearn_cluster.kmeans_plusplus(x64, n_clusters=k, random_state=3)[1])


# ---- stage 3: GPDB ---------------------------------------------------------

def _gpdb_strategies(device):
    """A JAX host oracle and the port's device and host forms, without
    models (the port's device form reads ``model.device``)."""
    out = {}
    for name, cls, cfg, on_device in (('jax', JCRB, JCfgNode, False),
                                      ('device', TCRB, TCfgNode, True),
                                      ('host', TCRB, TCfgNode, False)):
        s = object.__new__(cls)
        s.bandwidth, s.alpha = 5, 0.95
        s.cfg = cfg({'ACTIVE_TRAIN': {'GPDB_DEVICE': on_device}})
        s.model = type('M', (), {'device': device})()
        out[name] = s
    return out


def _fabricate(seed, n_frames=24, num_class=3, absent=None, empty=0):
    """As tests/test_gpdb_device.py: per frame 1-11 densities in [0, 120)
    and labels 1..C; ``absent`` drops a class everywhere; ``empty`` frames
    keep no box."""
    rng = np.random.RandomState(seed)
    density_list, label_list = {}, {}
    for i in range(n_frames):
        n = 0 if i < empty else rng.randint(1, 12)
        labels = rng.randint(1, num_class + 1, n)
        if absent is not None:
            labels[labels == absent] = absent % num_class + 1
        density_list[f'f{i}'] = rng.uniform(0, 120, n)
        label_list[f'f{i}'] = labels
    return density_list, label_list


@pytest.mark.parametrize('seed, absent, empty', [(0, None, 0), (7, None, 0),
                                                 (3, 2, 0), (5, None, 24), (11, None, 9)])
def test_gpdb_device_and_host_match_jax_oracle(seed, absent, empty):
    dens, labels = _fabricate(seed, absent=absent, empty=empty)
    frames = list(dens)
    k2 = frames[::2] if empty != 9 else frames[4:16]
    picks = {name: s._gpdb(list(k2), dens, labels, 3, 6)
             for name, s in _gpdb_strategies(torch.device('cpu')).items()}
    assert picks['device'] == picks['host'] == picks['jax']
    assert len(set(picks['jax'])) == 6
    if empty == 24:
        assert picks['jax'] == k2[:6]      # every candidate scores 0: in order


def test_gpdb_degenerate_prior_as_jax():
    """More than 95 % of a class's densities below 1 (boxes that hold no
    point): its prior's bounds meet and its 1e-6-wide support misses every
    grid point.  Both packages' host oracles then score NaN and fail alike;
    the device forms score the class's KL 0 and pick the same frames."""
    dens, labels = _fabricate(2)
    for f in dens:
        dens[f] = np.where(labels[f] == 2, 0.25 * dens[f] / 120, dens[f])
    frames = list(dens)[:10]
    strats = _gpdb_strategies(torch.device('cpu'))
    x_axis, prior = strats['device']._gpdb_prior(dens, labels, 3)
    assert [pk.sum() > 0 for pk in prior] == [True, False, True]
    errors = []
    for name in ('jax', 'host'):
        with pytest.raises(TypeError) as e:
            strats[name]._gpdb(list(frames), dens, labels, 3, 4)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    strats['jax'].cfg = JCfgNode({'ACTIVE_TRAIN': {'GPDB_DEVICE': True}})
    want = strats['jax']._gpdb(list(frames), dens, labels, 3, 4)
    assert strats['device']._gpdb(list(frames), dens, labels, 3, 4) == want


# ---- the whole query -------------------------------------------------------

def _common(pair, seed):
    """The port's MC records with seeded label entropies (seed 0: all 0, the
    loop's tie), densities, MC variances and box entropies, and one seeded
    embedding a frame (seed 2: all equal, so k-means++ collapses)."""
    rng = np.random.RandomState(seed)
    rec, emb = {}, {}
    for fid, r in pair.trec.items():
        rec[fid] = dict(r)
        rec[fid]['label_entropy'] = np.float32(0.0 if seed == 0 else rng.rand())
        rec[fid]['pred_density'] = rng.uniform(0, 120, r['pred_density'].shape) \
            .astype(np.float32)
        rec[fid]['mc_cls_var'] = np.float32(rng.rand())
        rec[fid]['mc_box_var'] = np.float32(rng.rand())
        rec[fid]['box_entropy'] = np.float32(rng.rand())
        emb[fid] = np.ones(576, np.float32) if seed == 2 else \
            rng.randn(576).astype(np.float32)
    return rec, emb


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
@pytest.mark.parametrize('gpdb_device', [True, False])
@pytest.mark.parametrize('clustering', ['kmeans++', 'kmeans', 'birch', 'gmm'])
def test_query_selects_the_jax_ids(pair, monkeypatch, seed, gpdb_device, clustering):
    """From one common set of records and embeddings both CRB queries pick
    the same ids, for each ``CLUSTERING`` (the JAX query's scikit-learn
    estimators, the port's numpy copies); the embeddings reach JAX through
    its per-chunk gradient function, the port through ``grad_embeddings``.
    Seed 2's equal embeddings collapse every clustering to one frame, which
    the stage-1 ranking backfills."""
    records, emb = _common(pair, seed)
    jc, tc = _cfg(jload, 'crb'), _cfg(tload, 'crb')
    jc.ACTIVE_TRAIN.GPDB_DEVICE = tc.ACTIVE_TRAIN.GPDB_DEVICE = gpdb_device
    jc.ACTIVE_TRAIN.ACTIVE_CONFIG.CLUSTERING = clustering
    tc.ACTIVE_TRAIN.ACTIVE_CONFIG.CLUSTERING = clustering
    jstrat, tstrat = pair.jax_strategy(cfg=jc), pair.port_strategy(cfg=tc)
    loaded = []
    for strat in (jstrat, tstrat):
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
    monkeypatch.setattr(jstrat, '_load_frames', lambda ids: loaded.append(list(ids)))
    jstrat._grad_fns[2] = lambda v, b, r, t: np.stack([emb[str(f)] for f in loaded[-1]])
    monkeypatch.setattr(tstrat, 'grad_embeddings',
                        lambda ids: np.stack([emb[f] for f in ids]))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # fewer clusters than asked, in both
        want = [str(f) for f in jstrat.query(cur_epoch=0)]
        got = tstrat.query(cur_epoch=0)
    assert got == want and len(set(got)) == 2
    assert all(type(f) is str for f in got)
    assert set(tstrat.stage_times) == set(jstrat.stage_times) == {
        'crb_stage1_s', 'crb_stage2_s', 'crb_stage3_s'}


def test_stage1_ties_in_reverse_pool_order(pair, monkeypatch):
    """All label entropies 0 (the loop's pretrained model keeps no box):
    stage 1 keeps the last K1·N pool frames, last first."""
    records, emb = _common(pair, 0)
    strat = pair.port_strategy()
    monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
    seen = []
    monkeypatch.setattr(strat, 'grad_embeddings',
                        lambda ids: seen.append(list(ids)) or np.stack([emb[f] for f in ids]))
    strat.query(cur_epoch=0)
    assert seen == [list(records)[::-1][:4]]


@pytest.mark.parametrize('method', ['montecarlo', 'bald'])
@pytest.mark.parametrize('seed', [1, 3])
def test_mc_strategies_select_the_jax_ids(pair, monkeypatch, method, seed):
    records, _ = _common(pair, seed)
    picked = []
    for strat in (pair.jax_strategy(method), pair.port_strategy(method)):
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
        picked.append([str(f) for f in strat.query(cur_epoch=0)])
    assert picked[0] == picked[1] and len(set(picked[1])) == 2


def test_unpatched_queries_pick_the_same_ids(pair):
    assert pair.tpick == pair.jpick
    assert len(set(pair.tpick)) == 2 and set(pair.tpick) <= set(pair.trec)
    assert all(type(f) is str for f in pair.tpick)
    assert set(pair.tstrat.stage_times) == {'crb_stage1_s', 'crb_stage2_s', 'crb_stage3_s'}


def test_query_leaves_every_buffer_and_parameter(pair):
    """Stage 2's training-mode forwards update the BN statistics in place;
    the query writes every buffer back: parameters and buffers bit-equal,
    the model in eval mode as before."""
    assert set(pair.after) == set(pair.before)
    assert all(torch.equal(pair.after[k], v) for k, v in pair.before.items())
    assert pair.training_after == {False}
    assert any(k.endswith('running_mean') for k in pair.before)


def test_later_parts_raise(pair):
    """Every clustering of the JAX package builds (numpy copies of
    scikit-learn's estimators) and an unknown one raises; stage 2 over a RoI
    head needs stage 1's targets; the MC scorer builds for a model with a
    RoI head (its two-stage branch is held to JAX in
    tests/test_torch_pvrcnn_active.py)."""
    cfg = _cfg(tload, 'crb')
    for name in ('kmeans', 'birch', 'gmm'):
        cfg.ACTIVE_TRAIN.ACTIVE_CONFIG.CLUSTERING = name
        assert pair.port_strategy(cfg=cfg).prototype == name
    cfg.ACTIVE_TRAIN.ACTIVE_CONFIG.CLUSTERING = 'dbscan'
    with pytest.raises(NotImplementedError, match='dbscan'):
        pair.port_strategy(cfg=cfg)
    strat = pair.port_strategy()
    strat.model = type('TwoStage', (), {'roi_head': None})()
    with pytest.raises(ValueError, match='stage-1 targets'):
        strat.grad_embeddings(['x'])
    assert callable(strat.build_score_fn(mc_dropout=True, num_mc=5))


# ---- the loop --------------------------------------------------------------

def test_train_model_active_crb_cpu(tmp_path, monkeypatch):
    """``train_model_active`` with METHOD crb: two rounds of CRB queries,
    each picking pool ids; every parameter and BN statistic finite."""
    cfg = _cfg(tload, 'crb')
    out = tmp_path / 'out'
    (out / 'ckpt').mkdir(parents=True)
    picks, real = [], tcrb_mod.CRBSampling.query

    def query(self, *a, **k):
        pool = [str(p[0]) for p in self.pairs]
        sel = real(self, *a, **k)
        picks.append((pool, sel, dict(self.stage_times)))
        return sel
    monkeypatch.setattr(tcrb_mod.CRBSampling, 'query', query)
    seen = []
    random.seed(0)
    state = _run(cfg, out, monkeypatch, seen)
    assert [r[:3] for r in seen] == [(0, 4, 0), (1, 4, 2), (2, 6, 0), (3, 8, 0)]
    assert len(picks) == 2
    for pool, sel, times in picks:
        assert len(set(sel)) == 2 and set(sel) <= set(pool)
        assert all(v >= 0 for v in times.values()) and len(times) == 3
    assert not set(picks[0][1]) & set(picks[1][0])     # round 2's pool lost them
    assert _finite(state.model.state_dict().values())
    tactive_rt.check_finite(state.model, 'the crb loop')

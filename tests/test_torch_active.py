"""The port's active-learning loop vs the JAX package: the active split and
its padded sampler, ``gt_class_stats``, the pool scorer, the one-forward
strategies (random, entropy, confidence, coreset; the MC-dropout ones and
CRB are in tests/test_torch_crb.py), the selection pickles,
``resume_dataset`` and ``train_model_active``.

The reduced SECOND of ``tests/test_torch_second_eval.py`` (128×128×40 grid,
narrow BEV widths, NMS matrix 256) over 9 scenes: 4 labelled, a pool of 5 at
batch 2, so the pool's last batch is wrap-padded and one frame is scored
twice.  A pool batch of 2 does not divide the tests' 8 XLA host devices, so
the JAX scorer runs unsharded.  The Flax variables come from a numpy seed
(the cls bias at 0, so that the NMS keeps boxes) and go into the port with
``flax_to_state_dict``.  The JAX scorer is compiled once, for every signal
(``signals=None``); each strategy's slim scorer in the port is held equal to
the port's full scorer.

Tolerances (f32; same formulas, other summation orders): the entropies and
the box density rtol 1e-4, atol 1e-5; ``embeddings`` (the BEV features'
mean) rtol and atol 1e-4; the gt statistics' mean and variance (sums over
the gt slots) rtol 1e-6; labels, validity, box counts and medians exactly.
The loop's init weights are held to the JAX ``init_train_state``: BatchNorm
terms and biases exactly, each kernel's spread and truncation by its
statistics.
"""

import logging
import pickle
import random
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.models import post_processing as jpp
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.query_strategies import names as jnames
from crb_active_3ddet_tpu.query_strategies.coreset_sampling import \
    furthest_first as jfurthest
from crb_active_3ddet_tpu.runtime import active as jactive_rt
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.models import post_processing as tpp
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.query_strategies import names as tnames
from crb_active_3ddet_torch.query_strategies import strategy as tstrategy_mod
from crb_active_3ddet_torch.query_strategies.coreset_sampling import \
    furthest_first as tfurthest
from crb_active_3ddet_torch.runtime import active as tactive_rt
from crb_active_3ddet_torch.runtime import checkpoint as tckpt
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import cosine_onecycle_schedule
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_second_eval import _fill, _reduced

ROOT = Path(__file__).resolve().parent.parent
ACTIVE_CFG = ROOT / 'tools/cfgs/synthetic_models/second_synth_active_random.yaml'
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
EMB_TOL = dict(rtol=1e-4, atol=1e-4)
FLOAT_SIGNALS = ('box_entropy', 'label_entropy', 'confidence_entropy',
                 'pred_density')
EXACT_SIGNALS = ('pred_labels', 'pred_valid', 'num_bbox', 'median_points')
GT_FLOAT = ('mean_points', 'variance_points')
GT_TOL = dict(rtol=1e-6, atol=0)
GT_STATS = ('num_bbox', 'mean_points', 'median_points', 'variance_points')
LOGGER = logging.getLogger('test_torch_active')
LOGGER.addHandler(logging.NullHandler())


def _cfg(load, method='entropy'):
    """The reduced SECOND over 9 scenes with the AL config's ACTIVE_TRAIN:
    4 labelled frames, 2 pretrain epochs, 2 rounds of 2 at interval 1."""
    c = _reduced(load, False)
    c.DATA_CONFIG.NUM_SCENES = 9
    c.ACTIVE_TRAIN = load(ACTIVE_CFG).ACTIVE_TRAIN
    a = c.ACTIVE_TRAIN
    a.METHOD = method
    a.PRE_TRAIN_SAMPLE_NUMS, a.PRE_TRAIN_EPOCH_NUMS = 4, 2
    a.SELECT_NUMS, a.TOTAL_BUDGET_NUMS, a.SELECT_LABEL_EPOCH_INTERVAL = 2, 4, 1
    return c


def _ids(loader):
    return list(loader.dataset.sample_id_list)


class Scored:
    """The JAX and the port scorer over one pool, from the same weights."""

    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload), _cfg(tload)
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
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)),
                                               shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.variables = var
        self.tmodel = tdet(self.tc.MODEL, num_class=3, dataset=tlab_set,
                           device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'],
                                                       var['batch_stats']))
        self.jdir, self.tdir = tmp / 'jax', tmp / 'port'
        self.jdir.mkdir()
        self.tdir.mkdir()
        self.jstrat = jstrategy('entropy', self.jmodel, var, self.jlab,
                                self.junlab, 0, str(self.jdir), self.jc)
        self.tstrat = tstrategy('entropy', self.tmodel, self.tlab, self.tunlab,
                                0, str(self.tdir), self.tc)
        assert self.jstrat.mesh is None
        self.jrec = self.jstrat.scan_pool(signals=None)
        self.trec = self.tstrat.scan_pool(signals=None)

    def port_strategy(self, method):
        return tstrategy(method, self.tmodel, self.tlab, self.tunlab, 0,
                         str(self.tdir), self.tc)

    def jax_strategy(self, method):
        return jstrategy(method, self.jmodel, self.variables, self.jlab,
                         self.junlab, 0, str(self.jdir), self.jc)


@pytest.fixture(scope='module')
def scored(tmp_path_factory):
    return Scored(tmp_path_factory.mktemp('scored'))


# ---- the active split and its sampler --------------------------------------

@pytest.mark.parametrize('seed', [0, 666])
def test_active_split_and_sampler_equal(seed):
    jc, tc = _cfg(jload), _cfg(tload)
    j = jactive(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=True,
                pre_train_sample_nums=4, seed=seed)
    t = tactive(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0, training=True,
                pre_train_sample_nums=4, seed=seed)
    for js, ts in zip(j[:2], t[:2]):
        assert ts.sample_id_list == js.sample_id_list
        assert ts.kitti_infos == js.kitti_infos
    assert len(t[0]) == 4 and len(t[1]) == 5
    for jl, tl in zip(j[2:4], t[2:4]):
        for _ in range(3):                       # epochs advance the shuffle
            assert list(tl.batch_sampler) == list(jl.batch_sampler)
        assert len(tl) == len(jl)
    pool = list(t[3].batch_sampler)
    assert pool == [[0, 1], [2, 3], [4, 0]]      # wrap-padded final batch


# ---- gt_class_stats --------------------------------------------------------

def _frames(seed, b=3, n=400, m=7):
    """Points clustered around each frame's boxes; classes 1 and 2 only (3
    absent), with per-frame box counts that make the per-class counts even
    and odd; zero rows pad the boxes and num_points the points."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, m, 8), np.float32)
    points = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    for f in range(b):
        k = [5, 6, 7][f]
        c = rng.uniform(-20, 20, (k, 3)).astype(np.float32)
        size = rng.uniform(1, 4, (k, 3)).astype(np.float32)
        boxes[f, :k, :3], boxes[f, :k, 3:6] = c, size
        boxes[f, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        boxes[f, :k, 7] = rng.choice([1, 2], k)
        owner = rng.randint(0, k, n)
        points[f, :, :3] = c[owner] + rng.uniform(-0.7, 0.7, (n, 3)) * size[owner]
        points[f, :, 3] = rng.rand(n)
        valid[f, :n - 37 * f] = True
    return points, valid, boxes


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gt_class_stats_equal_jax(seed):
    points, valid, boxes = _frames(seed)
    want = jax.vmap(lambda p, v, g: jpp.gt_class_stats(p, v, g, num_classes=3))(
        points, valid, boxes)
    got = tpp.gt_class_stats(torch.from_numpy(points), torch.from_numpy(valid),
                             torch.from_numpy(boxes), 3)
    assert set(got) == set(want)
    for k in want:
        check = np.testing.assert_allclose if k in GT_FLOAT else np.testing.assert_array_equal
        check(got[k].numpy(), np.asarray(want[k]), err_msg=k,
              **(GT_TOL if k in GT_FLOAT else {}))
    n = got['num_bbox'].numpy()
    assert (n[:, 2] == 0).all() and (got['median_points'][:, 2] == 0).all()
    assert {int(x) % 2 for x in n[:, :2].ravel()} == {0, 1}
    assert (got['variance_points'][:, :2] > 0).any()


# ---- the pool scorer -------------------------------------------------------

def test_full_scorer_matches_jax(scored):
    jrec, trec = scored.jrec, scored.trec
    assert list(trec) == list(jrec) == _ids(scored.tunlab)
    assert len(trec) == 5
    for fid in jrec:
        assert set(trec[fid]) == set(jrec[fid])
        for k in FLOAT_SIGNALS:
            np.testing.assert_allclose(trec[fid][k], np.asarray(jrec[fid][k]),
                                       **FLOAT_TOL, err_msg=f'{fid} {k}')
        np.testing.assert_allclose(trec[fid]['embeddings'],
                                   np.asarray(jrec[fid]['embeddings']),
                                   **EMB_TOL, err_msg=fid)
        for k in EXACT_SIGNALS:
            np.testing.assert_array_equal(trec[fid][k], np.asarray(jrec[fid][k]),
                                          err_msg=f'{fid} {k}')
        for k in GT_FLOAT:
            np.testing.assert_allclose(trec[fid][k], np.asarray(jrec[fid][k]),
                                       **GT_TOL, err_msg=f'{fid} {k}')
    kept = np.array([trec[f]['pred_valid'].sum() for f in trec])
    assert (kept > 0).all() and np.ptp([trec[f]['box_entropy'] for f in trec]) > 0
    for met in ('bbox', 'mean_point', 'median_point', 'variance_point'):
        got = getattr(scored.tstrat, f'{met}_records')
        want = getattr(scored.jstrat, f'{met}_records')
        assert list(got) == list(want), met
        for fid in want:
            assert list(got[fid]) == list(want[fid]), met
            assert all(type(v) is float for v in got[fid].values()), met
            np.testing.assert_allclose(list(got[fid].values()), list(want[fid].values()),
                                       **GT_TOL, err_msg=met)


@pytest.mark.parametrize('signals, forwards, nms', [
    ((), 0, 0), (('box_entropy',), 3, 3), (('confidence_entropy',), 3, 0),
    (('embeddings',), 3, 0)])
def test_slim_scorer_equals_full(scored, monkeypatch, signals, forwards, nms):
    """Each strategy's scorer gives the full scorer's entries, and runs the
    forward and the NMS only when a requested signal reads them (3 pool
    batches)."""
    strat = scored.port_strategy('entropy')
    calls = {'forward': 0, 'nms': 0}
    hook = strat.model.register_forward_pre_hook(
        lambda *a: calls.__setitem__('forward', calls['forward'] + 1))
    real = tstrategy_mod.pp.post_processing

    def counted(*a, **k):
        calls['nms'] += 1
        return real(*a, **k)
    monkeypatch.setattr(tstrategy_mod.pp, 'post_processing', counted)
    try:
        rec = strat.scan_pool(signals=signals)
    finally:
        hook.remove()
    assert calls == {'forward': forwards, 'nms': nms}
    assert list(rec) == list(scored.trec)
    for fid, r in rec.items():
        assert set(r) == set(signals) | set(GT_STATS)
        for k, v in r.items():
            np.testing.assert_array_equal(v, scored.trec[fid][k], err_msg=k)


def test_mc_dropout_and_later_signals_raise(scored):
    """On this one-stage model (no LossNet, no RoI head) ``loss_predictions``
    and ``batch_rcnn_*`` are accepted and emit nothing, with and without
    the MC-dropout scorer, as in the JAX package (the MC-dropout scorer is
    held to JAX in tests/test_torch_crb.py, the two-stage branch and the
    LossNet's signal in tests/test_torch_pvrcnn_active.py)."""
    strat = scored.port_strategy('entropy')
    for mc in (False, True):
        rec = strat.scan_pool(mc_dropout=mc, num_mc=5, signals=('loss_predictions',))
        assert list(rec) == list(scored.trec)
        assert all(set(r) == set(GT_STATS) for r in rec.values())
    rec = strat.scan_pool(signals=('batch_rcnn_cls', 'batch_rcnn_reg'))
    assert list(rec) == list(scored.trec)
    assert all(set(r) == set(GT_STATS) for r in rec.values())
    llal = scored.port_strategy('llal')
    with pytest.raises(RuntimeError, match='LossNet'):
        llal.query(cur_epoch=0)


def test_factory_names_and_later_strategies(scored):
    """Every name of the JAX factory builds, each the JAX strategy's class."""
    assert tnames() == jnames()
    for name in tnames():
        assert type(scored.port_strategy(name)).__name__ == \
            type(scored.jax_strategy(name)).__name__
    with pytest.raises(KeyError):
        scored.port_strategy('nope')


# ---- the strategies --------------------------------------------------------

def _common_records(scored, seed):
    """The port's full records with seeded scores, the same for both."""
    rng = np.random.RandomState(seed)
    rec = {}
    for fid, r in scored.trec.items():
        rec[fid] = dict(r)
        rec[fid]['box_entropy'] = np.float32(rng.rand())
        rec[fid]['confidence_entropy'] = np.float32(rng.rand())
        rec[fid]['embeddings'] = rng.randn(*r['embeddings'].shape).astype(np.float32)
    return rec


@pytest.mark.parametrize('method', ['entropy', 'confidence', 'coreset'])
@pytest.mark.parametrize('seed', [0, 1])
def test_query_selects_the_jax_ids(scored, monkeypatch, method, seed):
    """From one common set of records (and, for coreset, one set of labelled
    embeddings given through the scorer) both strategies pick the same ids."""
    records = _common_records(scored, seed)
    lab_emb = np.random.RandomState(seed + 10).randn(
        2, 2, records[next(iter(records))]['embeddings'].shape[0]).astype(np.float32)
    key = (False, 0, frozenset(('embeddings',)))
    picked = []
    for strat, is_jax in ((scored.jax_strategy(method), True),
                          (scored.port_strategy(method), False)):
        monkeypatch.setattr(strat, 'scan_pool', lambda *a, **k: records)
        calls = iter(lab_emb)
        if is_jax:
            strat._score_fns[key] = lambda v, b, r: {'embeddings': next(calls)}
        else:
            strat._score_fns[key] = lambda b: {'embeddings': torch.from_numpy(next(calls))}
        picked.append(list(strat.query(cur_epoch=0)))
    assert picked[0] == picked[1]
    assert len(set(picked[1])) == 2


def test_random_selects_the_jax_ids(scored):
    jstrat = scored.jax_strategy('random')
    jstrat.bbox_records = dict(scored.jstrat.bbox_records)  # skip its scan
    tstrat = scored.port_strategy('random')
    random.seed(3)
    want = jstrat.query(cur_epoch=0)
    random.seed(3)
    got = tstrat.query(cur_epoch=0)
    assert got == want and len(got) == 2
    assert tstrat.bbox_records == scored.tstrat.bbox_records


def test_furthest_first_equal():
    rng = np.random.RandomState(0)
    x, y = rng.randn(11, 16), rng.randn(5, 16)
    assert tfurthest(x, y, 4) == jfurthest(x, y, 4)


# ---- pickles and resume ----------------------------------------------------

def test_selection_pickles_load_crosswise(scored, tmp_path):
    """Each package writes the same pickle for the same selection and gt
    records, and each package's ``resume_dataset`` rebuilds the same split
    from the other's pickles (two rounds)."""
    pool = _ids(scored.tunlab)
    rounds = {2: [pool[3], pool[0]], 3: [pool[4]]}
    dirs = {'jax': tmp_path / 'jax', 'port': tmp_path / 'port'}
    for name, strat in (('jax', scored.jax_strategy('entropy')),
                        ('port', scored.port_strategy('entropy'))):
        dirs[name].mkdir()
        for met in ('bbox', 'mean_point', 'median_point', 'variance_point'):
            setattr(strat, f'{met}_records', getattr(scored.tstrat, f'{met}_records'))
        strat.active_label_dir = str(dirs[name])
        for epoch, sel in rounds.items():
            strat.save_active_labels(selected_frames=sel, cur_epoch=epoch)
    for epoch in rounds:
        name = f'selected_frames_epoch_{epoch}_rank_0.pkl'
        loaded = [pickle.loads((d / name).read_bytes()) for d in dirs.values()]
        assert loaded[0] == loaded[1]
        assert loaded[1]['frame_id'] == rounds[epoch]
        for rows in loaded[1]['selected_bbox']:
            assert all(type(k) is str and type(v) is float for k, v in rows.items())
    jl, ju, jn = jactive_rt.resume_dataset(scored.jlab, scored.junlab,
                                           dirs['port'], scored.jc, LOGGER)
    tl, tu, tn = tactive_rt.resume_dataset(scored.tlab, scored.tunlab,
                                           dirs['jax'], scored.tc, LOGGER)
    assert jn == tn == 2
    assert _ids(tl) == _ids(jl) == _ids(scored.tlab) + [pool[0], pool[3], pool[4]]
    assert _ids(tu) == _ids(ju) == [pool[1], pool[2]]


# ---- the loop --------------------------------------------------------------

TRUNCATED = 2 / .87962566103423978      # lecun-normal's bound over its std


def test_init_matches_jax_init_train_state():
    """``flax_init`` (the loop's init) against the JAX ``init_train_state``'s
    ``model.init`` on its dummy batch (jitted here: eager, it takes a
    minute): the same tensors; BatchNorm scale, bias, mean and var and every
    bias exactly; each kernel's std within 5/√n of JAX's (its statistical
    spread is ~1.4/√n); truncated (max |w| ≤ 2.27 std, with 10 % for a
    sample's std: the lecun-normal kernels) exactly where JAX's is."""
    jc, tc = _cfg(jload), _cfg(tload)
    jset = jactive(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=True,
                   pre_train_sample_nums=4, seed=0)[0]
    tset = tactive(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0, training=True,
                   pre_train_sample_nums=4, seed=0)[0]
    jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
    dummy = {'points': np.zeros((2, jset.data_processor.max_points_per_frame,
                                 jset.num_point_features), np.float32),
             'num_points': np.full((2,), 16, np.int32),
             'gt_boxes': np.zeros((2, jset.max_gt_boxes, 8), np.float32)}
    geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
            tuple(float(x) for x in jset.point_cloud_range),
            tuple(float(v) for v in jset.voxel_size))
    var = jax.jit(lambda r, h: jmodel.init(
        {'params': r, 'dropout': r}, jtrain.prepare_device_batch(h, *geom),
        training=True))(jax.random.PRNGKey(0), dummy)
    want = flax_to_state_dict(jax.tree.map(np.asarray, var['params']),
                              jax.tree.map(np.asarray, var['batch_stats']))
    model = tdet(tc.MODEL, num_class=3, dataset=tset, device='cpu')
    got = flax_init(model, torch.Generator().manual_seed(0)).state_dict()
    assert set(want) == set(got)
    spread = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith(('.bias', 'running_mean', 'running_var', 'num_batches_tracked')) \
                or w.ndim == 1:
            assert torch.equal(g, w), k
            continue
        n = w.numel()
        sg, sw = g.std().item(), w.std().item()
        assert abs(sg / sw - 1) < 5 / np.sqrt(n), (k, sg, sw)
        spread = max(spread, abs(sg / sw - 1) * np.sqrt(n))
        truncated = w.abs().max().item() <= TRUNCATED * sw * 1.1
        assert (g.abs().max().item() <= TRUNCATED * sg * 1.1) == truncated, k
        if k.startswith('backbone_3d.'):
            assert not truncated, k                 # the sparse convs' plain normal
    assert want['dense_head.conv_cls.bias'].min() < -4.5    # the focal prior
    assert 0 < spread < 5

def test_onecycle_nan_at_two_transition_steps():
    """optax's one-cycle schedule, and the port's copy, is NaN at every
    count over 2 transition steps (its first phase has length int(0.8) = 0)
    and finite over 3: the AL loop's schedules need ≥ 3 steps."""
    for steps, finite in ((2, False), (3, True)):
        ref = optax.cosine_onecycle_schedule(steps, 0.003, 0.4, 10, 1e4)
        port = cosine_onecycle_schedule(steps, 0.003, 0.4, 10, 1e4)
        got = np.array([port(i) for i in range(steps + 2)])
        want = np.array([float(ref(i)) for i in range(steps + 2)])
        assert np.isfinite(got).all() == np.isfinite(want).all() == finite
        if not finite:
            assert np.isnan(got).all() and np.isnan(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-6)


class Scalars:
    """A tb_log: keeps every (key, value, step)."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, key, value, step):
        self.rows.append((key, value, step))

    def steps(self, key):
        return [s for k, _, s in self.rows if k == key]


def _run(cfg, out, monkeypatch, seen, tb_log=None):
    """train_model_active on the CPU; ``seen`` gets, for each epoch, the
    labelled pool size, the optimizer's count and state size at its start,
    whether the weights then equal the init checkpoint, and whether the last
    step ran at the schedule's lr."""
    real = ttrain.train_one_epoch

    def watched(state, step, loader, *a, **k):
        init = tckpt.load_checkpoint(str(out / 'backbone/init_checkpoint.pth'))
        sd = state.model.state_dict()
        at_init = all(torch.equal(sd[n], v) for part in ('model_state', 'batch_stats')
                      for n, v in init[part].items())
        row = (k['cur_epoch'], len(loader.dataset), state.optimizer.count,
               len(state.optimizer.inner.state), at_init)
        state, loss = real(state, step, loader, *a, **k)
        opt = state.optimizer
        seen.append(row + (opt.inner.param_groups[0]['lr'] == opt.schedule(opt.count - 1),
                           np.isfinite(loss)))
        return state, loss
    monkeypatch.setattr(ttrain, 'train_one_epoch', watched)
    return tactive_rt.train_model_active(cfg, None, 2, LOGGER, out, out / 'ckpt',
                                         workers=0, device='cpu', tb_log=tb_log)


def _finite(tensors):
    return all(bool(torch.isfinite(v).all()) for v in tensors
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def test_train_model_active_cpu(tmp_path, monkeypatch):
    cfg = _cfg(tload, 'random')
    out = tmp_path / 'out'
    (out / 'ckpt').mkdir(parents=True)
    seen, tb = [], Scalars()
    random.seed(0)
    state = _run(cfg, out, monkeypatch, seen, tb)
    # pretrain (4 frames: 2 steps an epoch), round 1 (6 frames: 3 steps),
    # round 2 (8 frames: 4 steps); each round from the init weights with a
    # fresh optimizer; every step at its schedule's lr, every loss finite
    assert [r[:3] for r in seen] == [(0, 4, 0), (1, 4, 2), (2, 6, 0), (3, 8, 0)]
    assert seen[0][3] == seen[2][3] == seen[3][3] == 0 and seen[1][3] > 0
    assert [r[4] for r in seen] == [True, False, True, True]
    assert all(r[5] and r[6] for r in seen)
    assert state.step == 4 and state.optimizer.count == 4
    # each step's loss at its step of the phase, each epoch's mean, and each
    # round's selection dashboard
    assert tb.steps('train/loss') == [1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 4]
    assert tb.steps('train/epoch_loss') == [0, 1, 2, 3]
    assert tb.steps('active_selection/total_bbox_selected') == [2, 3]
    assert all(np.isfinite(v) for _, v, _ in tb.rows)
    assert _finite(state.model.state_dict().values())
    pkls = sorted((out / 'active_labels').glob('selected_frames_*.pkl'))
    assert [p.name for p in pkls] == ['selected_frames_epoch_2_rank_0.pkl',
                                      'selected_frames_epoch_3_rank_0.pkl']
    ckpts = sorted((out / 'ckpt').glob('checkpoint_epoch_*.pth'))
    assert [p.name for p in ckpts] == ['checkpoint_epoch_3.pth',
                                       'checkpoint_epoch_4.pth']
    for p in ckpts + [out / 'backbone/checkpoint_epoch_2.pth']:
        ck = tckpt.load_checkpoint(str(p))
        assert _finite(list(ck['model_state'].values()) + list(ck['batch_stats'].values()))
    selections = [pickle.loads(p.read_bytes())['frame_id'] for p in pkls]
    assert len(set(selections[0] + selections[1])) == 4

    # a rerun with TRAIN_RESUME skips the pretrain and both rounds and keeps
    # their selections; it ends at the last round's weights
    cfg.ACTIVE_TRAIN.TRAIN_RESUME = True
    seen.clear()
    again = _run(cfg, out, monkeypatch, seen)
    assert seen == []
    assert [pickle.loads(p.read_bytes())['frame_id'] for p in pkls] == selections
    last = tckpt.load_checkpoint(str(ckpts[-1]))
    sd = again.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in last['model_state'].items())
    assert again.step == 4


def test_train_model_active_refuses_nan(tmp_path, scored):
    """At batch 4, 4 labelled frames and 2 pretrain epochs make a 2-step
    schedule, NaN at every count (where the JAX loop trains a NaN model):
    torch.optim refuses its first lr.  A non-finite weight or BN statistic
    after a phase raises too."""
    cfg = _cfg(tload, 'random')
    with pytest.raises(ValueError, match='Invalid learning rate: nan'):
        tactive_rt.train_model_active(cfg, None, 4, LOGGER, tmp_path, tmp_path,
                                      workers=0, device='cpu')
    tactive_rt.check_finite(scored.tmodel, 'the transfer')
    model = tdet(cfg.MODEL, num_class=3, dataset=scored.tlab.dataset, device='cpu')
    model.load_state_dict(scored.tmodel.state_dict())
    with torch.no_grad():
        model.backbone_2d.blocks[0][2].running_var[3] = float('nan')
    with pytest.raises(RuntimeError, match='non-finite weights after round 1'):
        tactive_rt.check_finite(model, 'round 1')


def test_train_model_active_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device would run')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tactive_rt.train_model_active(_cfg(tload, 'random'), None, 2, LOGGER,
                                      tmp_path, tmp_path, workers=0)


# ---- the eval loop's window ------------------------------------------------

def test_eval_one_epoch_window(scored, tmp_path):
    """9 test-split batches of one frame, more than the window of 8: the
    annos come out in loader order and equal those of one step at a time."""
    c = _cfg(tload)
    dataset, loader, _ = tbuild(c.DATA_CONFIG, c.CLASS_NAMES, 1, workers=0,
                                training=False)
    assert len(loader) > teval.EVAL_WINDOW
    step = teval.make_eval_step(scored.tmodel, dataset, c.MODEL.POST_PROCESSING, 3)
    want, rec = [], {}
    for batch in loader:
        preds, r = step(ttrain.host_to_device_batch(batch, 'cpu'))
        want += dataset.generate_prediction_dicts(
            batch, {k: v.numpy() for k, v in preds.items()}, c.CLASS_NAMES)
        for k, v in r.items():
            rec[k] = rec.get(k, 0) + int(v.sum())
    _, ap, got_rec = teval.eval_one_epoch(step, dataset, loader, c.CLASS_NAMES,
                                          device='cpu', result_dir=tmp_path)
    got = pickle.loads((tmp_path / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in got] == [a['frame_id'] for a in want]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got_rec == rec
    _, want_ap = dataset.evaluation(want, c.CLASS_NAMES)
    assert {k: v for k, v in ap.items() if k != 'sec_per_example'} == want_ap

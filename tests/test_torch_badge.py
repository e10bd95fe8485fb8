"""BADGE, the port vs the JAX package, on the reduced SECOND of
``tests/test_torch_active.py`` (``_cfg(load, 'badge')``: 9 scenes, 4
labelled, a pool of 5 at batch 2, so the last pool batch is wrap-padded;
SELECT_NUMS 2) with the Flax variables of ``_fill(RandomState(0))`` and the
cls bias at 0, carried over by ``flax_to_state_dict``: pass 1's labels,
pass 2's per-frame gradient embeddings, the picks of each package's query
end to end, and the ``grad_embeddings_epoch_{e}.pkl`` cache.

Tolerances: labels exactly; each embedding within 1e-5 + 1e-4 of its row's
norm (f32, other summation orders); picks equal (compared as ``str``).
"""

import os
import pickle

import jax
import numpy as np
import pytest

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.query_strategies import build_strategy as tstrategy
from crb_active_3ddet_torch.query_strategies import badge_sampling as tbadge
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

from test_torch_active import _cfg
from test_torch_second_eval import _fill

EMB_TOL = dict(rtol=1e-4, atol=1e-5)


class BadgePair:
    """The JAX and the port BADGE strategy over one pool, from the same
    weights; each package's query once, end to end."""

    def __init__(self, tmp):
        self.jc, self.tc = _cfg(jload, 'badge'), _cfg(tload, 'badge')
        (jlab_set, _, self.jlab, self.junlab, _, _) = jactive(
            self.jc.DATA_CONFIG, self.jc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        (tlab_set, _, self.tlab, self.tunlab, _, _) = tactive(
            self.tc.DATA_CONFIG, self.tc.CLASS_NAMES, 2, workers=0,
            training=True, pre_train_sample_nums=4, seed=0)
        self.jmodel = jdet(self.jc.MODEL, num_class=3, dataset=jlab_set)
        self.hosts = list(self.tunlab)
        geom = (jlab_set.voxel_cfg, tuple(int(g) for g in jlab_set.grid_size),
                tuple(float(x) for x in jlab_set.point_cloud_range),
                tuple(float(v) for v in jlab_set.voxel_size))
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(
                r, jtrain.prepare_device_batch(h, *geom), training=False),
            jax.random.PRNGKey(0), jtrain.host_to_device_batch(self.hosts[0]))
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.variables = var
        self.tmodel = tdet(self.tc.MODEL, num_class=3, dataset=tlab_set, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats']))
        self.jdir, self.tdir = tmp / 'jax', tmp / 'port'
        self.jdir.mkdir()
        self.tdir.mkdir()
        self.jstrat = jstrategy('badge', self.jmodel, var, self.jlab, self.junlab, 0,
                                str(self.jdir), self.jc)
        self.tstrat = self.port_strategy(self.tdir)
        self.jpick = [str(f) for f in self.jstrat.query(cur_epoch=3)]
        self.tpick = self.tstrat.query(cur_epoch=3)
        self.jcache = pickle.loads((self.jdir / 'grad_embeddings_epoch_3.pkl').read_bytes())
        self.tcache = pickle.loads((self.tdir / 'grad_embeddings_epoch_3.pkl').read_bytes())

    def port_strategy(self, directory):
        return tstrategy('badge', self.tmodel, self.tlab, self.tunlab, 0, str(directory),
                         self.tc)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    return BadgePair(tmp_path_factory.mktemp('badge'))


def test_pass1_labels_equal_jax(pair):
    """Each pool frame's argmax class index per anchor, exactly; the
    wrap-padded batch scores its repeated frame again."""
    hyp = pair.tstrat.rpn_labels()
    assert list(hyp) == [str(f) for f, _ in pair.tstrat.pairs]
    rng = jax.random.PRNGKey(17)
    seen = 0
    for host in pair.hosts:
        rng, sub = jax.random.split(rng)
        want = np.asarray(pair.jstrat._rpn_labels(jtrain.host_to_device_batch(host), rng=sub))
        for i, fid in enumerate(host['frame_id']):
            np.testing.assert_array_equal(hyp[str(fid)].numpy(), want[i], err_msg=str(fid))
            seen += 1
    assert seen == 6
    labels = np.stack([v.numpy() for v in hyp.values()])
    assert labels.shape[1] == pair.tmodel.dense_head.total_anchors and \
        set(np.unique(labels)) == {0, 1, 2}


def test_pass2_embeddings_match_jax(pair):
    """Each frame's eval-mode gradient at conv_cls against its pass-1
    labels, row by row against the JAX ``_build_grad_fn`` on the JAX
    labels; the JAX cache holds the same rows."""
    hyp = pair.tstrat.rpn_labels()
    fids = [str(f) for f, _ in pair.tstrat.pairs]
    got = pair.tstrat.grad_embeddings(fids, hyp)
    grad_fn = pair.jstrat._build_grad_fn()
    want = np.stack([np.asarray(grad_fn(pair.variables, pair.jstrat._load_single(f),
                                        hyp[f].numpy()[None].astype(np.int32))).reshape(-1)
                     for f in fids])
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 32 * 18)
    norm = np.linalg.norm(want, axis=1)
    err = np.abs(got - want).max(axis=1)
    assert (norm > 0).all() and np.ptp(norm) > 1e-3 * norm.max()
    assert (err <= EMB_TOL['atol'] + EMB_TOL['rtol'] * norm).all(), (err, norm)
    np.testing.assert_array_equal(pair.jcache['embeddings'], want)
    assert not pair.tmodel.training


def test_query_picks_the_jax_ids(pair):
    assert pair.tpick == pair.jpick and len(set(pair.tpick)) == 2
    assert all(type(f) is str for f in pair.tpick)


def test_cache_layout_and_resume(pair, tmp_path, monkeypatch):
    """The pickle holds the JAX layout ({'embeddings': (N, D) float32,
    'frame_ids': pool order}); a query that finds one (either package's)
    runs neither pass and picks from it."""
    for cache in (pair.tcache, pair.jcache):
        assert set(cache) == {'embeddings', 'frame_ids'}
        assert cache['embeddings'].dtype == np.float32
        assert [str(f) for f in cache['frame_ids']] == [str(f) for f, _ in pair.tstrat.pairs]
    np.testing.assert_allclose(pair.tcache['embeddings'], pair.jcache['embeddings'],
                               rtol=0, atol=1e-5 + 1e-4 * np.abs(pair.jcache['embeddings']).max())
    for name, cache in (('port', pair.tcache), ('jax', pair.jcache)):
        d = tmp_path / name
        d.mkdir()
        (d / 'grad_embeddings_epoch_7.pkl').write_bytes(pickle.dumps(cache))
        strat = pair.port_strategy(d)
        for attr in ('scan_pool', 'rpn_labels', 'grad_embeddings'):
            monkeypatch.setattr(strat, attr, lambda *a, **k: pytest.fail('a pass ran'))
        assert [str(f) for f in strat.query(cur_epoch=7)] == pair.jpick
        assert os.listdir(d) == ['grad_embeddings_epoch_7.pkl']


def test_kmeans_pp_on_float64(pair, monkeypatch):
    """BADGE's k-means++ runs on float64 (CRB's on float32)."""
    seen = []
    real = tbadge.kmeans_plusplus
    monkeypatch.setattr(tbadge, 'kmeans_plusplus',
                        lambda x, **k: seen.append(x.dtype) or real(x, **k))
    d = pair.tdir.parent / 'f64'
    d.mkdir()
    (d / 'grad_embeddings_epoch_0.pkl').write_bytes(pickle.dumps(pair.tcache))
    pair.port_strategy(d).query(cur_epoch=0)
    assert seen == [np.float64]

"""The port's twin of the two detection-quality gates of
``tests/test_detection_quality.py``, on the CPU.

The harness and its thresholds live in ``chip_smoke.py`` (``gate_1``,
``gate_2``), which runs the same gates on the card; here they run with
``device='cpu'``:
  1. the gates' tiny PointPillars trained 64 epochs on 32 easy scenes must
     reach mAP@0.5 > 0.60 on 16 unseen ones;
  2. over 16 seeds, a model pretrained 128 epochs on 16 object frames
     (one init for every seed, as the JAX test's), then one query of 8 from
     an 80-frame pool that is mostly empty: CRB must land at least one more
     object frame a seed than random, in all (the JAX test's margin, +3 over
     its 3 seeds; ``chip_smoke.GATE_SEEDS`` says why 16).
A third case holds the port's gate-2 queries to the JAX harness's on the
JAX-pretrained weights.  ``tests/gate_readings.py`` takes the other readings that
PERF.md cites (the JAX harness at other init keys, the port from the JAX
init).
"""

import random

import numpy as np
import pytest
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

import chip_smoke

pytestmark = [pytest.mark.slow, pytest.mark.xslow]


def test_pointpillar_reaches_threshold_ap():
    ap, _, _ = chip_smoke.gate_1('cpu')
    assert ap['mAP'] > chip_smoke.GATE_MAP


def test_crb_beats_random(tmp_path):
    crb_total, rand_total, _, _ = chip_smoke.gate_2('cpu', str(tmp_path))
    assert crb_total > rand_total
    assert crb_total >= rand_total + chip_smoke.GATE_MARGIN


def test_port_gate_2_queries_match_the_reference(tmp_path, monkeypatch):
    """Seeds 0-2 of the JAX harness (``_al_round``: its PRNGKey(0) init, 128
    pretrain epochs, ``random`` and ``np.random`` seeded with the seed);
    the port's crb and random queries over its own gate-2 split, on the
    JAX-pretrained weights moved with ``flax_to_state_dict``, pick the JAX
    queries' frames."""
    import jax
    import test_detection_quality as jq
    from crb_active_3ddet_torch.models.detectors import build_detector
    from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict
    real = jq.build_strategy
    seen = {}

    def capture(method, model, variables, *args, **kw):
        seen.update(model=model, variables=variables, args=args, kw=kw)
        strat = real(method, model, variables, *args, **kw)
        query = strat.query

        def keep(*a, **k):
            seen['sel'] = list(query(*a, **k))
            return seen['sel']
        strat.query = keep
        return strat
    monkeypatch.setattr(jq, 'build_strategy', capture)
    split = chip_smoke.gate_al_split()
    cfg, lab_set, unlab_set = split[:3]
    totals = {'jax': {'crb': 0, 'random': 0}, 'port': {'crb': 0, 'random': 0}}
    for seed in (0, 1, 2):
        random.seed(seed)
        np.random.seed(seed)
        jq._al_round('crb', tmp_path / f'jax{seed}', seed=seed)
        kw = dict(seen['kw'])
        kw['cfg'].ACTIVE_TRAIN.METHOD = 'random'
        kw['active_label_dir'] = str(tmp_path / f'jax_random{seed}')
        jsel = {'crb': seen['sel']}
        random.seed(seed)
        jsel['random'] = list(real('random', seen['model'], seen['variables'], *seen['args'],
                                   **kw).query(cur_epoch=0))
        model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), lab_set, device='cpu')
        v = jax.tree.map(np.asarray, seen['variables'])
        model.load_state_dict(flax_to_state_dict(v['params'], v['batch_stats']))
        for method in ('crb', 'random'):
            psel = chip_smoke.gate_al_query(model, method, seed, split, str(tmp_path))
            n_obj = [sum(1 for f in s if len(unlab_set.get_scene(f)[1]) > 0)
                     for s in (jsel[method], psel)]
            totals['jax'][method] += n_obj[0]
            totals['port'][method] += n_obj[1]
            print(f'seed {seed} {method}: JAX {sorted(jsel[method])} ({n_obj[0]} object '
                  f'frames), port {sorted(psel)} ({n_obj[1]})')
            assert set(psel) == set(jsel[method]), (seed, method)
    print(f'object frames over seeds 0-2 on the JAX-pretrained weights: {totals}')

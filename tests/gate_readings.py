"""Readings of the two detection-quality gates beside the ones ``chip_smoke.py``
gates on: the JAX harness of ``tests/test_detection_quality.py`` at a chosen
init key, and the port's gate run from the JAX test's own init, moved with
``flax_to_state_dict``.  It imports both packages, so it runs on the CPU:

    JAX_PLATFORMS=cpu python tests/gate_readings.py jax-gate1 --key 0
    JAX_PLATFORMS=cpu python tests/gate_readings.py port-gate1 --init jax
    JAX_PLATFORMS=cpu python tests/gate_readings.py jax-gate2 --key 0 --seeds 0 1 2
    JAX_PLATFORMS=cpu python tests/gate_readings.py port-gate2 --init jax --seeds 0 1 2
    JAX_PLATFORMS=cpu python tests/gate_readings.py export-init --out DIR
    python tests/gate_readings.py port-gate2 --init DIR/gate2.npz --device cuda

Every run seeds its draws: before each arm, ``random`` and ``np.random``
take the seed (the JAX test leaves both unseeded), so the random arm draws
the same frames in both packages.  The port's runs are ``chip_smoke.py``'s
``gate_1`` / ``gate_2`` from another init: ``--init jax`` the JAX test's
PRNGKey(0) init, ``--init own`` the port's ``flax_init`` seeded
``--init-seed`` (an integer, default the gate's, or ``each``: each seed's
own), or an ``.npz`` state dict that
``export-init`` wrote, which needs no JAX (so the port's run can go to the
card).  Each run prints one JSON line.
"""

import argparse
import json
import os
import random
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path[:0] = [ROOT, TESTS]


def jax_init_state_dict(al, key=0):
    """The JAX test's init (``init_train_state`` at PRNGKey(``key``)) of the
    gate-1 model or (``al``) the gate-2 model, as a port state dict."""
    import jax
    import torch
    import test_detection_quality as jq
    from crb_active_3ddet_tpu.datasets import build_dataloader
    from crb_active_3ddet_tpu.models.detectors import build_detector
    from crb_active_3ddet_tpu.runtime import train as jtrain
    from crb_active_3ddet_tpu.runtime.optimization import build_optimizer
    from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict
    names = jq.AL_CLASS_NAMES if al else jq.CLASS_NAMES
    data_cfg = (jq.easy_data_cfg(96, seed=23, empty_fraction=0.55, max_objects=3) if al
                else jq.easy_data_cfg(32))
    dset, _, _ = build_dataloader(data_cfg, names, batch_size=4, training=True, workers=0,
                                  seed=3)
    model = build_detector(jq.AL_MODEL_CFG if al else jq.MODEL_CFG, num_class=len(names),
                           dataset=dset)
    state = jtrain.init_train_state(model, build_optimizer(jq.OPTIM_CFG, total_steps=512)[0],
                                    dset, batch_size=4, rng=jax.random.PRNGKey(key))
    sd = flax_to_state_dict(jax.tree.map(np.asarray, state.params),
                            jax.tree.map(np.asarray, state.batch_stats))
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def patch_jax_init(key):
    """Make the JAX harness draw its init from PRNGKey(``key``)."""
    import jax
    from crb_active_3ddet_tpu.runtime import train as jtrain
    real = jtrain.init_train_state
    if key != 0:
        jtrain.init_train_state = lambda *a, **k: real(*a, **{**k, 'rng':
                                                              jax.random.PRNGKey(key)})


def seed_all(seed):
    random.seed(seed)
    np.random.seed(seed)


def jax_gate1(args):
    import test_detection_quality as jq
    from crb_active_3ddet_tpu.datasets import build_dataloader
    patch_jax_init(args.key)
    seed_all(0)
    train_set, train_loader, _ = build_dataloader(jq.easy_data_cfg(32), jq.CLASS_NAMES,
                                                  batch_size=4, training=True, workers=0,
                                                  seed=0)
    val_set, val_loader, _ = build_dataloader(jq.easy_data_cfg(16), jq.CLASS_NAMES,
                                              batch_size=4, training=False, workers=0)
    ap, recall = jq.train_and_eval(train_set, train_loader, val_set, val_loader, epochs=64)
    return {'mAP': float(ap['mAP']), 'recall': {k: int(v) for k, v in recall.items()}}


def port_init(args, al):
    """The port's init state dict that ``--init`` names (None: its own)."""
    import torch
    if args.init == 'own':
        return None
    if args.init == 'jax':
        return jax_init_state_dict(al)
    return {k: torch.as_tensor(v) for k, v in np.load(args.init).items()}


def port_gate1(args):
    import chip_smoke
    ap, recall, _ = chip_smoke.gate_1(args.device, init=port_init(args, False))
    return {'mAP': float(ap['mAP']), 'recall': {k: int(v) for k, v in recall.items()}}


def jax_gate2(args):
    """The JAX harness's two arms a seed; also the pool's object frames on
    which the CRB arm's pretrained scorer keeps a box."""
    import test_detection_quality as jq
    from pathlib import Path
    from crb_active_3ddet_tpu.query_strategies.strategy import Strategy
    patch_jax_init(args.key)
    seen = {}
    real = Strategy.scan_pool

    def scan(self, *a, **k):
        seen['rec'], seen['set'] = real(self, *a, **k), self.unlabelled_set
        return seen['rec']
    Strategy.scan_pool = scan
    per_seed = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            got = {}
            for method in ('crb', 'random'):
                seed_all(seed)
                seen.clear()
                got[method] = jq._al_round(method, Path(tmp) / f'{method}{seed}', seed=seed)[1]
                if method == 'crb':
                    rec, pool = seen['rec'], seen['set']
                    got['fired'] = sum(1 for f in rec if len(pool.get_scene(f)[1]) > 0
                                       and np.asarray(rec[f]['pred_valid']).any())
            per_seed[seed] = got
            print(f'JAX key {args.key} seed {seed}: {got}', flush=True)
    return {'per_seed': per_seed, 'crb_total': sum(p['crb'] for p in per_seed.values()),
            'rand_total': sum(p['random'] for p in per_seed.values())}


def port_gate2(args):
    """``chip_smoke.gate_al_seed`` at each seed, as ``gate_2`` runs them."""
    import chip_smoke
    init_seed = {None: chip_smoke.GATE_INIT_SEED, 'each': None}.get(args.init_seed,
                                                                     args.init_seed)
    init = port_init(args, True)
    with tempfile.TemporaryDirectory() as tmp, chip_smoke.reproducible('gate 2 readings'):
        per_seed = {s: chip_smoke.gate_al_seed(s, args.device, tmp, init_seed=init_seed,
                                               init=init) for s in args.seeds}
    return {'per_seed': {s: {k: p[k] for k in ('crb', 'random')} for s, p in per_seed.items()},
            'crb_total': sum(p['crb'] for p in per_seed.values()),
            'rand_total': sum(p['random'] for p in per_seed.values())}


def export_init(args):
    os.makedirs(args.out, exist_ok=True)
    for name, al in (('gate1', False), ('gate2', True)):
        sd = jax_init_state_dict(al)
        np.savez(os.path.join(args.out, f'{name}.npz'), **{k: v.numpy() for k, v in sd.items()})
    return {'wrote': sorted(os.listdir(args.out))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('what', choices=['jax-gate1', 'port-gate1', 'jax-gate2', 'port-gate2',
                                     'export-init'])
    ap.add_argument('--key', type=int, default=0, help='JAX init key (jax-*)')
    ap.add_argument('--init', default='jax', help="port-*: 'jax', 'own' or an .npz file")
    ap.add_argument('--device', default='cpu', help='port-*: the device to run on')
    ap.add_argument('--init-seed', type=lambda v: v if v == 'each' else int(v), default=None,
                    help="port-gate2 --init own: flax_init's seed, or 'each' (default: the "
                    "gate's)")
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--threads', type=int, default=4)
    ap.add_argument('--out', default=os.path.join(ROOT, 'output', 'gate_init'))
    args = ap.parse_args()
    import torch
    torch.set_num_threads(args.threads)
    # f32 as chip_smoke.py's main() sets it before its gates
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    out = {'jax-gate1': jax_gate1, 'port-gate1': port_gate1, 'jax-gate2': jax_gate2,
           'port-gate2': port_gate2, 'export-init': export_init}[args.what](args)
    print(json.dumps({'what': args.what, **vars(args), **out,
                      'seconds': time.perf_counter() - t}, default=str))


if __name__ == '__main__':
    main()

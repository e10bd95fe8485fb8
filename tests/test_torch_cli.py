"""The port's CLIs (``crb_active_3ddet_torch/tools/``) in-process on the CPU
(``--device cpu``), on the reduced SECOND of ``tests/test_torch_second_eval.py``
(f32, 3 scenes a split, batch 1) written to a yaml file:

- ``train`` for one epoch (3 steps: the one-cycle schedule is NaN over
  2), then again with ``--epochs 2``: it resumes from ``checkpoint_epoch_1.pth`` and trains the
  second epoch only (the step count continues, the optimizer's too);
- ``test`` on that checkpoint writes the detections of ``eval_one_epoch``
  called directly on the same weights, bit for bit (its cls bias set to 0:
  the two epochs from the focal prior keep no box), and with ``--profile``
  a torch.profiler trace of its first batches;
- ``import_openpcdet_ckpt`` on a fabricated OpenPCDet ``.pth`` (spconv 2.x
  layout), then ``test`` on its output: the detections of the model that
  ``import_openpcdet_checkpoint`` loads directly;
- ``demo`` over the synthetic test scenes and over a folder of ``.npy``
  copies of two of them: the same detections;
- without ``--device cpu`` on a machine without a card every CLI raises;
  ``SELF_TRAIN`` and ``--vis`` raise, naming ROADMAP item 15; with
  ``ACTIVE_TRAIN`` ``train`` hands over to ``train_model_active``.

TensorBoard is not imported: the CLIs' ``MetricsLogger`` is replaced by a
recorder of their scalars.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader
from crb_active_3ddet_torch.models.detectors import build_detector
from crb_active_3ddet_torch.runtime import active as active_rt
from crb_active_3ddet_torch.runtime import checkpoint as ckpt_rt
from crb_active_3ddet_torch.runtime import eval as eval_rt
from crb_active_3ddet_torch.tools import demo, import_openpcdet_ckpt, test, train
from crb_active_3ddet_torch.utils.openpcdet_ckpt import import_openpcdet_checkpoint

from test_torch_openpcdet_ckpt import _fabricate
from test_torch_second_eval import _reduced

CPU = ['--device', 'cpu']


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


class Scalars:
    """Stands for ``MetricsLogger``: records every scalar."""
    seen = []

    def __init__(self, *a, **k):
        pass

    def add_scalar(self, key, value, step=None):
        Scalars.seen.append((key, float(value), step))

    def add_scalars(self, mapping, step=None, prefix=''):
        for k, v in mapping.items():
            self.add_scalar(prefix + k, v, step)

    def flush(self):
        pass

    def close(self):
        pass


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """This module's torch ops run on one thread: the evaluations' plain
    NMS is thousands of small ops a batch, and on 8 threads each waits at
    its thread barrier while the suite's workers share the cores (the file
    took 150 s of a tier-1 run so, against ~15 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def run(tmp_path_factory, one_torch_thread):
    """The yaml, and one training run resumed once."""
    tmp = tmp_path_factory.mktemp('cli')
    cfg = _reduced(tload, False)
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 1
    cfg.DATA_CONFIG.NUM_SCENES = 3
    yml = tmp / 'second_reduced.yaml'
    yml.write_text(yaml.safe_dump(_plain(cfg)))
    mp = pytest.MonkeyPatch()
    for module in (train, test):
        mp.setattr(module, 'MetricsLogger', Scalars)
    out = tmp / 'train'
    args = ['--cfg_file', str(yml), '--output_dir', str(out), *CPU]
    # other test files that run a CLI with this recorder may have run first
    # in the same process: keep only the scalars of these two runs
    Scalars.seen.clear()
    first = train.main(args + ['--epochs', '1'])
    first_step, first_count = first.step, first.optimizer.count
    second = train.main(args + ['--epochs', '2'])
    yield {'yml': yml, 'tmp': tmp, 'out': out, 'steps': (first_step, first_count, second),
           'scalars': list(Scalars.seen)}
    mp.undo()


def test_foreign_scalars_come_first():
    """Stands for a file that ran ``train.main`` with the recorder earlier in
    this process (``tests/test_torch_kitti_second.py``, say): its epoch
    scalars are in the list before ``run`` starts, and the next test must
    read past them."""
    Scalars().add_scalars({'train/epoch_loss': 1.0}, step=0)
    Scalars().add_scalars({'train/epoch_loss': 1.0}, step=0)
    assert [s for k, _, s in Scalars.seen if k == 'train/epoch_loss'][-2:] == [0, 0]


def test_train_then_auto_resume(run):
    first_step, first_count, second = run['steps']
    ckpts = sorted(p.name for p in (run['out'] / 'ckpt').glob('*.pth'))
    assert ckpts == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth']
    assert first_step == first_count == 3                 # 3 scenes at batch 1
    assert second.step == second.optimizer.count == 6     # the second epoch only
    ck = ckpt_rt.load_checkpoint(str(run['out'] / 'ckpt' / 'checkpoint_epoch_2.pth'))
    assert (ck['epoch'], ck['it'], ck['step']) == (2, 6, 6)
    assert all(torch.isfinite(v).all() for v in ck['model_state'].values())
    epochs = [s for k, _, s in run['scalars'] if k == 'train/epoch_loss']
    assert epochs[:2] == [0, 1]
    log = next(run['out'].glob('log_train_*.txt')).read_text() \
        + ''.join(p.read_text() for p in run['out'].glob('log_train_*.txt'))
    assert 'Auto-resumed from' in log and 'checkpoint_epoch_1.pth (epoch 1)' in log


def _direct(yml, load, tmp):
    """``eval_one_epoch`` on a model loaded by ``load``: its result.pkl."""
    cfg = tload(yml)
    test_set, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                           workers=0, training=False)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device='cpu')
    load(model)
    step = eval_rt.make_eval_step(model, test_set, cfg.MODEL.POST_PROCESSING,
                                  len(cfg.CLASS_NAMES))
    eval_rt.eval_one_epoch(step, test_set, loader, cfg.CLASS_NAMES, device='cpu',
                           result_dir=tmp)
    return pickle.loads((Path(tmp) / 'result.pkl').read_bytes())


def _same_annos(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g['frame_id'] == w['frame_id']
        assert list(g['name']) == list(w['name'])
        for k in ('boxes_lidar', 'score'):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert sum(len(a['name']) for a in got) > 0


def _live(ckpt, tmp):
    """A copy of the checkpoint whose cls bias is 0, so that boxes pass the
    score threshold."""
    ck = ckpt_rt.load_checkpoint(str(ckpt))
    ck['model_state']['dense_head.conv_cls.bias'].zero_()
    return ckpt_rt.save_checkpoint(ck, str(tmp / 'live'))


def test_test_cli_gives_eval_one_epochs_detections(run, tmp_path):
    ckpt = _live(run['out'] / 'ckpt' / 'checkpoint_epoch_2.pth', tmp_path)
    out = tmp_path / 'eval'
    ap = test.main(['--cfg_file', str(run['yml']), '--ckpt', str(ckpt), '--output_dir',
                    str(out), '--profile', '1', *CPU])
    assert 'sec_per_example' in ap
    assert (out / 'eval' / 'profile' / 'trace.json').stat().st_size > 0
    assert 'aten::' in (out / 'eval' / 'profile' / 'summary.txt').read_text()
    got = pickle.loads((out / 'eval' / 'result.pkl').read_bytes())

    def load(model):
        ck = ckpt_rt.load_checkpoint(str(ckpt))
        model.load_state_dict({**ck['model_state'], **ck['batch_stats']})
    _same_annos(got, _direct(run['yml'], load, tmp_path / 'direct'))


def test_import_then_test(run, tmp_path):
    cfg = tload(run['yml'])
    dataset, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, workers=0,
                                     training=False)
    sd = _fabricate(build_detector(cfg.MODEL, 3, dataset, device='cpu'), '2.x', seed=4)
    # the cls bias lets boxes through the score threshold
    sd['dense_head.conv_cls.bias'] = torch.zeros_like(sd['dense_head.conv_cls.bias'])
    pth = tmp_path / 'openpcdet.pth'
    torch.save({'model_state': sd, 'epoch': 80}, pth)
    written = import_openpcdet_ckpt.main(['--cfg_file', str(run['yml']), '--ckpt', str(pth),
                                          '--out', str(tmp_path / 'imported'), *CPU])
    assert written == str(tmp_path / 'imported.pth')
    assert ckpt_rt.load_checkpoint(written)['epoch'] == 80
    test.main(['--cfg_file', str(run['yml']), '--ckpt', written, '--output_dir',
               str(tmp_path / 'eval'), *CPU])
    got = pickle.loads((tmp_path / 'eval' / 'eval' / 'result.pkl').read_bytes())
    _same_annos(got, _direct(run['yml'], lambda m: import_openpcdet_checkpoint(str(pth), m),
                             tmp_path / 'direct'))


def test_demo_synthetic_and_folder(run, tmp_path):
    ckpt = _live(run['out'] / 'ckpt' / 'checkpoint_epoch_2.pth', tmp_path)
    base = ['--cfg_file', str(run['yml']), '--ckpt', ckpt, *CPU]
    synth = demo.main(base + ['--synthetic', '--out', str(tmp_path / 'dets.pkl')])
    assert [d['frame_id'] for d in synth] == ['100000', '100001', '100002']
    assert pickle.loads((tmp_path / 'dets.pkl').read_bytes())[0]['frame_id'] == '100000'
    assert all(np.isfinite(d['boxes']).all() and len(d['boxes']) == len(d['labels'])
               for d in synth)
    assert sum(len(d['boxes']) for d in synth) > 0
    cfg = tload(run['yml'])
    dataset, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, workers=0,
                                     training=False)
    folder = tmp_path / 'scenes'
    folder.mkdir()
    for sid in ('100001', '100002'):
        np.save(folder / f'{sid}.npy', dataset.get_scene(sid)[0])
    got = demo.main(base + ['--data_path', str(folder), '--ext', '.npy'])
    assert [d['frame_id'] for d in got] == ['100001', '100002']
    for g, w in zip(got, synth[1:3]):
        assert g['labels'] == w['labels']
        for k in ('boxes', 'scores'):
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(NotImplementedError, match='item 15'):
        demo.main(base + ['--synthetic', '--vis', 'bev'])


def test_self_train_raises_and_active_train_hands_over(run, tmp_path, monkeypatch):
    cfg = yaml.safe_load(run['yml'].read_text())
    yml = tmp_path / 'st.yaml'
    yml.write_text(yaml.safe_dump({**cfg, 'SELF_TRAIN': {'SCORE_THRESH': 0.6}}))
    with pytest.raises(NotImplementedError, match='item 15'):
        train.main(['--cfg_file', str(yml), '--output_dir', str(tmp_path), *CPU])
    calls = []
    monkeypatch.setattr(train, 'MetricsLogger', Scalars)
    monkeypatch.setattr(active_rt, 'train_model_active',
                        lambda *a, **k: calls.append((a, k)) or 'state')
    yml.write_text(yaml.safe_dump({**cfg, 'ACTIVE_TRAIN': {'METHOD': 'random'}}))
    assert train.main(['--cfg_file', str(yml), '--output_dir', str(tmp_path), *CPU]) == 'state'
    (args, kw), = calls
    assert kw['device'] == torch.device('cpu') and isinstance(kw['tb_log'], Scalars)
    assert args[2] == 1 and args[4] == tmp_path


@pytest.mark.skipif(torch.cuda.is_available(), reason='raises only without a card')
def test_clis_default_to_the_card(run, tmp_path):
    yml, ckpt = str(run['yml']), str(run['out'] / 'ckpt' / 'checkpoint_epoch_1.pth')
    calls = [
        lambda: train.main(['--cfg_file', yml, '--output_dir', str(tmp_path)]),
        lambda: test.main(['--cfg_file', yml, '--ckpt', ckpt, '--output_dir', str(tmp_path)]),
        lambda: import_openpcdet_ckpt.main(['--cfg_file', yml, '--ckpt', ckpt, '--out',
                                            str(tmp_path / 'x')]),
        lambda: demo.main(['--cfg_file', yml, '--ckpt', ckpt, '--synthetic'])]
    for call in calls:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            call()

"""``kitti_models/second_iou.yaml`` and ``second_multihead.yaml`` in the port,
over a generated KITTI-layout tree (``chip_smoke.write_kitti_tree``: 6 train
and 2 val frames of 3 000 - 4 000 points over a 6.4 m range, the port's
infos and gt database):

- each builds its ``KittiDataset`` (both modes) and its full-width model on
  the CPU (nothing is run): 211 200 anchors, SECONDHead's 7×7×512 input,
  AnchorHeadMulti's three heads; ``flax_init`` initialises every parameter;
  ``flax_to_state_dict`` of the JAX model's variables (shapes from
  ``jax.eval_shape`` of its init on a JAX KITTI batch: traced, not
  compiled) names every tensor of the port's, at its shape;
- ``tools/train.main`` (``--device cpu``) on ``second_iou.yaml`` with the
  reduced model of ``tests/test_torch_second_iou.py`` and the tree's
  buffers cut to its range: one epoch of 3 steps at batch 2 (LR 0.003),
  every weight finite; then ``tools/test.main`` on the checkpoint: a finite
  KITTI result and its ``result.pkl``.

Torch ops run on one thread (the module fixture).  TensorBoard is not
imported: the CLIs' ``MetricsLogger`` is replaced by a recorder.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which breaks once
# tests/test_vis_html.py has put tools/ first on sys.path: import it now
import torch._dynamo  # noqa: F401
import yaml

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.kitti import kitti_dataset as tkitti
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_cli import Scalars, _plain
from test_torch_second_iou import IOU_CFG, MULTI_CFG, _reduced


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RANGE = [0, -3.2, -3, 6.4, 3.2, 1]


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_second') / 'kitti'
    chip_smoke.write_kitti_tree(root, n_train=6, n_val=2, points=(3000, 4000), pc_range=RANGE,
                                object_range=(-2, -3.2, -3, 9.4, 3.2, 1), max_objects=4)
    cfg = tload(IOU_CFG)
    tkitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=2)
    return root


@pytest.mark.parametrize('cfg_file', [IOU_CFG, MULTI_CFG], ids=['second_iou', 'second_multihead'])
def test_kitti_configs_build_at_full_width(tree, cfg_file):
    cfg = tload(cfg_file)
    cfg.DATA_CONFIG.DATA_PATH = str(tree)
    train_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4, workers=0, training=True)
    test_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4, workers=0, training=False)
    assert type(train_set).__name__ == 'KittiDataset' and len(train_set) == 6
    assert test_set.voxel_cfg['max_voxels'] == 40000 and train_set.voxel_cfg['max_voxels'] == 16000
    model = tdet(cfg.MODEL, 3, train_set, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    assert model.dense_head.total_anchors == 211200
    head = type(model.dense_head).__name__
    assert head == ('AnchorHeadMulti' if cfg_file == MULTI_CFG else 'AnchorHeadSingle')
    if cfg_file == IOU_CFG:
        assert model.roi_head.shared_fc_layer[0].weight.shape == (256, 49 * 512, 1)
    else:
        assert len(model.dense_head.rpn_heads) == 3
        assert model.dense_head.rpn_heads[1].conv_cls.weight.shape == (2 * 3, 64, 1, 1)
    # every port tensor has its Flax counterpart at full width (traced)
    jc = jload(cfg_file)
    jc.DATA_CONFIG.DATA_PATH = str(tree)
    jset, jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 1, workers=0, training=False)
    jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
    geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
            tuple(float(x) for x in jset.point_cloud_range),
            tuple(float(v) for v in jset.voxel_size))
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), jtrain.host_to_device_batch(next(iter(jloader))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jc.MODEL)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)


def test_train_then_test_main_on_kitti(tree, tmp_path, monkeypatch):
    """A reduced second_iou.yaml over the tree: ``train.main`` for one
    epoch of 3 steps at batch 2, then ``test.main`` on its checkpoint."""
    cfg = _reduced(tload)
    kitti = tload(IOU_CFG)
    d = kitti.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(tree), RANGE
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    cfg.DATA_CONFIG = d
    cfg.OPTIMIZATION = kitti.OPTIMIZATION
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    cfg.OPTIMIZATION.LR = 0.003
    yml = tmp_path / 'second_iou_reduced.yaml'
    yml.write_text(yaml.safe_dump(_plain(cfg)))
    for module in (train_cli, test_cli):
        monkeypatch.setattr(module, 'MetricsLogger', Scalars)
    steps = []
    real = ttrain.train_one_epoch

    def epoch(state, step, loader, *a, **k):
        steps.append(len(loader))
        return real(state, step, loader, *a, **k)
    monkeypatch.setattr(ttrain, 'train_one_epoch', epoch)
    out = tmp_path / 'train'
    state = train_cli.main(['--cfg_file', str(yml), '--output_dir', str(out), '--device', 'cpu',
                            '--epochs', '1'])
    assert steps == [3] and state.step == 3
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap) and np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()

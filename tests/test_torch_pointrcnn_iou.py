"""pointrcnn_iou.yaml, both PointRCNN yamls at full width, the shipped
points-only data path and the CLIs, in the port vs the JAX package.

- The reduced pointrcnn_iou.yaml (``tests/test_torch_pointrcnn.py
  reduced(iou=True)``: CLS_SCORE_TYPE roi_iou, its fg / bg thresholds):
  one train step from one RoI sample given to both packages, held as
  ``test_torch_pointrcnn.check_train`` holds pointrcnn.yaml's (f32 losses
  and point head; every gradient in float64 within 1e-6 of its norm).
- Both yamls build at full width over their shipped DATA_CONFIG (no voxel
  processor: the dataset has no grid and no voxel size): ``flax_init`` sets
  every parameter and ``flax_to_state_dict`` of the traced JAX model names
  every tensor at its shape.
- The shipped processors (mask, sample_points, shuffle_points) over a
  generated KITTI tree: 16 384-row train and 40 960-row test buffers with
  16 384 valid points; the port's ``prepare_device_batch`` passes the
  points, their validity and the batch size on without voxels, where the
  JAX package's drops the points and leaves the grid None (it cannot build
  or feed its detector from the shipped file: ROADMAP Queue 3).
- ``tools/train.main --device cpu`` on pointrcnn.yaml with the reduced
  MODEL over the tree (the shipped data path, one epoch of 3 steps at batch
  2), ``tools/test.main`` on its checkpoint and ``tools/demo.main`` over a
  folder of ``.npy`` scenes.

Torch ops run on one thread.
"""

import copy

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
from crb_active_3ddet_torch.tools import demo as demo_cli
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils import common
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_centerpoint import Fake, _host
from test_torch_cli import Scalars, _plain
from test_torch_pointrcnn import PRCNN, PRCNN_IOU, check_train, reduced, train_pair

KITTI_RANGE = [0, -3.2, -3, 6.4, 3.2, 1]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_iou_train_step_matches():
    tr = train_pair(iou=True)
    assert tr.tcfg.ROI_HEAD.TARGET_CONFIG.CLS_SCORE_TYPE == 'roi_iou'
    labels = tr.tout['roi_targets']['rcnn_cls_labels']
    assert ((labels > 0) & (labels < 1)).any()   # soft labels between the thresholds
    check_train(tr)


@pytest.mark.parametrize('path', [PRCNN, PRCNN_IOU], ids=['pointrcnn', 'pointrcnn_iou'])
def test_yamls_build_at_full_width(path):
    tc, jc = tload(path), jload(path)
    ds, _, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 1, workers=0, training=False)
    assert ds.voxel_cfg is None and ds.grid_size is None and ds.voxel_size is None
    model = tdet(tc.MODEL, 3, ds, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # the JAX detector needs a grid to build and a voxel processor to see the
    # points (Queue 3): trace it over a stand-in geometry; PointRCNN reads neither
    fake = Fake(tc.CLASS_NAMES, tc.DATA_CONFIG.POINT_CLOUD_RANGE, [0.4, 0.4, 0.4], 4, 512, 5)
    jmodel = jdet(jc.MODEL, num_class=3, dataset=fake)
    geom = common.geometry(fake)
    host = jtrain.host_to_device_batch(_host(fake, 0))
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), host)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jc.MODEL)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)
    bb, head = model.backbone_3d, model.roi_head
    assert bb.num_point_features == 128 and len(bb.SA_modules) == len(bb.FP_modules) == 4
    assert bb.FP_modules[3].mlp[0].weight.shape == (512, 512 + 1024, 1, 1)
    assert bb.SA_modules[0].mlps[1][0].weight.shape == (32, 4, 1, 1)
    assert head.merge_down_layer[0].weight.shape == (128, 256, 1, 1)
    assert head.SA_modules[2].mlps[0][0].weight.shape == (256, 256 + 3, 1, 1)
    assert model.point_head.box_layers[-1].weight.shape == (8, 256)


# ---- the shipped data path and the CLIs on a KITTI tree ------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti_pointrcnn') / 'kitti'
    chip_smoke.write_kitti_tree(root, n_train=6, n_val=2, points=(3000, 4000),
                                pc_range=KITTI_RANGE, object_range=(-2, -3.2, -3, 9.4, 3.2, 1),
                                max_objects=4)
    cfg = tload(PRCNN)
    tkitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=2)
    return root


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_points_only_data_path(tree, training):
    tc, jc = tload(PRCNN), jload(PRCNN)
    for c in (tc, jc):
        c.DATA_CONFIG.DATA_PATH = str(tree)
    ds, loader, _ = tbuild(tc.DATA_CONFIG, tc.CLASS_NAMES, 2, workers=0, training=training)
    host = next(iter(loader))
    rows = 16384 if training else 40960
    assert host['points'].shape == (2, rows, 4)
    np.testing.assert_array_equal(host['num_points'], [16384, 16384])
    geom = common.geometry(ds)
    assert geom[0] is None and geom[1] is None and geom[3] is None
    batch = ttrain.prepare_device_batch(ttrain.host_to_device_batch(host, 'cpu'), *geom)
    assert {'points', 'points_valid', 'batch_size', 'gt_boxes'} <= set(batch)
    assert not any(k.startswith('voxel') or k == 'point_slot' for k in batch)
    assert batch['batch_size'] == 2 and batch['points_valid'].sum().item() == 2 * 16384
    # the JAX package over the same file: no grid, and its device batch has no points
    jset, _, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 2, workers=0, training=training)
    assert jset.grid_size is None and jset.voxel_cfg is None
    jb = jtrain.prepare_device_batch(jtrain.host_to_device_batch(host), None, None,
                                     tuple(jset.point_cloud_range), None)
    assert 'points' not in jb


def test_train_test_and_demo_main_on_kitti(tree, tmp_path, monkeypatch):
    """pointrcnn.yaml with the reduced MODEL over the tree, its shipped
    DATA_CONFIG processors: ``train.main`` for one epoch of 3 steps at batch
    2, ``test.main`` on its checkpoint, ``demo.main`` over two scenes."""
    cfg = copy.deepcopy(tload(PRCNN))
    cfg.MODEL = reduced(tload).MODEL
    cfg.DATA_CONFIG.DATA_PATH = str(tree)
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    cfg.OPTIMIZATION.LR = 0.003
    yml = tmp_path / 'pointrcnn_reduced.yaml'
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
    assert type(state.model.roi_head).__name__ == 'PointRCNNHead'
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap) and np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()
    folder = tmp_path / 'scenes'
    folder.mkdir()
    rng = np.random.RandomState(0)
    for sid in ('000000', '000001'):
        pts = np.concatenate([rng.uniform([0, -3.2, -3], [6.4, 3.2, 1], (3000, 3)),
                              rng.rand(3000, 1)], -1).astype(np.float32)
        np.save(folder / f'{sid}.npy', pts)
    dets = demo_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--data_path',
                          str(folder), '--ext', '.npy', '--device', 'cpu'])
    assert [d['frame_id'] for d in dets] == ['000000', '000001']
    assert all(np.isfinite(d['boxes']).all() and len(d['boxes']) == len(d['labels'])
               for d in dets)

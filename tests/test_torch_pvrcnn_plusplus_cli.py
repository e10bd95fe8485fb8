"""PV-RCNN++'s two Waymo files at full width and through the port's CLIs.

- pv_rcnn_plusplus.yaml and pv_rcnn_plusplus_resnet.yaml build at their
  full MODEL widths over Waymo's geometry (150 000 voxels of 0.1 × 0.1 ×
  0.15 m over ±75.2 m, 5 point features): 4 096 SPC keypoints, the four
  vector-pool sources with their lattices, reductions and MLP widths, the
  90-channel fusion, the 6³ vector-pool RoI grid; ``flax_init`` and
  ``init_weights`` set every tensor; ``flax_to_state_dict`` of the traced
  JAX model names every port tensor at its shape.
- ``tools/train.main`` (one epoch of 3 steps at batch 2, LR 0.003), then
  ``tools/test.main`` and ``tools/demo.main`` (``--device cpu``) of each
  file with the reduced MODEL of ``tests/test_torch_pvrcnn_plusplus.py``
  over a generated Waymo-layout tree of 25.6 m (6 + 2 frames, buffers of
  2 048 voxels / 4 096 points), so that SPC, the vector pools and the
  early proposals run through the shipped data path.

Torch ops run on one thread.
"""

import copy
import uuid

import jax
import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, which breaks once
# tests/test_vis_html.py has put tools/ first on sys.path: import it now
import torch._dynamo  # noqa: F401
import yaml

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets.waymo import waymo_dataset as twaymo
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init, init_weights
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import demo as demo_cli
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_centerpoint import Fake, _geom, _host
from test_torch_cli import Scalars, _plain
from test_torch_pvrcnn_plusplus import CLASSES, WAYMO, reduced

NAMES = ['pv_rcnn_plusplus', 'pv_rcnn_plusplus_resnet']
TREE_RANGE = [-12.8, -12.8, -2, 12.8, 12.8, 4]
TREE = dict(n_train=6, n_val=2, points=(3000, 4000), pc_range=TREE_RANGE,
            object_range=(-9.6, -9.6, -2, 9.6, 9.6, 4), max_objects=5, frames_per_sequence=3)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('name', NAMES)
def test_yamls_build_at_full_width(name):
    tc, jc = tload(WAYMO / f'{name}.yaml'), jload(WAYMO / f'{name}.yaml')
    ds = Fake(CLASSES, tc.DATA_CONFIG.POINT_CLOUD_RANGE, [0.1, 0.1, 0.15], 5, 150000, 5)
    model = tdet(tc.MODEL, 3, ds, device='cpu')
    pfe, head = model.pfe, model.roi_head
    assert pfe.model_cfg['NUM_KEYPOINTS'] == 4096 and pfe.num_point_features == 90
    assert pfe.num_point_features_before_fusion == 256 + 128 + 128 + 32
    pools = [pfe.SA_rawpoints, *pfe.SA_layers, head.roi_grid_pool_layer]
    assert [[layer.offsets.shape[0] for layer in x.layers] for x in pools] == \
        [[8, 27], [27, 27], [27, 27], [27, 27]]
    assert [[layer.max_neighbor_distance for layer in x.layers] for x in pools] == \
        [[0.2, 0.4], [1.2, 2.4], [2.4, 4.8], [0.8, 1.6]]
    assert [x.layers[0].c_red for x in pools] == [2, 32, 32, 30]
    assert head.shared_fc_layer[0].weight.shape == (256, 216 * 128, 1)
    kept = {id(conv.bias) for conv in model.dense_head.cls_convs()}    # init_weights keeps them
    for init in (flax_init, init_weights):
        with torch.no_grad():
            for t in model.parameters():
                if id(t) not in kept:
                    t.fill_(float('nan'))
        init(model, torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(p).all()) for p in model.parameters()), init.__name__
    jmodel = jdet(jc.MODEL, num_class=3, dataset=ds)
    geom = _geom(ds)
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init({'params': r, 'dropout': r},
                                 jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), jtrain.host_to_device_batch(_host(ds, 0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jc.MODEL)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('waymo_pvrcnn_plusplus') / 'waymo'
    chip_smoke.write_waymo_tree(root, tag='_' + uuid.uuid4().hex[:12], **TREE)
    cfg = tload(WAYMO / 'pv_rcnn_plusplus.yaml')
    cfg.DATA_CONFIG.DATA_PATH, cfg.DATA_CONFIG.POINT_CLOUD_RANGE = str(root), TREE_RANGE
    ds = twaymo.WaymoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    ds.create_groundtruth_database(
        info_path=root / 'waymo_processed_data_infos_train.pkl', save_path=root,
        split='train', sampled_interval=1, used_classes=cfg.CLASS_NAMES,
        processed_data_tag='waymo_processed_data')
    return root


@pytest.mark.parametrize('name', NAMES)
def test_train_test_and_demo_main_on_waymo(tree, tmp_path, monkeypatch, name):
    cfg = tload(WAYMO / f'{name}.yaml')
    cfg.MODEL = copy.deepcopy(reduced(name)[0])
    d = cfg.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(tree), TREE_RANGE
    d.SAMPLED_INTERVAL = {'train': 1, 'test': 1}
    for proc in d.DATA_PROCESSOR:
        if proc['NAME'] == 'transform_points_to_voxels':
            proc['MAX_NUMBER_OF_VOXELS'] = {'train': 2048, 'test': 2048}
            proc['MAX_POINTS_PER_FRAME'] = {'train': 4096, 'test': 4096}
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU, cfg.OPTIMIZATION.LR = 2, 0.003
    cfg.OPTIMIZATION.NUM_EPOCHS = 1
    cfg.MODEL['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    yml = tmp_path / f'{name}_reduced.yaml'
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
    state = train_cli.main(['--cfg_file', str(yml), '--output_dir', str(out), '--device',
                            'cpu'])
    assert steps == [3] and state.step == 3
    model = state.model
    assert model.module_topology.index('roi_proposal') < model.module_topology.index('pfe')
    assert all(torch.isfinite(v).all() for v in model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap)
    assert np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()
    folder = tmp_path / 'scenes'
    folder.mkdir()
    rng = np.random.RandomState(0)
    for sid in ('000000', '000001'):
        pts = np.concatenate([rng.uniform([-12, -12, -1], [12, 12, 2], (3000, 3)),
                              rng.rand(3000, 2)], -1).astype(np.float32)
        np.save(folder / f'{sid}.npy', pts)
    dets = demo_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--data_path',
                          str(folder), '--ext', '.npy', '--device', 'cpu'])
    assert [d['frame_id'] for d in dets] == ['000000', '000001']
    assert all(np.isfinite(d['boxes']).all() and len(d['boxes']) == len(d['labels'])
               for d in dets)

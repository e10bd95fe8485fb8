"""The port's Waymo slice vs the JAX package, on one generated Waymo-layout
tree (``chip_smoke.write_waymo_tree``: 14 train and 4 val frames in
sequences of 3, of 3 000 - 4 000 raw points over a 25.6 m square, 3 % of
them in no-label zones, Vehicles, Pedestrians, Cyclists and Signs on the
ground, some with 0, 3 or 5 points, detection difficulty 0 or 2), written
twice so that each package builds its own gt database; the sequence names
carry a tag of this run, so that shared-memory keys cannot collide:

- the infos and ``frame_ids`` with ``SAMPLED_INTERVAL`` 1 and 2, and
  ``get_lidar`` (NLZ points dropped, ``tanh`` of the intensity): exactly;
- ``__getitem__`` in test mode and in train mode (gt sampling from the
  database, flips, rotations, scalings) under one ``np.random`` seed:
  exactly, but for ``num_points_in_gt``, which the JAX sample keeps and the
  port drops (as OpenPCDet does), so that the JAX collate raises on frames
  with different numbers of objects and the port's does not;
- ``create_groundtruth_database``: the dbinfos pickle, every ``.bin`` crop
  byte for byte and the stacked ``_global.npy``, with the every-4th-frame
  Vehicle and every-2nd-frame Pedestrian quirks; the port's CLI
  (``--func create_groundtruth_database``) writes the same files;
- the shared-memory point cache round-trips and is cleaned;
- ``_kitti_style_eval`` against the JAX one on random annos and on ground
  truth fed back with distinct scores (3D moderate R40 reads
  ``perfect_ap(n)``); the eval seams (``limit_period``,
  ``generate_waymo_type_results`` with its L1/L2 rules, ``mask_by_distance``)
  and ``_waymo_official_eval`` without the TF ops; ``_require_waymo`` and
  ``create_waymo_infos`` raise ``ImportError`` without the packages;
- each of the 5 ``active-waymo_models/*.yaml`` builds its dataset and its
  full-width model in the port (4 096 keypoints, 150 000-voxel buffer, 5
  point features);
- a reduced PV-RCNN of ``pv_rcnn_active_crb.yaml`` from transferred Flax
  weights on one collated Waymo test batch: keypoints equal, predictions to
  atol = rtol = 1e-4 (headings modulo pi); ``generate_prediction_dicts``;
- ``tools/train.main`` of the port on that config (``--device cpu``) through
  one CRB round, and its selection pickle and the JAX strategy's loaded
  crosswise by each package's ``resume_dataset`` (frames keyed by
  ``frame_ids``).

Torch ops run on one thread (the module fixture), as in
``tests/test_torch_kitti.py``.
"""

import copy
import logging
import os
import pickle
import runpy
import sys
import uuid
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
from crb_active_3ddet_tpu.datasets import build_active_dataloader as jactive
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.datasets.waymo import waymo_dataset as jwaymo
from crb_active_3ddet_tpu.datasets.waymo import waymo_eval as jwaymo_eval
from crb_active_3ddet_tpu.datasets.waymo import waymo_utils as jwaymo_utils
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.runtime import active as jactive_rt
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import _identity_attrs
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.waymo import waymo_dataset as twaymo
from crb_active_3ddet_torch.datasets.waymo import waymo_eval as twaymo_eval
from crb_active_3ddet_torch.datasets.waymo import waymo_utils as twaymo_utils
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.runtime import active as tactive_rt
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_cli import Scalars, _plain
from test_torch_kitti import _same
from test_torch_pvrcnn_eval import _fill

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/active-waymo_models/pv_rcnn_active_crb.yaml'
RANGE = [-12.8, -12.8, -2, 12.8, 12.8, 4]             # 256×256×40 voxels
TREE = dict(n_train=14, n_val=4, points=(3000, 4000), pc_range=RANGE,
            object_range=(-9.6, -9.6, -2, 9.6, 9.6, 4), max_objects=5,
            frames_per_sequence=3)
CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']
TOL = dict(atol=1e-4, rtol=1e-4)
LOGGER = logging.getLogger('test_torch_waymo')
LOGGER.addHandler(logging.NullHandler())


def _reduced(load, root):
    """``pv_rcnn_active_crb.yaml`` over the tree at ``root``, its MODEL cut as
    ``tests/test_torch_kitti.py`` cuts the KITTI file's (f32, 256 keypoints,
    16 RoIs on a 4³ grid, narrow widths), its buffers to the small range,
    every frame of a sequence; one CRB round (6 labelled frames, a pool of
    8, K1 3, K2 2: stage 1 keeps 6, stage 2 4, two picks), each schedule 3
    or 4 steps at batch 2."""
    c = load(CFG)
    d = c.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(root), RANGE
    d.SAMPLED_INTERVAL = {'train': 1, 'test': 1}
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = c.MODEL
    m.BACKBONE_3D.USE_BF16 = False
    m.BACKBONE_3D.VOXEL_CAPS = [384, 256, 128, 128]
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1], [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    m.PFE.NUM_KEYPOINTS, m.PFE.NUM_OUTPUT_FEATURES = 256, 32
    for layer in m.PFE.SA_LAYER.values():
        layer.MLPS = [[8, 8], [8, 8]]
        layer.NSAMPLE = [8, 8]
    m.POINT_HEAD.CLS_FC = [32, 32]
    r = m.ROI_HEAD
    r.SHARED_FC, r.CLS_FC, r.REG_FC = [64, 64], [32, 32], [32, 32]
    r.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = r.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 128
    r.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
    r.NMS_CONFIG.TRAIN.MATRIX_CAP = 128
    r.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 16
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    r.ROI_GRID_POOL.GRID_SIZE = 4
    r.ROI_GRID_POOL.MLPS = [[16, 16], [16, 16]]
    r.ROI_GRID_POOL.NSAMPLE = [8, 8]
    a = c.ACTIVE_TRAIN
    a.PRE_TRAIN_SAMPLE_NUMS, a.PRE_TRAIN_EPOCH_NUMS = 6, 1
    a.SELECT_NUMS = a.TOTAL_BUDGET_NUMS = 2
    a.SELECT_LABEL_EPOCH_INTERVAL = 1
    return c


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Torch ops on one thread: the plain NMS and FPS are many small ops, and
    on 8 threads each waits at its barrier while the suite's workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The same tree twice (sequence names tagged with this run), the gt
    database built by each package."""
    tmp = tmp_path_factory.mktemp('waymo')
    tag = '_' + uuid.uuid4().hex[:12]
    out = {'tmp': tmp, 'tag': tag}
    for name, load, module in (('jax', jload, jwaymo), ('port', tload, twaymo)):
        root = tmp / name
        out['ids'] = chip_smoke.write_waymo_tree(root, tag=tag, **TREE)
        cfg = _reduced(load, root)
        ds = module.WaymoDataset(cfg.DATA_CONFIG, CLASSES, training=False, root_path=root)
        ds.create_groundtruth_database(
            info_path=root / 'waymo_processed_data_infos_train.pkl', save_path=root,
            split='train', sampled_interval=1, used_classes=CLASSES,
            processed_data_tag='waymo_processed_data')
        out[name] = (root, cfg)
    return out


def _datasets(trees, training, interval=1):
    out = []
    for name, build in (('port', tbuild), ('jax', jbuild)):
        cfg = copy.deepcopy(trees[name][1])
        cfg.DATA_CONFIG.SAMPLED_INTERVAL = {'train': interval, 'test': interval}
        ds, _, _ = build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=training)
        out.append(ds)
    return out


# ---- infos, frames, points --------------------------------------------------

@pytest.mark.parametrize('interval', [1, 2])
@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_infos_and_frame_ids_equal_jax(trees, training, interval):
    tset, jset = _datasets(trees, training, interval)
    _same(tset.infos, jset.infos)
    assert tset.frame_ids == jset.frame_ids
    ids = trees['ids'][0 if training else 1]
    assert tset.frame_ids == ids[::interval] and len(ids) == (14 if training else 4)
    assert type(tset).__name__ == 'WaymoDataset'
    assert _identity_attrs(tset) == ('frame_ids', 'infos')
    with open(trees['port'][0] / f"waymo_processed_data_infos_{'train' if training else 'val'}"
              '.pkl', 'rb') as f:
        merged = pickle.load(f)
    _same(tset.infos, merged[::interval])


def test_set_split_equals_jax(trees):
    tset, jset = _datasets(trees, False)
    tset.set_split('train')
    jset.set_split('train')
    _same(tset.infos, jset.infos)
    assert tset.frame_ids == jset.frame_ids == trees['ids'][0]


def test_get_lidar_equals_jax(trees):
    tset, jset = _datasets(trees, False)
    dropped = 0
    for info in tset.infos + _datasets(trees, True)[0].infos:
        pc = info['point_cloud']
        got = tset.get_lidar(pc['lidar_sequence'], pc['sample_idx'])
        want = jset.get_lidar(pc['lidar_sequence'], pc['sample_idx'])
        _same(got, want)
        raw = np.load(tset.data_path / pc['lidar_sequence'] / f"{pc['sample_idx']:04d}.npy")
        keep = raw[:, 5] == -1
        assert got.shape == (int(keep.sum()), 5)
        np.testing.assert_array_equal(got[:, 3], np.tanh(raw[keep, 3]))
        dropped += int((~keep).sum())
    assert dropped > 0


# ---- samples ----------------------------------------------------------------

def _without_counts(sample):
    return {k: v for k, v in sample.items() if k != 'num_points_in_gt'}


@pytest.mark.parametrize('training', [False, True], ids=['test', 'train'])
def test_samples_equal_jax(trees, training):
    """Test mode (the points shuffled) and train mode (gt sampling, flips,
    rotations, scalings): the same draws from one seed."""
    tset, jset = _datasets(trees, training)
    sampled = 0
    for seed in range(2 if training else 1):
        np.random.seed(seed)
        got = [tset[i] for i in range(len(tset))]
        np.random.seed(seed)
        want = [jset[i] for i in range(len(jset))]
        assert all('num_points_in_gt' in w and 'num_points_in_gt' not in g
                   for g, w in zip(got, want))
        _same(got, [_without_counts(w) for w in want])
        for g, info in zip(got, tset.infos):
            n_label = int(np.isin(info['annos']['name'], CLASSES).sum())
            sampled += int((np.abs(g['gt_boxes']).sum(-1) > 0).sum() > n_label)
        batch = tset.collate_batch(got[:2])
        assert batch['points'].shape == (2, 2048, 5) and (batch['num_points'] > 0).all()
    assert sampled > 0 or not training


def test_collate_of_frames_with_other_object_counts(trees):
    """The JAX sample keeps ``num_points_in_gt``, one entry an object, so its
    collate raises for two frames that hold different numbers of objects;
    the port drops the key after ``prepare_data``, as OpenPCDet does."""
    tset, jset = _datasets(trees, False)
    counts = [len(i['annos']['name']) for i in tset.infos]
    i, j = next((i, j) for i in range(len(counts)) for j in range(len(counts))
                if counts[i] != counts[j])
    with pytest.raises(ValueError):
        jset.collate_batch([jset[i], jset[j]])
    batch = tset.collate_batch([tset[i], tset[j]])
    assert batch['batch_size'] == 2 and 'num_points_in_gt' not in batch


# ---- the gt database -----------------------------------------------------------

def test_gt_database_equal_jax(trees):
    tag = 'waymo_processed_data'
    got_dir, want_dir = (trees[n][0] / f'{tag}_gt_database_train_sampled_1'
                         for n in ('port', 'jax'))
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir()) and len(names) > 10
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    got, want = (pickle.loads((trees[n][0] / f'{tag}_waymo_dbinfos_train_sampled_1.pkl')
                              .read_bytes()) for n in ('port', 'jax'))
    _same(got, want)
    glob_got, glob_want = (np.load(trees[n][0] / f'{tag}_gt_database_train_sampled_1_global.npy')
                           for n in ('port', 'jax'))
    _same(glob_got, glob_want)
    assert len(glob_got) == sum(e['num_points_in_gt'] for v in got.values() for e in v)
    # the quirks: Vehicles from every 4th frame, Pedestrians from every 2nd
    with open(trees['port'][0] / f'{tag}_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    for cls, every in (('Vehicle', 4), ('Pedestrian', 2), ('Cyclist', 1)):
        want_n = sum(int((info['annos']['name'] == cls).sum())
                     for k, info in enumerate(infos) if k % every == 0)
        assert len(got.get(cls, [])) == want_n, cls
    assert 'Sign' not in got and set(got) == set(CLASSES)


def test_gt_database_cli_writes_the_same_files(trees, tmp_path, monkeypatch):
    """``python -m crb_active_3ddet_torch.datasets.waymo.waymo_dataset --func
    create_groundtruth_database`` over a copy of the tree."""
    import shutil
    root = tmp_path / 'tree'
    shutil.copytree(trees['port'][0], root)
    tag = 'waymo_processed_data'
    for p in root.glob(f'{tag}_gt_database_train_sampled_1*'):
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    (root / f'{tag}_waymo_dbinfos_train_sampled_1.pkl').unlink()
    yml = tmp_path / 'waymo_dataset.yaml'
    yml.write_text(yaml.safe_dump(_plain(trees['port'][1].DATA_CONFIG)))
    monkeypatch.setattr(sys, 'argv', ['waymo_dataset', '--cfg_file', str(yml), '--func',
                                      'create_groundtruth_database', '--data_path', str(root)])
    module = 'crb_active_3ddet_torch.datasets.waymo.waymo_dataset'
    monkeypatch.delitem(sys.modules, module)        # run it afresh, as python -m does
    runpy.run_module(module, run_name='__main__')
    for name in (f'{tag}_waymo_dbinfos_train_sampled_1.pkl',
                 f'{tag}_gt_database_train_sampled_1_global.npy'):
        assert (root / name).read_bytes() == (trees['port'][0] / name).read_bytes(), name


def test_create_waymo_infos_needs_the_waymo_packages(trees, tmp_path):
    """Without waymo-open-dataset both packages' info builders raise the same
    ImportError at the tfrecord converter."""
    errors = []
    for name, module in (('port', twaymo), ('jax', jwaymo)):
        cfg = trees[name][1]
        with pytest.raises(ImportError) as err:
            module.create_waymo_infos(cfg.DATA_CONFIG, CLASSES, trees[name][0],
                                      tmp_path / name, workers=1)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ImportError) as err:
        twaymo_utils._require_waymo()
    with pytest.raises(ImportError) as jerr:
        jwaymo_utils._require_waymo()
    assert str(err.value) == str(jerr.value) and 'waymo-open-dataset' in str(err.value)
    assert twaymo_utils.WAYMO_CLASSES == jwaymo_utils.WAYMO_CLASSES


def test_shared_memory_cache_round_trips(trees):
    cfg = copy.deepcopy(trees['port'][1])
    cfg.DATA_CONFIG.USE_SHARED_MEMORY = True
    cfg.DATA_CONFIG.SHARED_MEMORY_FILE_LIMIT = 4
    keys = []
    ds = None
    try:
        ds = twaymo.WaymoDataset(cfg.DATA_CONFIG, CLASSES, training=True)
        for info in ds.infos[:4]:
            pc = info['point_cloud']
            key = ds._sa_key(pc['lidar_sequence'], pc['sample_idx'])
            assert trees['tag'] in key
            keys.append(key)
            assert os.path.exists(f'/dev/shm/{key}')
            direct = ds.get_lidar(pc['lidar_sequence'], pc['sample_idx'], from_shm=False)
            cached = ds.get_lidar(pc['lidar_sequence'], pc['sample_idx'])
            _same(cached, direct)
        pc = ds.infos[4]['point_cloud']
        assert not os.path.exists(f"/dev/shm/{ds._sa_key(pc['lidar_sequence'], pc['sample_idx'])}")
        for shm in ds._shm_handles.values():
            shm.close()
        ds._shm_handles.clear()
        ds.clean_shared_memory()
        assert not any(os.path.exists(f'/dev/shm/{k}') for k in keys)
    finally:
        from multiprocessing import shared_memory
        for k in keys:
            try:
                shm = shared_memory.SharedMemory(name=k)
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass


# ---- the evaluation ------------------------------------------------------------

def _waymo_random_annos(rng, infos):
    names = np.array(['Vehicle', 'Pedestrian', 'Cyclist', 'Sign'])
    dets = []
    for info in infos:
        a = info['annos']
        boxes = a['gt_boxes_lidar'].copy()
        boxes[:, :3] += rng.normal(0, 0.2, (len(boxes), 3))
        boxes[:, 6] += rng.normal(0, 0.1, len(boxes))
        n = rng.randint(0, 4)
        extra = np.concatenate([rng.uniform(-10, 10, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                                rng.uniform(-np.pi, np.pi, (n, 1))], 1)
        dets.append({'frame_id': info['frame_id'],
                     'name': np.concatenate([a['name'], names[rng.randint(0, 4, n)]]),
                     'boxes_lidar': np.concatenate([boxes, extra]),
                     'score': rng.uniform(0, 1, len(boxes) + n)})
    return dets


def test_kitti_style_eval_equals_jax(trees):
    tset, jset = _datasets(trees, True)
    rng = np.random.RandomState(3)
    dets = _waymo_random_annos(rng, tset.infos)
    got_str, got = tset.evaluation(copy.deepcopy(dets), CLASSES)
    want_str, want = jset.evaluation(copy.deepcopy(dets), CLASSES)
    assert got_str == want_str and set(got) == set(want)
    assert all(abs(float(got[k]) - float(want[k])) <= 1e-9 for k in want)
    assert 0 < max(float(v) for v in got.values()) < 100
    assert tset.evaluation(dets, CLASSES, eval_metric='kitti')[1] == got


def test_ground_truth_as_detections_reads_perfect_ap(trees):
    tset, jset = _datasets(trees, True)
    counts = [len(i['annos']['name']) for i in tset.infos]
    scores = np.split(np.linspace(1.0, 0.01, sum(counts)), np.cumsum(counts)[:-1])
    dets = [{'frame_id': i['frame_id'], 'name': i['annos']['name'].copy(),
             'boxes_lidar': i['annos']['gt_boxes_lidar'].copy(), 'score': s}
            for i, s in zip(tset.infos, scores)]
    _, ap = tset.evaluation(copy.deepcopy(dets), CLASSES)
    _, jap = jset.evaluation(copy.deepcopy(dets), CLASSES)
    assert all(abs(float(ap[k]) - float(jap[k])) <= 1e-9 for k in jap)
    for cls, kitti_cls in zip(CLASSES, ('Car', 'Pedestrian', 'Cyclist')):
        n = sum(int((i['annos']['name'] == cls).sum()) for i in tset.infos)
        assert n > 1
        for metric in ('bev', '3d'):
            assert abs(float(ap[f'{kitti_cls}_{metric}/moderate_R40'])
                       - chip_smoke.perfect_ap(n)) < 1e-9, (cls, metric, n)


def test_official_eval_unavailable_equals_jax(trees):
    tset, jset = _datasets(trees, False)
    dets = _waymo_random_annos(np.random.RandomState(4), tset.infos)
    got = tset.evaluation(dets, CLASSES, eval_metric='waymo')
    want = jset.evaluation(dets, CLASSES, eval_metric='waymo')
    assert got == want and got[1] == {} and 'unavailable' in got[0]
    with pytest.raises(ImportError) as err:
        twaymo_eval.OpenPCDetWaymoDetectionMetricsEstimator()
    with pytest.raises(ImportError) as jerr:
        jwaymo_eval.OpenPCDetWaymoDetectionMetricsEstimator()
    assert str(err.value) == str(jerr.value)
    with pytest.raises(NotImplementedError):
        tset.evaluation(dets, CLASSES, eval_metric='nuscenes')


def _estimators():
    return [object.__new__(m.OpenPCDetWaymoDetectionMetricsEstimator)
            for m in (twaymo_eval, jwaymo_eval)]


def test_limit_period_equals_jax():
    v = np.random.RandomState(5).uniform(-20, 20, 1000)
    v[:4] = [0.0, np.pi, 3 * np.pi, -np.pi]
    for offset, period in ((0.5, np.pi), (0.5, 2 * np.pi), (0.0, np.pi), (1.0, 2 * np.pi)):
        _same(twaymo_eval.limit_period(v, offset, period),
              jwaymo_eval.limit_period(v, offset, period))
    assert twaymo_eval.CLASS_TO_TYPE == jwaymo_eval.CLASS_TO_TYPE


@pytest.mark.parametrize('fake_gt_infos', [True, False])
def test_waymo_type_results_and_distance_mask_equal_jax(trees, fake_gt_infos):
    """Ground truth (the L1/L2 rule: difficulty 0 reads level 1 above 5 points
    and level 2 at 5 or fewer, empty boxes dropped; 9-column boxes with
    velocity) and predictions, then the distance mask."""
    test, jest = _estimators()
    tset, _ = _datasets(trees, True)
    infos = copy.deepcopy(tset.infos)
    vel = copy.deepcopy(infos[:3])
    for info in vel:
        b = info['annos']['gt_boxes_lidar']
        info['annos']['gt_boxes_lidar'] = np.concatenate([b[:, :6], np.ones((len(b), 2)),
                                                          b[:, 6:]], 1)
    dets = _waymo_random_annos(np.random.RandomState(6), infos)
    for gt in (infos, vel, [i['annos'] for i in infos]):
        got = test.generate_waymo_type_results(gt, CLASSES, is_gt=True,
                                               fake_gt_infos=fake_gt_infos)
        _same(got, jest.generate_waymo_type_results(gt, CLASSES, is_gt=True,
                                                    fake_gt_infos=fake_gt_infos))
        _same(test.mask_by_distance(8.0, got[1], *got[2:]),
              jest.mask_by_distance(8.0, got[1], *got[2:]))
    levels = set(got[5].tolist())
    assert levels == {1, 2}
    pred = test.generate_waymo_type_results(dets, CLASSES, is_gt=False)
    _same(pred, jest.generate_waymo_type_results(dets, CLASSES, is_gt=False))
    kept = test.mask_by_distance(8.0, pred[1], *pred[2:])
    _same(kept, jest.mask_by_distance(8.0, pred[1], *pred[2:]))
    assert 0 < len(kept[0]) < len(pred[0])


# ---- the paper's configs -------------------------------------------------------

@pytest.mark.parametrize('name', sorted(p.name for p in CFG.parent.glob('pv_rcnn_active_*.yaml')))
def test_active_waymo_configs_build(trees, name):
    """Each of the 5 active-waymo configs builds its Waymo dataset (both
    modes) and its model at full width in the port, on the CPU (nothing is
    run)."""
    cfg = tload(CFG.parent / name)
    cfg.DATA_CONFIG.DATA_PATH = str(trees['port'][0])
    train_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=True)
    test_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=False)
    assert type(train_set).__name__ == 'WaymoDataset'
    assert len(train_set) == 2 and len(test_set) == 1          # every 10th frame
    assert test_set.voxel_cfg['max_voxels'] == 150000
    assert test_set.data_processor.max_points_per_frame == 180000
    assert train_set.num_point_features == 5
    model = tdet(cfg.MODEL, len(cfg.CLASS_NAMES), train_set, device='cpu')
    assert int(model.pfe.model_cfg['NUM_KEYPOINTS']) == 4096
    assert sum(model.dense_head.num_anchors_per_location) == 6
    assert sum(p.numel() for p in model.parameters()) > 10_000_000
    assert cfg.ACTIVE_TRAIN.METHOD == name[len('pv_rcnn_active_'):-len('.yaml')]


# ---- the model on a Waymo batch ----------------------------------------------

class Pair:
    """The JAX and the port PV-RCNN of the reduced config, same weights, on
    the tree's first two val frames."""

    def __init__(self, trees):
        jc, tc = trees['jax'][1], trees['port'][1]
        jset, _, _ = jbuild(jc.DATA_CONFIG, CLASSES, 2, workers=0, training=False)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, CLASSES, 2, workers=0,
                                       training=False)
        # (the JAX collate raises on the frames' object counts: without them)
        np.random.seed(0)
        self.jhost = jset.collate_batch([_without_counts(jset[i]) for i in range(2)])
        np.random.seed(0)
        self.host = next(iter(tloader))
        jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
        geom = (jset.voxel_cfg, tuple(int(g) for g in jset.grid_size),
                tuple(float(x) for x in jset.point_cloud_range),
                tuple(float(v) for v in jset.voxel_size))
        jbatch = jtrain.host_to_device_batch(self.jhost)
        shapes = jax.eval_shape(
            lambda r, h: jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                     training=False),
            jax.random.PRNGKey(0), jbatch)
        var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        head = var['params']['dense_head']['conv_cls']
        head['bias'] = np.zeros_like(head['bias'])
        self.tmodel = tdet(tc.MODEL, num_class=3, dataset=self.tset, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'],
                                                       tc.MODEL))
        tbatch = ttrain.host_to_device_batch(self.host, 'cpu')
        self.tmodel.eval()
        with torch.no_grad():
            logits = self.tmodel(ttrain.prepare_device_batch(tbatch, *geom))['cls_preds']
        head['bias'] = -logits.mean(dim=(0, 1, 2)).numpy()
        self.tmodel.load_state_dict(flax_to_state_dict(var['params'], var['batch_stats'],
                                                       tc.MODEL))
        jstep = jeval.make_eval_step(jmodel, jset, jc.MODEL.POST_PROCESSING, 3)

        @jax.jit
        def both(v, h):
            out = jmodel.apply(v, jtrain.prepare_device_batch(h, *geom), training=False)
            return {k: out[k] for k in ('point_coords', 'point_coords_valid')}, jstep(v, h)
        self.jout, (self.jpreds, _) = both(var, jbatch)
        tstep = teval.make_eval_step(self.tmodel, self.tset, tc.MODEL.POST_PROCESSING, 3)
        self.tpreds, _ = tstep(tbatch)
        with torch.no_grad():
            self.tout = self.tmodel(ttrain.prepare_device_batch(tbatch, *geom))
        self.jset = jset
        self.jmodel, self.variables = jmodel, var


@pytest.fixture(scope='module')
def pair(trees):
    return Pair(trees)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pvrcnn_on_a_waymo_batch(pair):
    _same(pair.host, pair.jhost)
    assert pair.host['points'].shape[-1] == 5
    for k in ('point_coords', 'point_coords_valid'):
        np.testing.assert_array_equal(_np(pair.tout[k]), _np(pair.jout[k]), err_msg=k)
    tp, jp = pair.tpreds, pair.jpreds
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    got, want = _np(tp['pred_boxes']), _np(jp['pred_boxes'])
    np.testing.assert_allclose(got[..., :6], want[..., :6], **TOL)
    turn = np.remainder(got[..., 6] - want[..., 6] + np.pi / 2, np.pi) - np.pi / 2
    assert (np.abs(turn) <= TOL['atol'] + TOL['rtol'] * np.abs(want[..., 6])).all(), turn
    for k in ('pred_scores', 'pred_logits'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    kept = _np(tp['pred_valid']).sum(-1)
    assert (kept > 0).all(), kept


def test_prediction_dicts_equal_jax(pair):
    """The JAX step's predictions through both packages' exporters."""
    preds = {k: np.asarray(v) for k, v in pair.jpreds.items()}
    got = pair.tset.generate_prediction_dicts(pair.host, preds, CLASSES)
    want = pair.jset.generate_prediction_dicts(pair.jhost, preds, CLASSES)
    _same(got, want)
    assert [a['frame_id'] for a in got] == list(pair.host['frame_id'])
    assert sum(len(a['name']) for a in got) > 0


# ---- the AL loop through the train CLI ---------------------------------------

def test_crb_round_through_train_main(trees, pair, monkeypatch):
    root, cfg = trees['port']
    tmp = trees['tmp']
    yml = tmp / 'pv_rcnn_active_crb_waymo_reduced.yaml'
    yml.write_text(yaml.safe_dump(_plain(cfg)))
    monkeypatch.setattr(train_cli, 'MetricsLogger', Scalars)
    steps = []
    real = ttrain.train_one_epoch

    def epoch(state, step, loader, *a, **k):
        steps.append(len(loader))
        return real(state, step, loader, *a, **k)
    monkeypatch.setattr(ttrain, 'train_one_epoch', epoch)
    out = tmp / 'al'
    state = train_cli.main(['--cfg_file', str(yml), '--output_dir', str(out),
                            '--device', 'cpu'])
    assert steps == [3, 4] and state.step == 4     # pretrain 6 frames, retrain 8
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    pkl = out / 'active_labels' / 'selected_frames_epoch_1_rank_0.pkl'
    port = pickle.loads(pkl.read_bytes())
    (_, _, tlab, tunlab, _, _) = tactive(cfg.DATA_CONFIG, CLASSES, 2, workers=0,
                                         training=True, pre_train_sample_nums=6, seed=666)
    pool = list(tunlab.dataset.frame_ids)
    assert len(pool) == 8 and len(port['frame_id']) == 2
    assert len(set(port['frame_id'])) == 2 and set(port['frame_id']) <= set(pool)
    assert (out / 'ckpt' / 'checkpoint_epoch_2.pth').exists()

    # the JAX package writes the same pickle from the same records, and each
    # package's resume_dataset replays the other's
    jc = trees['jax'][1]
    (_, _, jlab, junlab, _, _) = jactive(jc.DATA_CONFIG, CLASSES, 2, workers=0,
                                         training=True, pre_train_sample_nums=6, seed=666)
    assert list(junlab.dataset.frame_ids) == pool
    jdir = tmp / 'jax_labels'
    jdir.mkdir()
    strat = jstrategy('crb', pair.jmodel, pair.variables, jlab, junlab, 0, str(jdir), jc)
    sel = port['frame_id']
    strat.bbox_records = dict(zip(sel, port['selected_bbox']))
    for met in ('mean', 'median', 'variance'):
        setattr(strat, f'{met}_point_records', dict(zip(sel, port[f'selected_{met}_points'])))
    strat.save_active_labels(selected_frames=sel, cur_epoch=1)
    assert pickle.loads((jdir / pkl.name).read_bytes()) == port
    jl, ju, jn = jactive_rt.resume_dataset(jlab, junlab, out / 'active_labels', jc, LOGGER)
    tl, tu, tn = tactive_rt.resume_dataset(tlab, tunlab, jdir, cfg, LOGGER)
    assert jn == tn == 1
    assert list(tl.dataset.frame_ids) == list(jl.dataset.frame_ids) \
        == list(tlab.dataset.frame_ids) + [f for f in pool if f in sel]
    assert list(tu.dataset.frame_ids) == list(ju.dataset.frame_ids) \
        == [f for f in pool if f not in sel]

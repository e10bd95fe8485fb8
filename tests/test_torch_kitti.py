"""The port's KITTI slice vs the JAX package, on one generated KITTI-layout
tree (``chip_smoke.write_kitti_tree``: 14 train and 4 val frames of 3 000 -
4 000 points over the reduced PV-RCNN's 6.4 m range, labels of Car,
Pedestrian, Cyclist and DontCare at every difficulty, road planes for half
the frames, PNG images of four sizes), written twice so that each package
builds its own infos and gt database:

- object and calibration parsing, the coordinate transforms and the FOV
  flag: exactly (the same numpy formulas);
- the PNG header reader against PIL's size;
- ``create_kitti_infos``: the infos pickles field by field with their dtypes,
  every ``gt_database/*.bin`` byte for byte, the dbinfos;
- ``__getitem__`` + ``collate_batch``: test mode exactly; train mode under one
  ``np.random`` seed exactly, with gt sampling and a road plane taking part;
- ``generate_prediction_dicts`` on the JAX step's predictions: equal annos and
  byte-equal ``.txt`` files;
- the official evaluation: the port's copy against the JAX one on seeded
  random annos (every AP to 1e-9), against ``tests/golden/kitti_eval_golden.pkl``
  (1e-6), and ground truth fed back as detections with distinct scores on a
  tree of 60 val frames: AP 100 wherever a class and difficulty holds at
  least 41 valid objects (the 41 recall points need that many), the
  41-point sampling's 100 (n - 1) / 40 below, for the BEV and 3D boxes
  (in the image plane a nearer object may take a hidden one's detection),
  the same with one score for all, and every AP equal to the JAX eval's;
- each of the 8 ``active-kitti_models/pv_rcnn_active_*.yaml`` builds its
  dataset and its full-width model in the port;
- the reduced PV-RCNN of ``tests/test_torch_pvrcnn_eval.py`` built from
  ``pv_rcnn_active_crb.yaml``'s MODEL, from transferred Flax weights, on one
  collated KITTI test batch: keypoints equal, predictions to atol = rtol =
  1e-4 (headings modulo pi);
- ``tools/train.main`` of the port on that config (``--device cpu``) through
  one CRB round: every schedule at least 3 steps, distinct picks from the
  pool, and the selection pickles loaded crosswise by each package's
  ``resume_dataset``.

Torch ops run on one thread (the module fixture), as in
``tests/test_torch_active.py``.
"""

import copy
import logging
import pickle
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
from crb_active_3ddet_tpu.datasets.kitti import calibration_kitti as jcalib
from crb_active_3ddet_tpu.datasets.kitti import kitti_dataset as jkitti
from crb_active_3ddet_tpu.datasets.kitti import object3d_kitti as jobj
from crb_active_3ddet_tpu.datasets.kitti.kitti_eval import eval as jeval_kitti
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.query_strategies import build_strategy as jstrategy
from crb_active_3ddet_tpu.runtime import active as jactive_rt
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_active_dataloader as tactive
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.kitti import calibration_kitti as tcalib
from crb_active_3ddet_torch.datasets.kitti import kitti_dataset as tkitti
from crb_active_3ddet_torch.datasets.kitti import object3d_kitti as tobj
from crb_active_3ddet_torch.datasets.kitti.kitti_eval import eval as teval_kitti
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.runtime import active as tactive_rt
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_torch_cli import Scalars, _plain
from test_torch_pvrcnn_eval import _fill

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/active-kitti_models/pv_rcnn_active_crb.yaml'
GOLDEN = ROOT / 'tests/golden/kitti_eval_golden.pkl'
RANGE = [0, -3.2, -3, 6.4, 3.2, 1]                    # 128×128×40 voxels
# objects drawn over x in [1, 6.4] m, so that the database's boxes find room
TREE = dict(n_train=14, n_val=4, points=(3000, 4000), pc_range=RANGE,
            object_range=(-2, -3.2, -3, 9.4, 3.2, 1), max_objects=4)
CLASSES = ['Car', 'Pedestrian', 'Cyclist']
TOL = dict(atol=1e-4, rtol=1e-4)
LOGGER = logging.getLogger('test_torch_kitti')
LOGGER.addHandler(logging.NullHandler())


def _reduced(load, root):
    """``pv_rcnn_active_crb.yaml`` over the tree at ``root``, its MODEL cut as
    ``tests/test_torch_pvrcnn_eval.py`` cuts pv_rcnn_synth.yaml's (f32, 256
    keypoints, 16 RoIs on a 4³ grid, narrow widths), its buffers to the
    small range; one CRB round (6 labelled frames, a pool of 8, K1 3, K2 2:
    stage 1 keeps 6, stage 2 4, two picks), each schedule 3 or 4 steps at
    batch 2."""
    c = load(CFG)
    d = c.DATA_CONFIG
    d.DATA_PATH, d.POINT_CLOUD_RANGE = str(root), RANGE
    for p in d.DATA_PROCESSOR:
        if p.NAME == 'transform_points_to_voxels':
            p.MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
            p.VOXEL_BUFFER_CAP = {'train': 640, 'test': 640}
            p.MAX_POINTS_PER_FRAME = {'train': 2048, 'test': 2048}
    m = c.MODEL
    m.BACKBONE_3D.USE_BF16 = m.BACKBONE_2D.USE_BF16 = False
    m.BACKBONE_3D.VOXEL_CAPS = [384, 256, 128, 128]
    m.BACKBONE_2D.LAYER_NUMS, m.BACKBONE_2D.NUM_FILTERS = [1, 1], [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    m.PFE.NUM_KEYPOINTS, m.PFE.NUM_OUTPUT_FEATURES = 256, 32
    m.PFE.FEATURES_SOURCE = ['bev', 'x_conv3', 'x_conv4', 'raw_points']
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
    a.ACTIVE_CONFIG.K1, a.ACTIVE_CONFIG.K2 = 3, 2
    return c


def _same(a, b, where=''):
    """Equal to the last bit, numpy dtypes included, through dicts, lists
    and calibration objects."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif hasattr(a, 'P2') and hasattr(a, 'V2C'):
        for k in ('P2', 'R0', 'V2C'):
            _same(getattr(a, k), getattr(b, k), f'{where}.{k}')
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


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
    """The same tree twice, infos and gt database built by each package."""
    tmp = tmp_path_factory.mktemp('kitti')
    out = {}
    for name, load, module in (('jax', jload, jkitti), ('port', tload, tkitti)):
        root = tmp / name
        ids = chip_smoke.write_kitti_tree(root, **TREE)
        cfg = _reduced(load, root)
        module.create_kitti_infos(cfg.DATA_CONFIG, CLASSES, root, root, workers=2)
        out[name] = (root, cfg)
    out['ids'] = ids
    out['tmp'] = tmp
    return out


def _frames(trees):
    return trees['ids'][0] + trees['ids'][1]


# ---- parsing, transforms, the image header ---------------------------------

def test_objects_and_calibration_equal_jax(trees):
    root = trees['port'][0] / 'training'
    rng = np.random.RandomState(0)
    levels = set()
    for fid in _frames(trees):
        got = tobj.get_objects_from_label(root / 'label_2' / f'{fid}.txt')
        want = jobj.get_objects_from_label(root / 'label_2' / f'{fid}.txt')
        assert len(got) == len(want) and got[-1].cls_type == 'DontCare'
        for g, w in zip(got, want):
            _same({k: v for k, v in vars(g).items()}, {k: v for k, v in vars(w).items()})
            levels.add(g.level)
        tc = tcalib.Calibration(root / 'calib' / f'{fid}.txt')
        jc = jcalib.Calibration(root / 'calib' / f'{fid}.txt')
        _same(vars(tc), vars(jc))
        pts = (rng.randn(500, 3) * [10, 5, 1] + [10, 0, -1]).astype(np.float32)
        shape = tkitti.png_shape(root / 'image_2' / f'{fid}.png')
        rect = tc.lidar_to_rect(pts)
        for got, want in ((rect, jc.lidar_to_rect(pts)),
                          (tc.rect_to_lidar(rect), jc.rect_to_lidar(rect)),
                          (tc.rect_to_img(rect), jc.rect_to_img(rect)),
                          (tkitti.KittiDataset.get_fov_flag(rect, shape, tc),
                           jkitti.KittiDataset.get_fov_flag(rect, shape, jc))):
            _same(got, want)
        np.testing.assert_allclose(tc.rect_to_lidar(rect), pts, atol=1e-4)
    assert {0, 1, 2} <= levels                     # easy, moderate and hard
    d = tcalib.dummy_calibration()
    _same(vars(d), vars(jcalib.dummy_calibration()))


def test_png_shape_equals_pil(trees):
    Image = pytest.importorskip('PIL.Image')
    root = trees['port'][0] / 'training' / 'image_2'
    shapes = set()
    for fid in _frames(trees):
        got = tkitti.png_shape(root / f'{fid}.png')
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.array(Image.open(root / f'{fid}.png').size[::-1]))
        shapes.add(tuple(got))
    assert len(shapes) == len(chip_smoke.KITTI_IMAGE_SHAPES)
    with pytest.raises(ValueError, match='PNG'):
        tkitti.png_shape(trees['port'][0] / 'ImageSets' / 'train.txt')


# ---- the info builder -------------------------------------------------------

@pytest.mark.parametrize('split', ['train', 'val', 'trainval'])
def test_infos_equal_jax(trees, split):
    got, want = (pickle.loads((trees[n][0] / f'kitti_infos_{split}.pkl').read_bytes())
                 for n in ('port', 'jax'))
    _same(got, want)
    assert len(got) == {'train': 14, 'val': 4, 'trainval': 18}[split]
    counts = np.concatenate([i['annos']['num_points_in_gt'] for i in got])
    assert (counts > 0).any() and (counts == -1).sum() == len(got)   # one DontCare a frame


def test_gt_database_equal_jax(trees):
    got_dir, want_dir = (trees[n][0] / 'gt_database' for n in ('port', 'jax'))
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir()) and len(names) > 10
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    got, want = (pickle.loads((trees[n][0] / 'kitti_dbinfos_train.pkl').read_bytes())
                 for n in ('port', 'jax'))
    _same(got, want)
    assert set(got) == set(CLASSES)


# ---- the paper's configs ------------------------------------------------------

@pytest.mark.parametrize('name', sorted(p.name for p in CFG.parent.glob('pv_rcnn_active_*.yaml')))
def test_active_kitti_configs_build(trees, name):
    """Each of the 8 active-kitti configs builds its KITTI dataset (both
    modes) and its model at full width in the port, on the CPU (nothing is
    run)."""
    cfg = tload(CFG.parent / name)
    cfg.DATA_CONFIG.DATA_PATH = str(trees['port'][0])
    train_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=True)
    test_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=False)
    assert type(train_set).__name__ == 'KittiDataset' and len(train_set) == 14
    assert len(test_set) == 4 and test_set.voxel_cfg['max_voxels'] == 40000
    model = tdet(cfg.MODEL, len(cfg.CLASS_NAMES), train_set, device='cpu')
    assert int(model.pfe.model_cfg['NUM_KEYPOINTS']) == 2048
    assert sum(p.numel() for p in model.parameters()) > 10_000_000
    assert cfg.ACTIVE_TRAIN.METHOD == name[len('pv_rcnn_active_'):-len('.yaml')]


# ---- samples ----------------------------------------------------------------

def _datasets(trees, training):
    out = []
    for name, build in (('port', tbuild), ('jax', jbuild)):
        cfg = trees[name][1]
        ds, _, _ = build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=training)
        out.append(ds)
    return out


def test_samples_equal_jax_test_mode(trees):
    tset, jset = _datasets(trees, False)
    assert tset.sample_id_list == jset.sample_id_list == trees['ids'][1]
    for i in range(0, len(tset), 2):
        got = tset.collate_batch([tset[i], tset[i + 1]])
        want = jset.collate_batch([jset[i], jset[i + 1]])
        _same(got, want)
        assert got['points'].shape == (2, 2048, 4) and (got['num_points'] > 0).all()


def test_samples_equal_jax_train_mode(trees):
    """Gt sampling from the database, on the road plane where a frame has
    one, flips, rotations and scalings: the same draws from one seed."""
    tset, jset = _datasets(trees, True)
    planes = sampled = 0
    for seed in range(2):
        np.random.seed(seed)
        got = [tset[i] for i in range(len(tset))]
        np.random.seed(seed)
        want = [jset[i] for i in range(len(jset))]
        _same(got, want)
        for i in range(0, len(got), 2):
            _same(tset.collate_batch(got[i:i + 2]), jset.collate_batch(want[i:i + 2]))
        for g, info in zip(got, tset.kitti_infos):
            n_label = int((info['annos']['name'] != 'DontCare').sum())
            sampled += int((np.abs(g['gt_boxes']).sum(-1) > 0).sum() > n_label)
            planes += 'road_plane' in g
    assert sampled > 0 and planes > 0


# ---- the model on a KITTI batch ----------------------------------------------

class Pair:
    """The JAX and the port PV-RCNN of the reduced config, same weights, on
    the tree's first two val frames."""

    def __init__(self, trees):
        jc, tc = trees['jax'][1], trees['port'][1]
        self.tc = tc
        jset, jloader, _ = jbuild(jc.DATA_CONFIG, CLASSES, 2, workers=0, training=False)
        self.tset, tloader, _ = tbuild(tc.DATA_CONFIG, CLASSES, 2, workers=0,
                                       training=False)
        self.jhost, self.host = next(iter(jloader)), next(iter(tloader))
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
        self.jmodel, self.variables = jmodel, var
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


@pytest.fixture(scope='module')
def pair(trees):
    return Pair(trees)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pvrcnn_on_a_kitti_batch(pair):
    _same(pair.host, pair.jhost)
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


def test_prediction_dicts_equal_jax(pair, tmp_path):
    """The JAX step's predictions through both packages' exporters."""
    preds = {k: np.asarray(v) for k, v in pair.jpreds.items()}
    dirs = {n: tmp_path / n for n in ('port', 'jax')}
    for d in dirs.values():
        d.mkdir()
    got = pair.tset.generate_prediction_dicts(pair.host, preds, CLASSES,
                                              output_path=dirs['port'])
    want = pair.jset.generate_prediction_dicts(pair.jhost, preds, CLASSES,
                                               output_path=dirs['jax'])
    _same(got, want)
    files = sorted(p.name for p in dirs['port'].iterdir())
    assert files == [f'{f}.txt' for f in pair.host['frame_id']]
    for name in files:
        assert (dirs['port'] / name).read_bytes() == (dirs['jax'] / name).read_bytes()
    assert sum(len(a['name']) for a in got) > 0
    empty = {k: np.zeros_like(v) for k, v in preds.items()}
    _same(pair.tset.generate_prediction_dicts(pair.host, empty, CLASSES),
          pair.jset.generate_prediction_dicts(pair.jhost, empty, CLASSES))


# ---- the official evaluation -------------------------------------------------

def _random_annos(rng, n_frames, n_obj, scored):
    names = np.array(['Car', 'Pedestrian', 'Cyclist', 'Van', 'DontCare'])
    annos = []
    for _ in range(n_frames):
        n = rng.randint(0, n_obj + 1)
        loc = np.stack([rng.uniform(-10, 10, n), rng.uniform(0.5, 2, n),
                        rng.uniform(5, 40, n)], 1)
        dims = np.stack([rng.uniform(0.5, 4.5, n), rng.uniform(1, 2, n),
                         rng.uniform(0.5, 2, n)], 1)
        x1, y1 = rng.uniform(0, 1100, n), rng.uniform(0, 300, n)
        anno = {'name': names[rng.randint(0, 5 if not scored else 3, n)],
                'truncated': rng.choice([0.0, 0.2, 0.4, 0.6], n),
                'occluded': rng.randint(0, 4, n).astype(float),
                'alpha': rng.uniform(-np.pi, np.pi, n),
                'bbox': np.stack([x1, y1, x1 + rng.uniform(5, 150, n),
                                  y1 + rng.uniform(10, 80, n)], 1),
                'dimensions': dims, 'location': loc,
                'rotation_y': rng.uniform(-np.pi, np.pi, n)}
        if scored:
            anno['score'] = rng.uniform(0, 1, n)
        annos.append(anno)
    return annos


def test_eval_equals_jax_on_random_annos():
    rng = np.random.RandomState(7)
    gt = _random_annos(rng, 40, 8, False)
    # detections near the ground truth, and some anywhere
    dt = []
    for g in gt:
        d = {k: np.array(v, copy=True) for k, v in g.items()}
        keep = d['name'] != 'DontCare'
        d = {k: v[keep] for k, v in d.items()}
        n = len(d['name'])
        d['location'] = d['location'] + rng.normal(0, 0.3, (n, 3))
        d['rotation_y'] = d['rotation_y'] + rng.normal(0, 0.1, n)
        d['bbox'] = d['bbox'] + rng.normal(0, 3, (n, 4))
        d['score'] = rng.uniform(0, 1, n)
        extra = _random_annos(rng, 1, 3, True)[0]
        dt.append({k: np.concatenate([d[k], extra[k]]) for k in d})
    got_str, got = teval_kitti.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                                        CLASSES)
    want_str, want = jeval_kitti.get_official_eval_result(gt, dt, CLASSES)
    assert got_str == want_str and set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-9, k
    assert 0 < max(float(v) for v in got.values()) < 100


@pytest.mark.skipif(not GOLDEN.exists(), reason='golden fixture missing')
def test_eval_matches_reference_golden():
    with open(GOLDEN, 'rb') as f:
        g = pickle.load(f)
    _, ret = teval_kitti.get_official_eval_result(g['gt_annos'], g['dt_annos'], CLASSES)
    golden = g['result_dict']
    assert set(ret) >= set(golden)
    bad = {k: (float(ret[k]), v) for k, v in golden.items() if abs(float(ret[k]) - v) > 1e-6}
    assert not bad, bad


def test_ground_truth_as_detections_reads_100(tmp_path):
    """A tree of 60 val frames of up to 12 objects; its ground truth fed back
    through ``KittiDataset.evaluation`` with distinct scores."""
    root = tmp_path / 'tree'
    chip_smoke.write_kitti_tree(root, n_train=1, n_val=60, points=(4000, 5000),
                                pc_range=[0, -40, -3, 70.4, 40, 1],
                                object_range=[0, -20, -3, 45, 20, 1], max_objects=12,
                                min_separation=3.0)
    cfg = tload(CFG)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    tkitti.create_kitti_infos(cfg.DATA_CONFIG, CLASSES, root, root, workers=2)
    ds, _, _ = tbuild(cfg.DATA_CONFIG, CLASSES, 2, workers=0, training=False)
    infos = ds.kitti_infos
    n_obj = sum(int((i['annos']['name'] != 'DontCare').sum()) for i in infos)
    scores = np.split(np.linspace(1.0, 0.01, n_obj),
                      np.cumsum([(i['annos']['name'] != 'DontCare').sum() for i in infos])[:-1])
    _, ap = ds.evaluation(chip_smoke.gt_as_detections(infos, scores), CLASSES)
    _, jap = jeval_kitti.get_official_eval_result(
        [copy.deepcopy(i['annos']) for i in infos], chip_smoke.gt_as_detections(infos, scores), CLASSES)
    assert set(ap) == set(jap)
    assert all(abs(float(ap[k]) - float(jap[k])) <= 1e-9 for k in jap)
    full = 0
    for cls in CLASSES:
        for d, level in enumerate(('easy', 'moderate', 'hard')):
            n = chip_smoke.kitti_valid_objects(infos, cls, d)
            want = chip_smoke.perfect_ap(n)
            full += n >= 41
            # (in the image plane one object may hide another, and the eval
            # then gives the nearer one's detection to the other)
            for metric in ('bev', '3d'):
                assert abs(float(ap[f'{cls}_{metric}/{level}_R40']) - want) < 1e-9, \
                    (cls, level, metric, n, ap[f'{cls}_{metric}/{level}_R40'])
    assert full >= 7, full
    # one score for all: the same readings (a perfect detector's AP is set by
    # the count of valid objects, not by its scores), in both packages
    same = [np.ones_like(s) for s in scores]
    _, tied = ds.evaluation(chip_smoke.gt_as_detections(infos, same), CLASSES)
    _, jtied = jeval_kitti.get_official_eval_result(
        [copy.deepcopy(i['annos']) for i in infos], chip_smoke.gt_as_detections(infos, same), CLASSES)
    assert all(abs(float(tied[k]) - float(jtied[k])) <= 1e-9 for k in jtied)
    assert all(tied[k] == ap[k] for k in ap if '_bev/' in k or '_3d/' in k)


# ---- the AL loop through the train CLI ---------------------------------------

def test_crb_round_through_train_main(trees, pair, monkeypatch):
    root, cfg = trees['port']
    tmp = trees['tmp']
    yml = tmp / 'pv_rcnn_active_crb_reduced.yaml'
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
    pool = list(tunlab.dataset.sample_id_list)
    assert len(pool) == 8 and len(port['frame_id']) == 2
    assert len(set(port['frame_id'])) == 2 and set(port['frame_id']) <= set(pool)
    assert (out / 'ckpt' / 'checkpoint_epoch_2.pth').exists()

    # the JAX package writes the same pickle from the same records, and each
    # package's resume_dataset replays the other's
    jc = trees['jax'][1]
    (_, _, jlab, junlab, _, _) = jactive(jc.DATA_CONFIG, CLASSES, 2, workers=0,
                                         training=True, pre_train_sample_nums=6, seed=666)
    assert list(junlab.dataset.sample_id_list) == pool
    jdir = tmp / 'jax_labels'
    jdir.mkdir()
    strat = jstrategy('crb', pair.jmodel, pair.variables, jlab, junlab, 0, str(jdir), jc)
    sel = port['frame_id']
    strat.bbox_records = dict(zip(sel, port['selected_bbox']))
    for met in ('mean', 'median', 'variance'):
        setattr(strat, f'{met}_point_records', dict(zip(sel, port[f'selected_{met}_points'])))
    strat.save_active_labels(selected_frames=sel, cur_epoch=1)
    jpkl = jdir / pkl.name
    assert pickle.loads(jpkl.read_bytes()) == port
    jl, ju, jn = jactive_rt.resume_dataset(jlab, junlab, out / 'active_labels', jc, LOGGER)
    tl, tu, tn = tactive_rt.resume_dataset(tlab, tunlab, jdir, cfg, LOGGER)
    assert jn == tn == 1
    assert list(tl.dataset.sample_id_list) == list(jl.dataset.sample_id_list) \
        == list(tlab.dataset.sample_id_list) + [f for f in pool if f in sel]
    assert list(tu.dataset.sample_id_list) == list(ju.dataset.sample_id_list) \
        == [f for f in pool if f not in sel]

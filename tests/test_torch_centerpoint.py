"""CenterPoint in the port vs the JAX package, end to end.

- Two reduced models from the same Flax weights on the same host batch (2
  frames, the second partly padded; gts of 3 classes with padding):
  ``tests/test_centerpoint.py``'s CenterPoint (PillarVFE, BEV [2, 2],
  CenterHead at stride 2 with 16 objects, model-level NMS) and a dynamic
  pillar CenterPoint cut from ``waymo_models/centerpoint_dyn_pillar_1x.yaml``
  (its 0.32 m pillars over a 25.6 m square: 80 × 80, a 1 024-pillar buffer
  that the frames overflow, BEV [1, 1, 1] at [16, 32, 64], the head's
  default stride 8 and 64 objects, the score-only post-processing).  Each:
  the eval step (``make_eval_step``: boxes, scores and logits atol = rtol =
  1e-4, labels, validity and recall counts exactly) and one train step
  (``make_train_step`` with the file's adam_onecycle: losses rtol 1e-5,
  the head branches' gradients within 1e-4 of their norm, every updated
  parameter and BN statistic atol 1e-4, but where the two gradients differ
  in sign: there Adam's first step parts them by twice its LR, atol 2 LR +
  1e-4, and such elements are at most 1e-3 of the parameters).  The gradients ahead of them (the
  head's shared conv and BatchNorm, the BEV backbone, the VFE) are held
  within 1e-2 of their norm: a BatchNorm output within f32 rounding of 0
  sets its ReLU's mask by the rounding, in one package and not the other,
  and moves ~1e-3 of every gradient ahead of it.  Measured against a
  float64 run of the port: on the pillar model one of the head's 16 384
  shared BatchNorm outputs reads −6.8e-8 in the port's f32 and +2.3e-8 in
  f64, and the port's gradients ahead of it are 1.2e-3 off f64, JAX's
  4e-6; on the dynamic-pillar model the port's are 6e-6 off and JAX's
  3e-3.
- The five Waymo CenterHead configs at full width on the CPU over a small
  generated Waymo tree, nothing run: each builds its ``WaymoDataset`` (both
  modes) and its model, whose state dict is the one ``flax_to_state_dict``
  names from the JAX model's (traced) variables, and ``flax_init`` and
  ``init_weights`` each set every parameter and buffer.
- ``tools/train.main --device cpu`` on a reduced ``centerpoint.yaml`` over
  the tree (an epoch of 3 steps at batch 2), then ``tools/test.main`` on its
  checkpoint.
- The OpenPCDet import of a CenterPoint state dict made here (OpenPCDet's
  branch layout: bias-free conv, BatchNorm, ReLU, then the output conv; the
  shared conv with its ``USE_BIAS_BEFORE_NORM`` bias) against the JAX
  importer's parameters on the same dict: equal bit for bit; the folded
  branches reproduce OpenPCDet's branch at inference; two head groups raise.

Torch ops run on one thread (the module fixture).
"""

import copy
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

from crb_active_3ddet_tpu.config import CfgNode as JCfg
from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.datasets import build_dataloader as jbuild
from crb_active_3ddet_tpu.models.detectors import build_detector as jdet
from crb_active_3ddet_tpu.runtime import eval as jeval
from crb_active_3ddet_tpu.runtime import train as jtrain
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt
from crb_active_3ddet_tpu.utils import torch_ckpt as jckpt

from crb_active_3ddet_torch.config import CfgNode as TCfg
from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.datasets import build_dataloader as tbuild
from crb_active_3ddet_torch.datasets.waymo import waymo_dataset as twaymo
from crb_active_3ddet_torch.models.dense_heads.center_head import CenterHead
from crb_active_3ddet_torch.models.detectors import build_detector as tdet
from crb_active_3ddet_torch.models.detectors import flax_init, init_weights
from crb_active_3ddet_torch.runtime import eval as teval
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.tools import test as test_cli
from crb_active_3ddet_torch.tools import train as train_cli
from crb_active_3ddet_torch.utils import openpcdet_ckpt as ockpt
from crb_active_3ddet_torch.utils.flax_weights import flax_to_state_dict

import chip_smoke
from test_centerpoint import centerpoint_cfg
from test_torch_cli import Scalars, _plain
from test_torch_second_eval import _fill

ROOT = Path(__file__).resolve().parent.parent
WAYMO = ROOT / 'tools/cfgs/waymo_models'
CONFIGS = ('centerpoint.yaml', 'centerpoint_without_resnet.yaml', 'centerpoint_pillar_1x.yaml',
           'centerpoint_dyn_pillar_1x.yaml', 'pv_rcnn_with_centerhead_rpn.yaml')
RANGE = [-12.8, -12.8, -2, 12.8, 12.8, 4]
TREE = dict(n_train=6, n_val=2, points=(3000, 4000), pc_range=RANGE,
            object_range=(-9.6, -9.6, -2, 9.6, 9.6, 4), max_objects=5, frames_per_sequence=3)
TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 40
GRAD_TOL = 1e-4           # of the gradient's norm, at the head's branches
GRAD_TOL_AHEAD = 1e-2     # ahead of them: a ReLU at f32 rounding of 0 (see above)
LOSS_KEYS = ('center_hm_loss', 'center_reg_loss', 'loss')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the two reduced models ---------------------------------------------------

class Fake:
    """The dataset surface that `build_detector` and the steps read."""

    def __init__(self, classes, pcr, voxel_size, nfeat, max_voxels, k):
        self.class_names = list(classes)
        self.point_cloud_range = np.asarray(pcr, np.float32)
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.grid_size = np.round((self.point_cloud_range[3:] - self.point_cloud_range[:3])
                                  / self.voxel_size).astype(np.int64)
        self.num_point_features = nfeat
        self.voxel_cfg = {'voxel_size': tuple(float(v) for v in voxel_size),
                          'max_points_per_voxel': k, 'max_voxels': max_voxels}


def _pillar_model():
    """tests/test_centerpoint.py's CenterPoint: 1 class, 32 × 32 pillars."""
    cfg = _plain(centerpoint_cfg())
    ds = Fake(['Car'], [0.0, -6.4, -3.0, 12.8, 6.4, 1.0], [0.4, 0.4, 4.0], 4, 256, 8)
    return cfg, ds


def _dyn_pillar_model():
    """centerpoint_dyn_pillar_1x.yaml's MODEL at narrow widths, 3 classes."""
    cfg = _plain(tload(WAYMO / 'centerpoint_dyn_pillar_1x.yaml').MODEL)
    cfg['VFE']['NUM_FILTERS'] = [16, 16]
    cfg['MAP_TO_BEV']['NUM_BEV_FEATURES'] = 16
    b = cfg['BACKBONE_2D']
    b['LAYER_NUMS'], b['NUM_FILTERS'], b['NUM_UPSAMPLE_FILTERS'] = [1, 1, 1], [16, 32, 64], \
        [16, 16, 16]
    cfg['DENSE_HEAD']['SHARED_CONV_CHANNEL'] = 16
    ds = Fake(['Vehicle', 'Pedestrian', 'Cyclist'], RANGE, [0.32, 0.32, 6.0], 5, 1024, 1)
    return cfg, ds


MODELS = {'centerpoint': _pillar_model, 'dyn_pillar': _dyn_pillar_model}


def _host(ds, seed):
    """2 frames of points over (and past) the range, the second frame 300
    points shorter; gts of every class, the last rows padding."""
    rng = np.random.RandomState(seed)
    pcr = ds.point_cloud_range
    n = 3200
    pts = np.zeros((2, n, ds.num_point_features), np.float32)
    for d in range(3):
        span = pcr[d + 3] - pcr[d]
        pts[..., d] = rng.uniform(pcr[d] - 0.05 * span, pcr[d + 3] + 0.05 * span, (2, n))
    pts[..., 3:] = rng.rand(2, n, ds.num_point_features - 3)
    num = np.array([n, n - 300], np.int32)
    pts[1, n - 300:] = 0.0
    nc = len(ds.class_names)
    gt = np.zeros((2, 6, 8), np.float32)
    for f, m in enumerate((4, 3)):
        gt[f, :m, 0] = rng.uniform(pcr[0] + 1, pcr[3] - 1, m)
        gt[f, :m, 1] = rng.uniform(pcr[1] + 1, pcr[4] - 1, m)
        gt[f, :m, 2] = rng.uniform(pcr[2] + 0.5, pcr[5] - 1, m)
        gt[f, :m, 3:6] = rng.uniform(0.8, 4.0, (m, 3))
        gt[f, :m, 6] = rng.uniform(-np.pi, np.pi, m)
        gt[f, :m, 7] = 1 + np.arange(m) % nc
    return {'points': pts, 'num_points': num, 'gt_boxes': gt}


def _geom(ds):
    return (ds.voxel_cfg, tuple(int(g) for g in ds.grid_size),
            tuple(float(x) for x in ds.point_cloud_range),
            tuple(float(v) for v in ds.voxel_size))


class Pair:
    """The JAX and the port model of one reduced config, same weights."""

    def __init__(self, name):
        cfg, self.ds = MODELS[name]()
        self.jcfg, self.tcfg = JCfg(copy.deepcopy(cfg)), TCfg(copy.deepcopy(cfg))
        self.nc = len(self.ds.class_names)
        self.host = _host(self.ds, 0)
        self.jmodel = jdet(self.jcfg, num_class=self.nc, dataset=self.ds)
        geom = _geom(self.ds)
        shapes = jax.eval_shape(
            lambda r, h: self.jmodel.init(r, jtrain.prepare_device_batch(h, *geom),
                                          training=False),
            jax.random.PRNGKey(0), jtrain.host_to_device_batch(self.host))
        self.var = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(0)), shapes)
        self.tmodel = tdet(self.tcfg, num_class=self.nc, dataset=self.ds, device='cpu')
        self.tmodel.load_state_dict(flax_to_state_dict(self.var['params'],
                                                       self.var['batch_stats']))


@pytest.fixture(scope='module', params=sorted(MODELS))
def pair(request):
    return Pair(request.param)


def test_eval_step_matches_jax(pair):
    jstep = jeval.make_eval_step(pair.jmodel, pair.ds, pair.jcfg.POST_PROCESSING, pair.nc)
    tstep = teval.make_eval_step(pair.tmodel, pair.ds, pair.tcfg.POST_PROCESSING, pair.nc)
    jp, jr = jstep(pair.var, jtrain.host_to_device_batch(pair.host))
    tp, tr = tstep(ttrain.host_to_device_batch(pair.host, 'cpu'))
    assert set(tp) == set(jp)
    for k in ('pred_valid', 'pred_labels'):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]), err_msg=k)
    for k in ('pred_boxes', 'pred_scores', 'pred_logits', 'pred_box_unique_density'):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL, err_msg=k)
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_array_equal(_np(tr[k]), _np(jr[k]), err_msg=k)
    assert _np(tp['pred_valid']).sum() > 0
    assert isinstance(pair.tmodel.dense_head, CenterHead)


def test_train_step_matches_jax(pair):
    """One step of each package's ``make_train_step`` from the same
    weights: losses, the gradients as the backward left them, the updated
    parameters and BN statistics."""
    opt_cfg = tload(WAYMO / 'centerpoint.yaml').OPTIMIZATION
    geom = _geom(pair.ds)
    jbatch = jtrain.host_to_device_batch(pair.host)
    var = pair.var

    def loss_fn(params):
        out, _ = pair.jmodel.apply({'params': params, 'batch_stats': var['batch_stats']},
                                   jtrain.prepare_device_batch(jbatch, *geom),
                                   training=True, mutable=['batch_stats'])
        return pair.jmodel.compute_loss(out)
    (_, jtb), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var['params'])
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), var['batch_stats'])
    joptim, _ = jopt(jload(WAYMO / 'centerpoint.yaml').OPTIMIZATION, total_steps=STEPS)
    state = jtrain.TrainState(params=var['params'], batch_stats=var['batch_stats'],
                              opt_state=joptim.init(var['params']),
                              step=jax.numpy.asarray(0, jax.numpy.int32))
    state, jm = jtrain.make_train_step(pair.jmodel, joptim, pair.ds)(
        state, jbatch, jax.random.PRNGKey(1))
    jafter = flax_to_state_dict(jax.tree.map(np.asarray, state.params),
                                jax.tree.map(np.asarray, state.batch_stats))

    model = copy.deepcopy(pair.tmodel)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optim, _ = topt(opt_cfg, STEPS, model.parameters())
    update, tgrads = optim.step, {}

    def keep_grads_then_update():
        tgrads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        update()
    optim.step = keep_grads_then_update
    _, tm = ttrain.make_train_step(model, optim, pair.ds)(
        ttrain.init_train_state(model, optim), ttrain.host_to_device_batch(pair.host, 'cpu'))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(jtb[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    assert float(tm['center_reg_loss']) > 0
    for name, g in tgrads.items():
        ref = jgrads[name].numpy()
        tol = GRAD_TOL if name.startswith('dense_head.heads_list.') else GRAD_TOL_AHEAD
        assert np.linalg.norm(_np(g) - ref) <= tol * np.linalg.norm(ref) + 1e-7, name
    # Adam's first step moves each element by its first-step LR times the
    # sign of its gradient: where the two packages' gradients differ in sign
    # (gradients near 0), 2 LR apart
    lr0 = float(opt_cfg.LR) / float(opt_cfg.DIV_FACTOR)
    flips = 0
    for name, v in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        got, want = _np(v), jafter[name].numpy()
        flip = np.zeros(got.shape, bool)
        if name in tgrads:
            flip = np.sign(_np(tgrads[name])) != np.sign(jgrads[name].numpy())
        flips += int(flip.sum())
        np.testing.assert_allclose(got[~flip], want[~flip], atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[flip], want[flip], atol=2 * lr0 + 1e-4, rtol=0,
                                   err_msg=name)
        assert not torch.equal(v, before[name]), name
    assert flips <= 1e-3 * sum(p.numel() for p in model.parameters()), flips


# ---- the Waymo configs over a generated tree ---------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('waymo_centerpoint') / 'waymo'
    chip_smoke.write_waymo_tree(root, tag='_' + uuid.uuid4().hex[:12], **TREE)
    cfg = tload(WAYMO / 'centerpoint.yaml')
    cfg.DATA_CONFIG.DATA_PATH, cfg.DATA_CONFIG.POINT_CLOUD_RANGE = str(root), RANGE
    ds = twaymo.WaymoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False, root_path=root)
    ds.create_groundtruth_database(
        info_path=root / 'waymo_processed_data_infos_train.pkl', save_path=root,
        split='train', sampled_interval=1, used_classes=cfg.CLASS_NAMES,
        processed_data_tag='waymo_processed_data')
    return root


@pytest.mark.parametrize('name', CONFIGS)
def test_centerhead_configs_build_at_full_width(tree, name):
    cfg = tload(WAYMO / name)
    cfg.DATA_CONFIG.DATA_PATH = str(tree)
    train_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=True)
    test_set, _, _ = tbuild(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0, training=False)
    assert type(train_set).__name__ == 'WaymoDataset' and train_set.num_point_features == 5
    dyn = name == 'centerpoint_dyn_pillar_1x.yaml'
    assert test_set.voxel_cfg['max_voxels'] == (40000 if dyn else 150000)
    model = tdet(cfg.MODEL, 3, train_set, device='cpu')
    head = model.dense_head
    assert isinstance(head, CenterHead) and head.stride == 8 and head.max_objs == 64
    assert model.backbone_2d.num_bev_features == (384 if 'pillar' in name else 512)
    # each init sets every tensor (none left NaN) and keeps the heatmap prior
    for init in (flax_init, init_weights):
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                if t.is_floating_point():
                    t.fill_(float('nan'))
            head.heads_list[0].hm[1].bias.fill_(-2.19)
        init(model, torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(v).all()) for v in model.state_dict().values()
                   if v.is_floating_point()), init.__name__
        assert torch.equal(head.heads_list[0].hm[1].bias, torch.full((3,), -2.19))
    # every port tensor has its Flax counterpart at full width (traced)
    jc = jload(WAYMO / name)
    jc.DATA_CONFIG.DATA_PATH = str(tree)
    jset, jloader, _ = jbuild(jc.DATA_CONFIG, jc.CLASS_NAMES, 1, workers=0, training=False)
    jmodel = jdet(jc.MODEL, num_class=3, dataset=jset)
    geom = _geom(jset)
    shapes = jax.eval_shape(
        lambda r, h: jmodel.init({'params': r, 'dropout': r},
                                 jtrain.prepare_device_batch(h, *geom), training=False),
        jax.random.PRNGKey(0), jtrain.host_to_device_batch(next(iter(jloader))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_state_dict(zeros['params'], zeros['batch_stats'], jc.MODEL)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    assert all(tuple(sd[k].shape) == tuple(mine[k].shape) for k in sd)


def _reduced_centerpoint(root):
    """centerpoint.yaml over the tree: its range, f32 and narrow widths,
    buffers of 1 024 voxels / 2 048 points, batch 2, LR 0.003."""
    c = tload(WAYMO / 'centerpoint.yaml')
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
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.POST_PROCESSING.NMS_CONFIG.MATRIX_CAP = 64
    m.POST_PROCESSING.SCORE_THRESH = 0.0
    c.OPTIMIZATION.NUM_EPOCHS = 1
    return c


def test_train_then_test_main_on_waymo(tree, tmp_path, monkeypatch):
    cfg = _reduced_centerpoint(tree)
    yml = tmp_path / 'centerpoint_reduced.yaml'
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
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values()
               if v.is_floating_point())
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    ap = test_cli.main(['--cfg_file', str(yml), '--ckpt', str(ckpt), '--output_dir',
                        str(tmp_path / 'test'), '--device', 'cpu'])
    assert any(k.startswith('Car') for k in ap)
    assert np.isfinite([float(v) for v in ap.values()]).all()
    assert (tmp_path / 'test' / 'eval' / 'result.pkl').exists()


# ---- the OpenPCDet import -----------------------------------------------------

def _openpcdet_state(model, seed):
    """A seeded OpenPCDet ``model_state`` of ``model``'s CenterPoint: the
    port's names, but each head branch as OpenPCDet lays it out
    (``{branch}.0.0`` a conv with its ``USE_BIAS_BEFORE_NORM`` bias,
    ``{branch}.0.1`` its BatchNorm) and the shared conv with a bias."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, t in model.state_dict().items():
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.tensor(int(rng.randint(1, 10 ** 6)))
            continue
        value = 0.5 + rng.rand(*t.shape) if key.endswith('running_var') \
            else rng.randn(*t.shape) * 0.05
        sd[key] = torch.from_numpy(value.astype(np.float32))
    c = model.dense_head.shared_conv[0].out_channels
    sd['dense_head.shared_conv.0.bias'] = torch.from_numpy(rng.randn(c).astype(np.float32))
    for branch in ('hm', 'center', 'center_z', 'dim', 'rot'):
        bn = f'dense_head.heads_list.0.{branch}.0.1'
        sd[f'{bn}.weight'] = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32))
        sd[f'{bn}.bias'] = torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32))
        sd[f'{bn}.running_mean'] = torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32))
        sd[f'{bn}.running_var'] = torch.from_numpy((0.5 + rng.rand(c)).astype(np.float32))
        sd[f'{bn}.num_batches_tracked'] = torch.tensor(7)
    return sd


def test_openpcdet_import_equals_the_jax_import(tmp_path):
    p = Pair('centerpoint')
    sd = _openpcdet_state(p.tmodel, seed=4)
    path = tmp_path / 'centerpoint.pth'
    torch.save({'model_state': sd, 'epoch': 3}, path)
    zeros = jax.tree.map(np.zeros_like, p.var)
    jp, js, jreport, _ = jckpt.import_openpcdet_checkpoint(str(path), zeros['params'],
                                                            zeros['batch_stats'])
    want = flax_to_state_dict(jp, js)
    model = copy.deepcopy(p.tmodel)
    report, meta = ockpt.import_openpcdet_checkpoint(str(path), model)
    got = model.state_dict()
    assert meta == {'epoch': 3}
    assert not report['mismatched'] and not report['unmatched_target']
    assert not jreport['mismatched'] and not jreport['unmatched_target']
    assert report['unused_source'] == ['dense_head.shared_conv.0.bias']
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith('num_batches_tracked'):
            assert torch.equal(got[key], sd[key]), key         # JAX keeps none
        else:
            assert torch.equal(got[key], value), key
    # the fold reproduces OpenPCDet's branch (conv, BN, ReLU, conv; the conv's
    # own bias dropped as both importers drop it) at inference, in f64
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 8, 8))
    t = 'dense_head.heads_list.0.dim.0'
    ref = torch.nn.functional.conv2d(x, sd[f'{t}.0.weight'].double(), padding=1)
    ref = torch.nn.functional.batch_norm(
        ref, sd[f'{t}.1.running_mean'].double(), sd[f'{t}.1.running_var'].double(),
        sd[f'{t}.1.weight'].double(), sd[f'{t}.1.bias'].double(), eps=1e-3)
    branch = copy.deepcopy(model.dense_head.heads_list[0].dim[0][0]).double()
    with torch.no_grad():
        np.testing.assert_allclose(branch(x).numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_openpcdet_import_of_two_head_groups_raises():
    model = Pair('centerpoint').tmodel
    model.model_cfg['DENSE_HEAD']['CLASS_NAMES_EACH_HEAD'] = [['Car'], ['Pedestrian']]
    with pytest.raises(NotImplementedError, match='2 head groups'):
        ockpt.map_openpcdet_state({}, model)

"""The parts of the port's train step against the JAX package, one by one:
the target assigner, the losses, the LR schedule, the optimizer update, and
the checkpoint round trip.

Tolerances:
  * target assigner: labels and reg weights exactly (the IoU is computed in
    the JAX order, so the force match's float-equality ties fall the same
    way), regression targets within 1e-5;
  * loss functions and the head's losses: rtol 1e-6 (the same f32
    formulas), 1e-5 for sums over all anchors;
  * schedule: within 1e-7 relative of ``optax.cosine_onecycle_schedule`` at
    every step of a 40-step run (its cosine in float32, as optax computes it);
  * optimizer: one update of the clip + adamw / adam / sgd chain, below and
    above the clip threshold, within 1e-6 of the optax chain's;
  * checkpoint: the restored state equal to the saved one, bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# torch.optim imports torch._dynamo at its first use, and torch._dynamo
# imports cProfile, which breaks once tests/test_vis_html.py has put tools/
# (and its profile.py) first on sys.path: import it while collecting
import torch._dynamo  # noqa: F401

from crb_active_3ddet_tpu.config import load_config as jload
from crb_active_3ddet_tpu.models.dense_heads import anchor_head_single as jahs
from crb_active_3ddet_tpu.runtime.optimization import build_optimizer as jopt
from crb_active_3ddet_tpu.utils import loss_utils as jloss

from crb_active_3ddet_torch.config import load_config as tload
from crb_active_3ddet_torch.models.dense_heads import anchor_head_single as tahs
from crb_active_3ddet_torch.runtime import checkpoint as tckpt
from crb_active_3ddet_torch.runtime import train as ttrain
from crb_active_3ddet_torch.runtime.optimization import build_optimizer as topt
from crb_active_3ddet_torch.utils import loss_utils as tloss

ROOT = Path(__file__).resolve().parent.parent
CFG = ROOT / 'tools/cfgs/synthetic_models/second_synth.yaml'
GRID = (96, 80, 40)          # an 12×10 anchor map, stride 8
PCR = (0.0, -2.0, -3.0, 4.8, 2.0, 1.0)   # 0.05 m voxels, as second_synth


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- target assigner ----

def _heads():
    jc, tc = jload(CFG), tload(CFG)
    names = jc.CLASS_NAMES
    jcore = jahs.make_core(jc.MODEL.DENSE_HEAD, 3, names, np.asarray(GRID), list(PCR))
    thead = tahs.AnchorHeadSingle(tc.MODEL.DENSE_HEAD, 8, 3, names, GRID, PCR)
    return jcore, thead


def _gt(seed, anchors):
    """(3, 7, 8) gt: random multi-class boxes near the anchors, zero-padded
    rows, an exact copy of one anchor twice (IoU 1 with it from two gts:
    the argmax tie), and a box centred between two anchors of the same
    size and heading (two anchors with exactly its max IoU: force-match
    ties).  Frame 2 is all padding."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((3, 7, 8), np.float32)
    a = anchors.reshape(-1, anchors.shape[-1])
    for f in range(2):
        n = 4 + f
        pick = a[rng.randint(0, len(a), n)]
        gt[f, :n, :7] = pick[:, :7]
        gt[f, :n, :2] += rng.uniform(-0.3, 0.3, (n, 2))
        gt[f, :n, 3:6] *= rng.uniform(0.8, 1.25, (n, 3))
        gt[f, :n, 6] += rng.uniform(-0.3, 0.3, n)
        gt[f, :n, 7] = rng.randint(1, 4, n)
    car = a[37]                               # a Car anchor (class order)
    gt[0, 5, :7] = gt[0, 6, :7] = car[:7]
    gt[0, 5, 7] = gt[0, 6, 7] = 1
    gt[1, 5, :7] = car[:7]
    gt[1, 5, 0] += 0.2                         # half-way to the next x anchor
    gt[1, 5, 7] = 1
    return gt


@pytest.mark.parametrize('seed', [0, 1])
def test_target_assigner_equals_jax(seed):
    jcore, thead = _heads()
    gt = _gt(seed, jcore._flat_anchors_np)
    ref = jax.tree.map(np.asarray, jcore.assign_targets(jnp.asarray(gt)))
    got = thead.assign_targets(_t(gt))
    np.testing.assert_array_equal(got['box_cls_labels'].numpy(), ref['box_cls_labels'])
    np.testing.assert_array_equal(got['reg_weights'].numpy(), ref['reg_weights'])
    np.testing.assert_allclose(got['box_reg_targets'].numpy(), ref['box_reg_targets'],
                               atol=1e-5, rtol=0)
    labels = ref['box_cls_labels']
    assert set(np.unique(labels[:2])) >= {-1, 0, 1}      # ignore, bg, fg
    assert np.all(labels[2] == 0)                      # no gt: all background
    assert (labels[1] == 1).sum() >= 2                  # the tie force-matched


# ---- losses ----

LOSSES = ['focal', 'smooth_l1', 'weighted_smooth_l1', 'weighted_l1', 'cross_entropy']


@pytest.mark.parametrize('name', LOSSES)
def test_loss_function_equals_jax(name):
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(2, 50, 7)).astype(np.float32)
    y = rng.randn(2, 50, 7).astype(np.float32)
    w = rng.rand(2, 50).astype(np.float32)
    cw = [1.0, 1.0, 2.0, 1.0, 0.5, 1.0, 1.0]
    if name == 'focal':
        t = (rng.rand(2, 50, 7) < 0.2).astype(np.float32)
        got = tloss.sigmoid_focal_cls_loss(_t(x), _t(t), _t(w))
        ref = jloss.sigmoid_focal_cls_loss(jnp.asarray(x), jnp.asarray(t), jnp.asarray(w))
    elif name == 'smooth_l1':
        got = tloss.smooth_l1_loss(_t(x))
        ref = jloss.smooth_l1_loss(jnp.asarray(x))
    elif name in ('weighted_smooth_l1', 'weighted_l1'):
        y[0, 3, 2] = np.nan                     # a NaN target counts as no error
        fn_t, fn_j = ((tloss.weighted_smooth_l1_loss, jloss.weighted_smooth_l1_loss)
                      if name == 'weighted_smooth_l1'
                      else (tloss.weighted_l1_loss, jloss.weighted_l1_loss))
        got = fn_t(_t(x), _t(y), _t(w), code_weights=cw)
        ref = fn_j(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), code_weights=cw)
    else:
        t = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (2, 50))]
        got = tloss.weighted_cross_entropy_loss(_t(x), _t(t), _t(w))
        ref = jloss.weighted_cross_entropy_loss(jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(w))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('reduce', [True, False])
def test_head_losses_equal_jax(reduce):
    """get_loss over random predictions and assigned targets, reduced and
    per frame (``reduce=False``, which BADGE, CRB and llal read)."""
    jcore, thead = _heads()
    gt = _gt(0, jcore._flat_anchors_np)
    targets = jax.tree.map(np.asarray, jcore.assign_targets(jnp.asarray(gt)))
    rng = np.random.RandomState(4)
    ny, nx = GRID[1] // 8, GRID[0] // 8
    a = sum(jcore.num_anchors_per_location)
    batch = {'cls_preds': rng.randn(3, ny, nx, a * 3).astype(np.float32),
             'box_preds': 0.3 * rng.randn(3, ny, nx, a * 7).astype(np.float32),
             'dir_cls_preds': rng.randn(3, ny, nx, a * 2).astype(np.float32),
             **targets}
    jl, jtb = jahs.get_loss({k: jnp.asarray(v) for k, v in batch.items()}, jcore,
                            reduce=reduce)
    tl, ttb = tahs.get_loss({k: _t(v) for k, v in batch.items()}, thead, reduce=reduce)
    for k in jtb:
        np.testing.assert_allclose(ttb[k].numpy(), np.asarray(jtb[k]), rtol=1e-5,
                                   err_msg=k)
    assert np.shape(jtb['rpn_loss']) == (() if reduce else (3,))


# ---- schedule and optimizer ----

def test_onecycle_schedule_equals_optax():
    jc, tc = jload(CFG), tload(CFG)
    _, jsched = jopt(jc.OPTIMIZATION, total_steps=40)
    _, tsched = topt(tc.OPTIMIZATION, 40, [torch.zeros(1, requires_grad=True)])
    ref = optax.cosine_onecycle_schedule(40, 0.003, 0.4, 10.0, 1e4)
    for i in range(41):
        np.testing.assert_allclose(tsched(i), float(ref(i)), rtol=1e-7, err_msg=str(i))
        np.testing.assert_allclose(tsched(i), float(jsched(i)), rtol=1e-7)
    assert tsched(0) == pytest.approx(0.0003) and tsched(16) == pytest.approx(0.003)


def _params(rng):
    return {'a': rng.randn(16, 8).astype(np.float32),
            'b': rng.randn(8).astype(np.float32),
            'c': rng.randn(3, 4, 5).astype(np.float32)}


@pytest.mark.parametrize('name', ['adam_onecycle', 'adam', 'sgd'])
@pytest.mark.parametrize('norm', [3.0, 40.0], ids=['below_clip', 'above_clip'])
def test_optimizer_update_equals_optax(name, norm):
    """Two updates (the second mid-schedule, with the moments of the first)
    of the chain at GRAD_NORM_CLIP 10, from gradients of global norm 3 or
    40."""
    jcfg, tcfg = jload(CFG).OPTIMIZATION, tload(CFG).OPTIMIZATION
    for c in (jcfg, tcfg):
        c.OPTIMIZER = name
        c.DECAY_STEP_LIST = [1]            # adam/sgd: the LR decays at step 1
    rng = np.random.RandomState(5)
    params = _params(rng)
    jchain, _ = jopt(jcfg, total_steps=40)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jchain.init(jp)
    tp = {k: _t(v.copy()).requires_grad_() for k, v in params.items()}
    tchain, _ = topt(tcfg, 40, tp.values())
    for _ in range(2):
        g = _params(rng)
        total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        g = {k: (v * norm / total).astype(np.float32) for k, v in g.items()}
        upd, state = jchain.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k].copy())
        tchain.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0, err_msg=f'{name} {k}')
    assert tchain.count == 2


# ---- checkpoint ----

def test_checkpoint_round_trip(tmp_path):
    cfg = tload(CFG).OPTIMIZATION

    def state():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.BatchNorm1d(6))
        return ttrain.init_train_state(model, topt(cfg, 40, model.parameters())[0])

    def step(st, x):
        st.model.train()
        st.optimizer.zero_grad()
        st.model(x).square().mean().backward()
        st.optimizer.step()
        st.step += 1

    x = torch.randn(5, 4)
    a = state()
    step(a, x)
    for epoch in (2, 10, 3):
        tckpt.save_checkpoint(tckpt.checkpoint_state(a, epoch=epoch, it=a.step),
                              str(tmp_path / f'checkpoint_epoch_{epoch}'))
    path, epoch = tckpt.find_latest_checkpoint(tmp_path)
    assert epoch == 10 and path.endswith('checkpoint_epoch_10.pth')
    ck = tckpt.load_checkpoint(path)
    assert set(ck) == {'epoch', 'it', 'version', 'model_state', 'batch_stats',
                       'optimizer_state', 'step'}
    assert set(ck['batch_stats']) == {'1.running_mean', '1.running_var',
                                      '1.num_batches_tracked'}
    b = tckpt.restore_train_state(state(), ck)
    assert b.step == a.step == 1 and b.optimizer.count == 1
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    step(a, x)
    step(b, x)                              # the same second step from the copy
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert tckpt.find_latest_checkpoint(tmp_path / 'none') == (None, 0)

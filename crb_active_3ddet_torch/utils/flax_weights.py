"""Weight transfer: the JAX package's Flax ``params`` / ``batch_stats`` → the
port model's ``state_dict``.

Input: nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)`` of the
JAX variables).  Output: ``{name: torch.Tensor}`` under OpenPCDet's names
(``backbone_3d.conv_input.0.weight``, ``backbone_2d.blocks.0.1.weight``,
``dense_head.conv_cls.weight``, …), so that a later step can load an
OpenPCDet ``.pth`` into the same model.  Layouts:
  * Conv2d: Flax HWIO → torch OIHW; 1×1 head convs likewise;
  * ConvTranspose2d: Flax (kh, kw, in, out), taps mirrored relative to
    torch → torch (in, out, kh, kw) (the inverse of the JAX package's
    ``utils/torch_ckpt.py:215 _t_convtranspose2d``);
  * sparse conv kernels: kept as (K, Cin, Cout), the gather-GEMM's layout;
  * BN: scale/bias → weight/bias, batch_stats mean/var → running_mean/var;
  * PillarVFE: ``vfe.PFNLayer_{i}.Dense_0`` (in, out) → OpenPCDet's
    ``vfe.pfn_layers.{i}.linear`` (out, in), ``BatchNorm_0`` →
    ``vfe.pfn_layers.{i}.norm`` (the names the JAX package's ``.pth``
    importer reads);
  * Dense (in, out) → Linear (out, in), or a k=1 Conv1d / Conv2d weight
    (out, in, 1[, 1]) where the port keeps OpenPCDet's conv layers (PV-RCNN's
    point branch).  Flax auto-names inside a StackSAModuleMSG run across the
    radius loop (``Dense_0, Dense_1`` branch 0, ``Dense_2, Dense_3`` branch
    1); ``SA_x_conv{i}`` become ``SA_layers.{k}`` in FEATURES_SOURCE order.
    The shared FC's input stays grid-major, as in the JAX package.
  * llal's LossNet: ``roi_head.loss_net.conv_{k}`` / ``bn_{k}`` →
    ``roi_head.loss_net.conv_layers.{k}.{0,1}`` (a Conv1d(C_k, 1, 1) and its
    BatchNorm1d), ``linear`` → ``roi_head.loss_net.linear``.

``optax_to_optimizer_state`` moves the optimizer state of a JAX
``TrainState`` (Adam's ``mu``/``nu``/``count`` and the schedule's count)
into the port's ``Optimizer`` (torch Adam's ``exp_avg``/``exp_avg_sq``/``step``)
under the same name map, so that both packages can continue from one
mid-schedule state.
"""

from __future__ import annotations

import numpy as np
import torch

# Flax SparseConvLayer_{i} order of VoxelBackBone8x → OpenPCDet module names
VOXEL8X_ORDER = [
    'conv_input', 'conv1.0',
    'conv2.0', 'conv2.1', 'conv2.2',
    'conv3.0', 'conv3.1', 'conv3.2',
    'conv4.0', 'conv4.1', 'conv4.2',
    'conv_out',
]


def conv2d_from_flax(w):
    """Flax Conv (kh, kw, in, out) → torch Conv2d (out, in, kh, kw)."""
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def convtranspose2d_from_flax(w):
    """Flax ConvTranspose (kh, kw, in, out) → torch ConvTranspose2d
    (in, out, kh, kw): un-mirror the taps, then move the axes."""
    return np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1))


def _bn(sd, prefix, params, stats):
    sd[f'{prefix}.weight'] = params['scale']
    sd[f'{prefix}.bias'] = params['bias']
    sd[f'{prefix}.running_mean'] = stats['mean']
    sd[f'{prefix}.running_var'] = stats['var']
    sd[f'{prefix}.num_batches_tracked'] = np.zeros((), np.int64)


def _dense(w, extra_dims=0):
    """Flax Dense (in, out) → (out, in) plus ``extra_dims`` unit axes."""
    w = np.asarray(w).T
    return w.reshape(*w.shape, *([1] * extra_dims))


def sa_module_from_flax(sd, prefix, params, stats, mlps):
    """StackSAModuleMSG: flat Dense_i / BatchNorm_i → mlps.{branch}.{3j, 3j+1}."""
    i = 0
    for m, mlp in enumerate(mlps):
        for j in range(len(mlp)):
            sd[f'{prefix}.mlps.{m}.{3 * j}.weight'] = _dense(
                params[f'Dense_{i}']['kernel'], 2)
            _bn(sd, f'{prefix}.mlps.{m}.{3 * j + 1}',
                params[f'BatchNorm_{i}'], stats[f'BatchNorm_{i}'])
            i += 1


def _fc_stack(sd, prefix, params, stats, name, n_layers, dropout_after, out=None):
    """``{name}_fc_k`` / ``{name}_bn_k`` (+ biased ``out``) → the Conv1d
    stack ``prefix``; every Dropout entry shifts the later indices by one."""
    pos = 0
    for k in range(n_layers):
        sd[f'{prefix}.{pos}.weight'] = _dense(params[f'{name}_fc_{k}']['kernel'], 1)
        _bn(sd, f'{prefix}.{pos + 1}', params[f'{name}_bn_{k}'],
            stats[f'{name}_bn_{k}'])
        pos += 3 + (k in dropout_after)
    if out is not None:
        sd[f'{prefix}.{pos}.weight'] = _dense(params[out]['kernel'], 1)
        sd[f'{prefix}.{pos}.bias'] = params[out]['bias']


def _point_branch(sd, params, batch_stats, model_cfg):
    """PV-RCNN's pfe, point_head and roi_head."""
    pfe, spfe = params['pfe'], batch_stats['pfe']
    sa_cfg = model_cfg['PFE']['SA_LAYER']
    k = 0
    for src in model_cfg['PFE']['FEATURES_SOURCE']:
        if src == 'raw_points':
            sa_module_from_flax(sd, 'pfe.SA_rawpoints', pfe['SA_rawpoints'],
                       spfe['SA_rawpoints'], sa_cfg[src]['MLPS'])
        elif src != 'bev':
            sa_module_from_flax(sd, f'pfe.SA_layers.{k}', pfe[f'SA_{src}'],
                       spfe[f'SA_{src}'], sa_cfg[src]['MLPS'])
            k += 1
    sd['pfe.vsa_point_feature_fusion.0.weight'] = _dense(pfe['vsa_fusion']['kernel'])
    _bn(sd, 'pfe.vsa_point_feature_fusion.1', pfe['BatchNorm_0'],
        spfe['BatchNorm_0'])

    ph, sph = params['point_head'], batch_stats['point_head']
    n = len(model_cfg['POINT_HEAD']['CLS_FC'])
    for j in range(n):
        sd[f'point_head.cls_layers.{3 * j}.weight'] = _dense(ph[f'Dense_{j}']['kernel'])
        _bn(sd, f'point_head.cls_layers.{3 * j + 1}', ph[f'BatchNorm_{j}'],
            sph[f'BatchNorm_{j}'])
    sd[f'point_head.cls_layers.{3 * n}.weight'] = _dense(ph[f'Dense_{n}']['kernel'])
    sd[f'point_head.cls_layers.{3 * n}.bias'] = ph[f'Dense_{n}']['bias']

    roi_cfg = model_cfg['ROI_HEAD']
    rh, srh = params['roi_head'], batch_stats['roi_head']
    sa_module_from_flax(sd, 'roi_head.roi_grid_pool_layer', rh['roi_grid_pool'],
               srh['roi_grid_pool'], roi_cfg['ROI_GRID_POOL']['MLPS'])
    n_shared = len(roi_cfg['SHARED_FC'])
    between = range(n_shared - 1) if float(roi_cfg.get('DP_RATIO', 0.0)) > 0 else ()
    _fc_stack(sd, 'roi_head.shared_fc_layer', rh, srh, 'shared', n_shared, between)
    _fc_stack(sd, 'roi_head.cls_layers', rh, srh, 'cls', len(roi_cfg['CLS_FC']),
              (0,), out='cls_out')
    _fc_stack(sd, 'roi_head.reg_layers', rh, srh, 'reg', len(roi_cfg['REG_FC']),
              (0,), out='reg_out')
    if 'loss_net' in rh:
        ln, sln = rh['loss_net'], srh['loss_net']
        for k in range(n_shared):
            sd[f'roi_head.loss_net.conv_layers.{k}.0.weight'] = _dense(
                ln[f'conv_{k}']['kernel'], 1)
            _bn(sd, f'roi_head.loss_net.conv_layers.{k}.1', ln[f'bn_{k}'], sln[f'bn_{k}'])
        sd['roi_head.loss_net.linear.weight'] = _dense(ln['linear']['kernel'])
        sd['roi_head.loss_net.linear.bias'] = ln['linear']['bias']


def pillar_vfe_from_flax(sd, params, batch_stats):
    """PillarVFE's PFN layers; a layer without BatchNorm has a bias."""
    pv, sv = params['vfe'], batch_stats.get('vfe', {})
    i = 0
    while f'PFNLayer_{i}' in pv:
        layer = pv[f'PFNLayer_{i}']
        sd[f'vfe.pfn_layers.{i}.linear.weight'] = _dense(layer['Dense_0']['kernel'])
        if 'bias' in layer['Dense_0']:
            sd[f'vfe.pfn_layers.{i}.linear.bias'] = layer['Dense_0']['bias']
        if 'BatchNorm_0' in layer:
            _bn(sd, f'vfe.pfn_layers.{i}.norm', layer['BatchNorm_0'],
                sv[f'PFNLayer_{i}']['BatchNorm_0'])
        i += 1


def flax_to_state_dict(params, batch_stats, model_cfg=None):
    """Flax PointPillar, SECONDNet or PVRCNN variables → port ``state_dict``
    (torch tensors).  PVRCNN needs ``model_cfg`` (the MODEL node): the Flax
    names of the point branch do not say where one MLP ends and the next
    begins."""
    sd = {}
    if 'vfe' in params:
        pillar_vfe_from_flax(sd, params, batch_stats)
    if 'pfe' in params:
        _point_branch(sd, params, batch_stats, model_cfg)
    if 'backbone_3d' in params:
        p3, s3 = params['backbone_3d'], batch_stats['backbone_3d']
        for i, name in enumerate(VOXEL8X_ORDER):
            layer = f'SparseConvLayer_{i}'
            sd[f'backbone_3d.{name}.0.weight'] = p3[layer]['kernel']
            _bn(sd, f'backbone_3d.{name}.1', p3[layer]['MaskedBatchNorm_0'],
                s3[layer]['MaskedBatchNorm_0'])

    p2, s2 = params['backbone_2d'], batch_stats['backbone_2d']
    i = 0
    while f'_ConvBlock_{i}' in p2:
        blk, sblk = p2[f'_ConvBlock_{i}'], s2[f'_ConvBlock_{i}']
        j = 0
        while f'Conv_{j}' in blk:
            sd[f'backbone_2d.blocks.{i}.{1 + 3 * j}.weight'] = \
                conv2d_from_flax(blk[f'Conv_{j}']['kernel'])
            _bn(sd, f'backbone_2d.blocks.{i}.{2 + 3 * j}',
                blk[f'BatchNorm_{j}'], sblk[f'BatchNorm_{j}'])
            j += 1
        i += 1
    i = 0
    while f'_DeBlock_{i}' in p2:
        blk, sblk = p2[f'_DeBlock_{i}'], s2[f'_DeBlock_{i}']
        sd[f'backbone_2d.deblocks.{i}.0.weight'] = \
            convtranspose2d_from_flax(blk['ConvTranspose_0']['kernel'])
        _bn(sd, f'backbone_2d.deblocks.{i}.1', blk['BatchNorm_0'],
            sblk['BatchNorm_0'])
        i += 1

    for name, conv in params['dense_head'].items():
        sd[f'dense_head.{name}.weight'] = conv2d_from_flax(conv['kernel'])
        sd[f'dense_head.{name}.bias'] = conv['bias']
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _leaves_of(tree, want):
    """The named tuples of an optax state tree (named tuples, tuples,
    lists) whose fields include every name in ``want``, in order."""
    found = []
    if set(want) <= set(getattr(tree, '_fields', ())):
        found.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            found += _leaves_of(t, want)
    return found


def optax_to_optimizer_state(opt_state, batch_stats, optimizer, model,
                             model_cfg=None):
    """The numpy optax state of ``optax.chain(clip_by_global_norm,
    adamw(schedule))`` (or adam) → a ``state_dict`` for the port's
    ``runtime.optimization.Optimizer`` over ``model.parameters()``.  ``mu``
    and ``nu`` go through the same layout map as the parameters (their
    batch statistics are taken from ``batch_stats``, only for the map) and
    become torch Adam's ``exp_avg`` and ``exp_avg_sq``; Adam's count, which
    equals the schedule's, becomes each parameter's ``step`` and the
    schedule's ``count``."""
    adam, = _leaves_of(opt_state, ('mu', 'nu', 'count'))
    counts = {int(np.asarray(t.count)) for t in _leaves_of(opt_state, ('count',))}
    if len(counts) != 1:
        raise ValueError(f'Adam and schedule counts differ: {sorted(counts)}')
    count = counts.pop()
    mu = flax_to_state_dict(adam.mu, batch_stats, model_cfg)
    nu = flax_to_state_dict(adam.nu, batch_stats, model_cfg)
    dev = next(model.parameters()).device
    state = {i: {'step': torch.tensor(float(count)), 'exp_avg': mu[n].to(dev),
                 'exp_avg_sq': nu[n].to(dev)}
             for i, (n, _) in enumerate(model.named_parameters())}
    groups = optimizer.inner.state_dict()['param_groups']
    return {'count': count, 'inner': {'state': state, 'param_groups': groups}}

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
    importer reads); DynamicPillarVFE's ``vfe.Dense_{i}`` / ``BatchNorm_{i}``
    likewise (OpenPCDet's ``PFNLayerV2`` names);
  * Dense (in, out) → Linear (out, in), or a k=1 Conv1d / Conv2d weight
    (out, in, 1[, 1]) where the port keeps OpenPCDet's conv layers (PV-RCNN's
    point branch).  Flax auto-names inside a StackSAModuleMSG run across the
    radius loop (``Dense_0, Dense_1`` branch 0, ``Dense_2, Dense_3`` branch
    1); ``SA_x_conv{i}`` become ``SA_layers.{k}`` in FEATURES_SOURCE order.
    The shared FC's input stays grid-major, as in the JAX package.
  * llal's LossNet: ``roi_head.loss_net.conv_{k}`` / ``bn_{k}`` →
    ``roi_head.loss_net.conv_layers.{k}.{0,1}`` (a Conv1d(C_k, 1, 1) and its
    BatchNorm1d), ``linear`` → ``roi_head.loss_net.linear``.
  * SECONDHead: ``shared_fc_{i}`` / ``shared_bn_{i}`` → ``roi_head.shared_fc_layer``,
    ``iou_fc_{i}`` / ``iou_bn_{i}`` + ``iou_out`` → ``roi_head.iou_layers``
    (its p = 0 Dropout entry after the first block shifts the indices).
  * VoxelRCNNHead: ``pool_{src}_{k}_{in,pos,out}`` (+ ``_bn``) →
    ``roi_head.roi_grid_pool_layers.{i}.mlps_{in,pos,out}.{k}.{0,1}``;
    ``{shared,cls,reg}_fc_{i}`` / ``_fc_bn_{i}`` → ``roi_head.shared_fc_layer``,
    ``cls_fc_layers``, ``reg_fc_layers`` (Linear); ``cls_pred`` /
    ``reg_pred`` → ``roi_head.cls_pred_layer`` / ``reg_pred_layer``.
  * VoxelResBackBone8x and UNetV2: the Flax layers counted per class in
    the JAX module's instantiation order (``backbone_3d_order``): a
    ``SparseBasicBlock_n`` → ``{name}.conv{1,2}`` / ``bn{1,2}``, a
    ``SparseInverseConvLayer_n`` → ``inv_conv{level}.{0,1}``.
  * PartA2: the point head's towers (``cls_layers``, ``part_reg_layers``,
    ``box_layers``) and PartA2FCHead (``part_head_from_flax``; its dense
    conv kernels kept as (3, 3, 3, Cin, Cout)).
  * PointRCNN: PointNet2MSG's ``sa_{k}`` → ``backbone_3d.SA_modules.{k}``,
    its FP levels' ``Dense_{i}`` / ``BatchNorm_{i}`` (counted from the
    deepest level, the JAX call order) → ``backbone_3d.FP_modules.{k}.mlp``;
    PointHeadBox's towers (``cls_layers``, ``box_layers``); PointRCNNHead's
    ``xyz_up_{i}`` (+ ``xyz_up_bn_{i}`` with USE_BN), ``merge_down_0`` →
    ``roi_head.xyz_up_layer`` / ``merge_down_layer``, ``sa_{k}`` and the
    group-all level's ``sa{k}_d{li}`` / ``sa{k}_bn{li}`` →
    ``roi_head.SA_modules.{k}``, ``{cls,reg}_{i}`` / ``_bn_{i}`` + ``_out``
    → ``roi_head.{cls,reg}_layers`` (Conv1d stacks, a Dropout after the
    first block).
  * AnchorHeadMulti: ``shared_conv`` / ``shared_bn`` → ``dense_head.shared_conv.{0,1}``;
    ``head{h}_conv_cls`` / ``_conv_box`` / ``_conv_dir`` →
    ``dense_head.rpn_heads.{h}.conv_cls`` / ``conv_box`` / ``conv_dir_cls``;
    with SEPARATE_REG_CONFIG ``head{h}_cls_mid{k}`` / ``_cls_bn{k}`` →
    ``conv_cls.{3k, 3k+1}`` ahead of ``head{h}_conv_cls``, and
    ``head{h}_reg_{name}_mid{k}`` / ``_bn{k}`` + ``head{h}_conv_{name}`` →
    ``conv_box.conv_{name}.*`` likewise.
  * CenterHead: ``Conv_0`` / ``BatchNorm_0`` → ``dense_head.shared_conv.{0,1}``;
    ``{branch}_conv`` / ``{branch}_out`` →
    ``dense_head.heads_list.0.{branch}.0.0`` / ``.1``.

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
# UNetV2's decoder after its encoder, in the JAX module's instantiation
# order (``ur_block`` level 4 to 1), each with its Flax class
UNET_DECODER = [
    (name, cls) for level in (4, 3, 2, 1) for name, cls in (
        (f'conv_up_t{level}', 'SparseBasicBlock'), (f'conv_up_m{level}', 'SparseConvLayer'),
        (f'inv_conv{level}', 'SparseInverseConvLayer') if level > 1
        else ('conv5.0', 'SparseConvLayer'))]
# the strided layers of VoxelBackBone8x: the rest are VoxelResBackBone8x's blocks
STRIDED = ('conv_input', 'conv2.0', 'conv3.0', 'conv4.0', 'conv_out')


def backbone_3d_order(model_cfg):
    """[(port module name, Flax class)] of the 3D backbone's layers in the
    JAX module's instantiation order; Flax names each ``{class}_{n}`` with
    a counter per class."""
    name = model_cfg['BACKBONE_3D']['NAME']
    plain = [(n, 'SparseConvLayer') for n in VOXEL8X_ORDER]
    if name == 'VoxelResBackBone8x':
        return [(n, 'SparseConvLayer' if n in STRIDED else 'SparseBasicBlock')
                for n in VOXEL8X_ORDER]
    if name == 'UNetV2':
        if not model_cfg['BACKBONE_3D'].get('RETURN_ENCODED_TENSOR', True):
            plain = plain[:-1]
        return plain + UNET_DECODER
    return plain


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


def _fc_stack(sd, prefix, params, stats, name, n_layers, dropout_after, out=None,
              bn=None, extra_dims=1):
    """``{name}_fc_k`` / ``{bn}_k`` (``bn`` defaults to ``{name}_bn``; +
    biased ``out``) → the Conv1d stack ``prefix`` (a Linear stack with
    ``extra_dims`` 0); every Dropout entry shifts the later indices by one."""
    bn = bn or f'{name}_bn'
    pos = 0
    for k in range(n_layers):
        sd[f'{prefix}.{pos}.weight'] = _dense(params[f'{name}_fc_{k}']['kernel'], extra_dims)
        _bn(sd, f'{prefix}.{pos + 1}', params[f'{bn}_{k}'], stats[f'{bn}_{k}'])
        pos += 3 + (k in dropout_after)
    if out is not None:
        sd[f'{prefix}.{pos}.weight'] = _dense(params[out]['kernel'], extra_dims)
        sd[f'{prefix}.{pos}.bias'] = params[out]['bias']


def backbone_3d_from_flax(sd, p3, s3, model_cfg):
    """The sparse backbone's layers: a ``SparseConvLayer_n`` (or
    ``SparseInverseConvLayer_n``) → ``{name}.0.weight`` and ``{name}.1``; a
    ``SparseBasicBlock_n``'s two layers → ``{name}.conv{1,2}.weight`` and
    ``{name}.bn{1,2}``."""
    count = {}
    for name, cls in backbone_3d_order(model_cfg):
        n = count[cls] = count.get(cls, -1) + 1
        p, st = p3[f'{cls}_{n}'], s3[f'{cls}_{n}']
        if cls == 'SparseBasicBlock':
            for j in (1, 2):
                q, sq = p[f'SparseConvLayer_{j - 1}'], st[f'SparseConvLayer_{j - 1}']
                sd[f'backbone_3d.{name}.conv{j}.weight'] = q['kernel']
                _bn(sd, f'backbone_3d.{name}.bn{j}', q['MaskedBatchNorm_0'],
                    sq['MaskedBatchNorm_0'])
        else:
            sd[f'backbone_3d.{name}.0.weight'] = p['kernel']
            _bn(sd, f'backbone_3d.{name}.1', p['MaskedBatchNorm_0'], st['MaskedBatchNorm_0'])


def point_head_towers(sd, params, batch_stats, stacks):
    """A point head's towers, ``stacks`` [(module name, FC widths)] in the
    JAX call order: Flax's ``Dense_i`` / ``BatchNorm_i`` count across them →
    ``point_head.{stack}.{3j}`` (Linear) / ``.{3j + 1}``, a biased Linear
    last."""
    ph, sph = params['point_head'], batch_stats.get('point_head', {})
    k = n = 0                    # the Dense and the BatchNorm counters
    for stack, fcs in stacks:
        for j in range(len(fcs)):
            sd[f'point_head.{stack}.{3 * j}.weight'] = _dense(ph[f'Dense_{k}']['kernel'])
            _bn(sd, f'point_head.{stack}.{3 * j + 1}', ph[f'BatchNorm_{n}'],
                sph[f'BatchNorm_{n}'])
            k, n = k + 1, n + 1
        sd[f'point_head.{stack}.{3 * len(fcs)}.weight'] = _dense(ph[f'Dense_{k}']['kernel'])
        sd[f'point_head.{stack}.{3 * len(fcs)}.bias'] = ph[f'Dense_{k}']['bias']
        k += 1


def _tower(sd, prefix, params, stats, name, n_layers, extra_dims):
    """``{name}_{j}`` / ``{name}_bn_{j}`` + ``{name}_out`` → a
    ``make_fc_layers`` stack, whose Dropout after the first block shifts the
    later indices."""
    pos = 0
    for j in range(n_layers):
        sd[f'{prefix}.{pos}.weight'] = _dense(params[f'{name}_{j}']['kernel'], extra_dims)
        _bn(sd, f'{prefix}.{pos + 1}', params[f'{name}_bn_{j}'], stats[f'{name}_bn_{j}'])
        pos += 3 + (j == 0)
    sd[f'{prefix}.{pos}.weight'] = _dense(params[f'{name}_out']['kernel'], extra_dims)
    sd[f'{prefix}.{pos}.bias'] = params[f'{name}_out']['bias']


def pointnet2_from_flax(sd, p3, s3, backbone_cfg, prefix='backbone_3d.'):
    """PointNet2MSG's SA levels (``sa_{k}``) and FP levels (``Dense_{i}`` /
    ``BatchNorm_{i}`` from the deepest level) → ``{prefix}SA_modules`` and
    ``{prefix}FP_modules``."""
    for k, mlps in enumerate(backbone_cfg['SA_CONFIG']['MLPS']):
        sa_module_from_flax(sd, f'{prefix}SA_modules.{k}', p3[f'sa_{k}'], s3[f'sa_{k}'], mlps)
    i = 0
    fp = backbone_cfg['FP_MLPS']
    for k in range(len(fp) - 1, -1, -1):
        for j in range(len(fp[k])):
            sd[f'{prefix}FP_modules.{k}.mlp.{3 * j}.weight'] = _dense(p3[f'Dense_{i}']['kernel'],
                                                                     2)
            _bn(sd, f'{prefix}FP_modules.{k}.mlp.{3 * j + 1}', p3[f'BatchNorm_{i}'],
                s3[f'BatchNorm_{i}'])
            i += 1


def pointrcnn_from_flax(sd, params, batch_stats, model_cfg):
    """PointRCNN over PointNet2MSG: the backbone's SA and FP levels, the
    point head's towers and the RoI head (see the module docstring)."""
    pointnet2_from_flax(sd, params['backbone_3d'], batch_stats['backbone_3d'],
                        model_cfg['BACKBONE_3D'])
    head = model_cfg['POINT_HEAD']
    point_head_towers(sd, params, batch_stats, (('cls_layers', head['CLS_FC']),
                                                ('box_layers', head['REG_FC'])))
    roi_cfg = model_cfg['ROI_HEAD']
    rh, srh = params['roi_head'], batch_stats.get('roi_head', {})
    use_bn = bool(roi_cfg.get('USE_BN', False))
    for name, module, n in (('xyz_up', 'xyz_up_layer', len(roi_cfg['XYZ_UP_LAYER'])),
                            ('merge_down', 'merge_down_layer', 1)):
        for j in range(n):
            pos = (3 if use_bn else 2) * j
            sd[f'roi_head.{module}.{pos}.weight'] = _dense(rh[f'{name}_{j}']['kernel'], 2)
            if use_bn:
                _bn(sd, f'roi_head.{module}.{pos + 1}', rh[f'{name}_bn_{j}'],
                    srh[f'{name}_bn_{j}'])
            else:
                sd[f'roi_head.{module}.{pos}.bias'] = rh[f'{name}_{j}']['bias']
    sa_cfg = roi_cfg['SA_CONFIG']
    for k, (npoint, mlp) in enumerate(zip(sa_cfg['NPOINTS'], sa_cfg['MLPS'])):
        if int(npoint) != -1:
            sa_module_from_flax(sd, f'roi_head.SA_modules.{k}', rh[f'sa_{k}'], srh[f'sa_{k}'],
                                [mlp])
            continue
        for li in range(len(mlp)):
            sd[f'roi_head.SA_modules.{k}.mlps.0.{3 * li}.weight'] = _dense(
                rh[f'sa{k}_d{li}']['kernel'], 2)
            _bn(sd, f'roi_head.SA_modules.{k}.mlps.0.{3 * li + 1}', rh[f'sa{k}_bn{li}'],
                srh[f'sa{k}_bn{li}'])
    for tower in ('cls', 'reg'):
        _tower(sd, f'roi_head.{tower}_layers', rh, srh, tower,
               len(roi_cfg[f'{tower.upper()}_FC']), 1)


def part_head_from_flax(sd, params, batch_stats, model_cfg):
    """PartA2's point head (``Dense_i`` / ``BatchNorm_i`` counted across its
    towers in call order: cls, part, box) and RoI head (``conv_part_i`` /
    ``conv_rpn_i`` (a (3, 3, 3, Cin, Cout) kernel and ``MaskedBatchNorm_0``)
    → ``roi_head.conv_part.{i}.{0,1}``; ``shared_fc_i`` / ``shared_bn_i`` →
    ``roi_head.shared_fc_layer`` (Linear); ``{cls,reg}_i`` / ``_bn_i`` +
    ``_out`` → ``roi_head.{cls,reg}_layers``, whose p = 0 Dropout after
    the first block shifts the later indices)."""
    head = model_cfg['POINT_HEAD']
    point_head_towers(sd, params, batch_stats, (
        ('cls_layers', head.get('CLS_FC', [])), ('part_reg_layers', head.get('PART_FC', [])),
        *((('box_layers', head['REG_FC']),) if head.get('REG_FC', None) else ())))

    roi_cfg = model_cfg['ROI_HEAD']
    rh, srh = params['roi_head'], batch_stats['roi_head']
    for branch in ('conv_part', 'conv_rpn'):
        for i in range(2):
            sd[f'roi_head.{branch}.{i}.0.weight'] = rh[f'{branch}_{i}']['kernel']
            _bn(sd, f'roi_head.{branch}.{i}.1', rh[f'{branch}_{i}']['MaskedBatchNorm_0'],
                srh[f'{branch}_{i}']['MaskedBatchNorm_0'])
    n = len(roi_cfg['SHARED_FC'])
    _fc_stack(sd, 'roi_head.shared_fc_layer', rh, srh, 'shared', n,
              range(n - 1) if float(roi_cfg.get('DP_RATIO', 0.3)) > 0 else (), extra_dims=0)
    for tower in ('cls', 'reg'):
        _tower(sd, f'roi_head.{tower}_layers', rh, srh, tower,
               len(roi_cfg[f'{tower.upper()}_FC']), 0)


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

    ph, sph = params['point_head'], batch_stats.get('point_head', {})
    n = len(model_cfg['POINT_HEAD']['CLS_FC'])
    for j in range(n):
        sd[f'point_head.cls_layers.{3 * j}.weight'] = _dense(ph[f'Dense_{j}']['kernel'])
        _bn(sd, f'point_head.cls_layers.{3 * j + 1}', ph[f'BatchNorm_{j}'],
            sph[f'BatchNorm_{j}'])
    sd[f'point_head.cls_layers.{3 * n}.weight'] = _dense(ph[f'Dense_{n}']['kernel'])
    sd[f'point_head.cls_layers.{3 * n}.bias'] = ph[f'Dense_{n}']['bias']

    rh, srh = params['roi_head'], batch_stats['roi_head']
    roi_cfg = model_cfg['ROI_HEAD']
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


def second_head_from_flax(sd, params, batch_stats, model_cfg):
    """SECONDNetIoU's RoI head: the shared FC tower (Dropout entries between
    its layers when DP_RATIO > 0, the JAX default 0.3) and the IoU tower."""
    roi_cfg = model_cfg['ROI_HEAD']
    rh, srh = params['roi_head'], batch_stats['roi_head']
    n_shared = len(roi_cfg['SHARED_FC'])
    between = range(n_shared - 1) if float(roi_cfg.get('DP_RATIO', 0.3)) > 0 else ()
    _fc_stack(sd, 'roi_head.shared_fc_layer', rh, srh, 'shared', n_shared, between)
    _fc_stack(sd, 'roi_head.iou_layers', rh, srh, 'iou', len(roi_cfg['IOU_FC']), (0,),
              out='iou_out')


def voxelrcnn_head_from_flax(sd, params, batch_stats, model_cfg):
    """VoxelRCNN's RoI head: ``pool_{src}_{k}_{in,pos,out}`` (+ ``_bn``) →
    ``roi_grid_pool_layers.{i}.mlps_{in,pos,out}.{k}`` (i in FEATURES_SOURCE
    order; Conv1d, Conv2d(3, ·, 1), Conv1d), the ``shared_fc`` / ``cls_fc`` /
    ``reg_fc`` towers (``{tower}_{i}`` / ``{tower}_bn_{i}``, Linear stacks,
    a Dropout between their layers when DP_RATIO > 0), ``cls_pred`` and
    ``reg_pred`` → ``cls_pred_layer`` and ``reg_pred_layer``."""
    roi_cfg = model_cfg['ROI_HEAD']
    rh, srh = params['roi_head'], batch_stats['roi_head']
    pool = roi_cfg['ROI_GRID_POOL']
    for i, src in enumerate(pool['FEATURES_SOURCE']):
        for k in range(len(pool['POOL_LAYERS'][src]['MLPS'])):
            nm, layer = f'pool_{src}_{k}', f'roi_head.roi_grid_pool_layers.{i}'
            for part, dims in (('in', 1), ('pos', 2), ('out', 1)):
                sd[f'{layer}.mlps_{part}.{k}.0.weight'] = _dense(
                    rh[f'{nm}_{part}']['kernel'], dims)
                _bn(sd, f'{layer}.mlps_{part}.{k}.1', rh[f'{nm}_{part}_bn'],
                    srh[f'{nm}_{part}_bn'])
    dp = float(roi_cfg.get('DP_RATIO', 0.3))
    for tower in ('shared', 'cls', 'reg'):
        n = len(roi_cfg[f'{tower.upper()}_FC'])
        prefix = 'roi_head.shared_fc_layer' if tower == 'shared' else f'roi_head.{tower}_fc_layers'
        _fc_stack(sd, prefix, rh, srh, tower, n, range(n - 1) if dp > 0 else (),
                  bn=f'{tower}_fc_bn', extra_dims=0)
    for name in ('cls_pred', 'reg_pred'):
        sd[f'roi_head.{name}_layer.weight'] = _dense(rh[name]['kernel'])
        sd[f'roi_head.{name}_layer.bias'] = rh[name]['bias']


def center_head_from_flax(sd, params, batch_stats):
    """CenterHead's shared conv and BatchNorm and its branches' two convs."""
    p, s = params['dense_head'], batch_stats['dense_head']
    sd['dense_head.shared_conv.0.weight'] = conv2d_from_flax(p['Conv_0']['kernel'])
    _bn(sd, 'dense_head.shared_conv.1', p['BatchNorm_0'], s['BatchNorm_0'])
    for branch in ('hm', 'center', 'center_z', 'dim', 'rot'):
        for flax_name, port in ((f'{branch}_conv', '0.0'), (f'{branch}_out', '1')):
            target = f'dense_head.heads_list.0.{branch}.{port}'
            sd[f'{target}.weight'] = conv2d_from_flax(p[flax_name]['kernel'])
            sd[f'{target}.bias'] = p[flax_name]['bias']


def dense_head_from_flax(sd, params, batch_stats):
    """AnchorHeadSingle's three convs, AnchorHeadMulti's shared conv and
    towers, or CenterHead's convs (the names say which; see the module
    docstring)."""
    import re
    if 'hm_out' in params['dense_head']:
        return center_head_from_flax(sd, params, batch_stats)
    p, s = params['dense_head'], batch_stats.get('dense_head', {})
    towers, separate = {}, set()    # (head, tag) -> middle convs; SEPARATE_REG heads
    for name in p:
        m = re.fullmatch(r'head(\d+)_(cls|reg_\w+)_mid(\d+)', name)
        if m:
            key = (m.group(1), m.group(2))
            towers[key] = max(towers.get(key, 0), int(m.group(3)) + 1)
        m = re.fullmatch(r'head(\d+)_conv_(\w+)', name)
        if m and m.group(2) not in ('cls', 'box', 'dir'):
            separate.add(m.group(1))
    for name, v in p.items():
        if name == 'shared_conv':
            sd['dense_head.shared_conv.0.weight'] = conv2d_from_flax(v['kernel'])
            continue
        if name == 'shared_bn':
            _bn(sd, 'dense_head.shared_conv.1', v, s['shared_bn'])
            continue
        m = re.fullmatch(r'head(\d+)_(?:(conv_cls|conv_box|conv_dir)|conv_(\w+)'
                         r'|(cls|reg_\w+)_(mid|bn)(\d+))', name)
        if m is None:               # AnchorHeadSingle
            sd[f'dense_head.{name}.weight'] = conv2d_from_flax(v['kernel'])
            sd[f'dense_head.{name}.bias'] = v['bias']
            continue
        h, out, reg, tag, kind, k = m.groups()
        head = f'dense_head.rpn_heads.{h}'
        if tag is not None:         # a middle conv or its BatchNorm
            seq = f'{head}.conv_cls' if tag == 'cls' else f'{head}.conv_box.conv_{tag[4:]}'
            if kind == 'mid':
                sd[f'{seq}.{3 * int(k)}.weight'] = conv2d_from_flax(v['kernel'])
            else:
                _bn(sd, f'{seq}.{3 * int(k) + 1}', v, s[name])
            continue
        if out == 'conv_dir':
            target = f'{head}.conv_dir_cls'
        elif out == 'conv_box':
            target = f'{head}.conv_box'
        elif out == 'conv_cls':
            n_mid = towers.get((h, 'cls'), 0)
            target = f'{head}.conv_cls.{3 * n_mid}' if h in separate else f'{head}.conv_cls'
        else:
            target = f'{head}.conv_box.conv_{reg}.{3 * towers.get((h, f"reg_{reg}"), 0)}'
        sd[f'{target}.weight'] = conv2d_from_flax(v['kernel'])
        sd[f'{target}.bias'] = v['bias']


def pillar_vfe_from_flax(sd, params, batch_stats):
    """PillarVFE's PFN layers (``PFNLayer_{i}``) or DynamicPillarVFE's
    (``Dense_{i}`` and ``BatchNorm_{i}`` side by side); a layer without
    BatchNorm has a bias."""
    pv, sv = params['vfe'], batch_stats.get('vfe', {})

    def layer(i):       # (Dense, BatchNorm, its statistics) of layer i
        if 'Dense_0' in pv:
            return pv.get(f'Dense_{i}'), pv.get(f'BatchNorm_{i}'), sv.get(f'BatchNorm_{i}')
        p, s = pv.get(f'PFNLayer_{i}', {}), sv.get(f'PFNLayer_{i}', {})
        return p.get('Dense_0'), p.get('BatchNorm_0'), s.get('BatchNorm_0')
    i = 0
    while (parts := layer(i))[0] is not None:
        dense, bn, stats = parts
        sd[f'vfe.pfn_layers.{i}.linear.weight'] = _dense(dense['kernel'])
        if 'bias' in dense:
            sd[f'vfe.pfn_layers.{i}.linear.bias'] = dense['bias']
        if bn is not None:
            _bn(sd, f'vfe.pfn_layers.{i}.norm', bn, stats)
        i += 1


def flax_to_state_dict(params, batch_stats, model_cfg=None):
    """Flax PointPillar, SECONDNet, SECONDNetIoU, CenterPoint, VoxelRCNN,
    PVRCNN, PartA2 or PointRCNN variables → port ``state_dict`` (torch tensors).  The
    two-stage models and the backbones other than VoxelBackBone8x need
    ``model_cfg`` (the MODEL node): the Flax names of the point branch do
    not say where one MLP ends and the next begins, nor those of an FC tower
    where its Dropout entries stand, nor VoxelRCNN's the order of its
    sources, nor a sparse backbone's which layer is which."""
    sd = {}
    if 'vfe' in params:
        pillar_vfe_from_flax(sd, params, batch_stats)
    pointnet2 = 'sa_0' in params.get('backbone_3d', {})
    if 'pfe' in params:
        _point_branch(sd, params, batch_stats, model_cfg)
    elif pointnet2:
        pointrcnn_from_flax(sd, params, batch_stats, model_cfg)
    elif 'conv_part_0' in params.get('roi_head', {}):
        part_head_from_flax(sd, params, batch_stats, model_cfg)
    elif 'cls_pred' in params.get('roi_head', {}):
        voxelrcnn_head_from_flax(sd, params, batch_stats, model_cfg)
    elif 'roi_head' in params:
        second_head_from_flax(sd, params, batch_stats, model_cfg)
    if 'backbone_3d' in params and not pointnet2:
        backbone_3d_from_flax(sd, params['backbone_3d'], batch_stats['backbone_3d'],
                              model_cfg or {'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'}})

    p2, s2 = params.get('backbone_2d', {}), batch_stats.get('backbone_2d', {})
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

    if 'dense_head' in params:
        dense_head_from_flax(sd, params, batch_stats)
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

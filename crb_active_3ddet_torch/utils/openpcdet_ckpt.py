"""OpenPCDet checkpoints into the port's models.

Counterpart of ``crb_active_3ddet_tpu/utils/torch_ckpt.py:775
map_openpcdet_state`` and ``:834 import_openpcdet_checkpoint`` (reference
``pcdet/models/detectors/detector3d_template.py:455-536``,
``load_params_from_file``) for the families the port runs: SECOND
(``VoxelBackBone8x``, BEV, ``AnchorHeadSingle``), SECOND-IoU (``SECONDHead``),
PointPillars (``PillarVFE``), CenterPoint (``CenterHead``, ``DynPillarVFE``),
VoxelRCNN (``VoxelRCNNHead``; after ``torch_ckpt.py:668
_map_voxelrcnn_roi_head``), PV-RCNN (voxel set abstraction, point head,
PV-RCNN head, and a CenterHead RPN) and PartA2 (``UNetV2``, the part head,
``PartA2FCHead``; ``PartA2Net`` and a ``PointRCNN`` over UNetV2, i.e.
PartA2_free) and PointRCNN (``PointNet2MSG``, ``PointHeadBox``,
``PointRCNNHead``; after ``torch_ckpt.py:715 _map_pointnet2_backbone`` and
``:739 _map_pointrcnn_roi_head``).  Another family raises, naming ROADMAP
Queue 1 item 14 (14g-14h are to come), and so does ``VoxelResBackBone8x``: the JAX
package's (and so the port's) has OpenPCDet's plain stage widths, one block
in conv1 and 64 channels in conv4, where OpenPCDet's has two blocks in conv1
and 128 channels in conv4, so its conv4 and conv_out kernels have other
shapes and conv1.1 has no target.  ``AnchorHeadMulti`` raises too: under
``SEPARATE_MULTIHEAD`` an OpenPCDet head predicts its own classes only, the
JAX head (and so the port's) every class, so their cls layers have other
shapes and no weight maps across exactly; and a CenterHead of more than
one head group (``CLASS_NAMES_EACH_HEAD``): the port's head, as the JAX
package's, has one group over every class.

The port's parameter and buffer names are OpenPCDet's
(``utils/flax_weights.py``), so a source tensor goes to the target of its
own name; its layout is changed only where the two differ:
  * sparse conv kernels, in any of the shipped orientations (spconv 1.x
    (kz, ky, kx, Cin, Cout), spconv 2.x native (Cout, kz, ky, kx, Cin), or
    (kz, ky, kx, Cout, Cin)), told apart by the channel positions as the
    reference and the JAX importer (``torch_ckpt.py:228-248``) tell them,
    become (K, Cin, Cout), taps row-major over (kz, ky, kx);
  * a Linear and a k=1 Conv1d / Conv2d weight differ only in trailing unit
    axes: reshaped to the port module's shape;
  * ``roi_head.shared_fc_layer.0.weight``: OpenPCDet flattens the pooled
    RoI grid channel-major (C·G³), the port grid-major (G³·C), as the JAX
    RoI head does (``crb_active_3ddet_tpu/models/roi_heads/pvrcnn_head.py:97``);
    its input axis is permuted.  (The JAX importer maps this weight without
    the permutation.)  SECONDHead's: OpenPCDet's ``grid_sample`` output
    (B·R, C, G_y, G_x) flattened, against the port's (G_x, G_y, C)
    (``crb_active_3ddet_tpu/models/roi_heads/second_head.py:64``).
    PartA2FCHead's: OpenPCDet's ``.dense()`` of the merged sparse tensor is
    (B·R, C, X, Y, Z), viewed as C·G³; the port's (as the JAX head's) is
    (B·R, X, Y, Z, C), G³·C.  VoxelRCNNHead's is not permuted: OpenPCDet flattens its (B·R, G³, C)
    pooled grid grid-major too (its ``roi_grid_pool_layers`` and FC towers
    carry the port's names and shapes: Conv1d / Conv2d k=1 and Linear).
  * PartA2FCHead's ``conv_part`` / ``conv_rpn`` kernels: OpenPCDet's
    sparse convs over the RoI grid, in any shipped orientation as above,
    become the port's dense (3, 3, 3, Cin, Cout) kernels over the grid's
    (x, y, z) axes, as the JAX importer's ``_t_spconv_dense`` does.
  * PointNet2MSG's FP levels: OpenPCDet's ``PointnetFPModule`` reads
    [interpolated | skip] features, the port (as the JAX module) [skip |
    interpolated], so the first weight of each ``FP_modules.{k}.mlp`` has
    its two input blocks swapped (``skip_first``).  The JAX importer maps
    those weights unswapped (ROADMAP Queue 3).
  * BatchNorm weights and running statistics, ``num_batches_tracked``
    included, are copied.
  * CenterHead's branches: OpenPCDet's ``heads_list.0.{branch}.0`` is conv
    (bias-free) → BatchNorm → ReLU, the port's (as the JAX head's) a biased
    conv → ReLU, so the BatchNorm folds into the conv in f64 (exact at
    inference only: an imported model does not train as OpenPCDet's),
    ignoring the conv's own bias as the JAX importer does
    (``torch_ckpt.py:417 _fold_bn_into_conv2d``, ``:440 _map_center_head``);
    the shared conv's bias (``USE_BIAS_BEFORE_NORM``) has no target and
    stays unused, as there.
A tensor whose shape still differs is skipped and reported, and every
target without a source keeps its value (the reference's ``strict=False``;
llal's LossNet, which OpenPCDet lacks, stays at its init).  Files are read
with ``torch.load(weights_only=True)``: no pickled code runs.
"""

from __future__ import annotations

import torch

FAMILIES = ('SECONDNet', 'SECONDNetIoU', 'PointPillar', 'CenterPoint', 'VoxelRCNN', 'PVRCNN',
            'PartA2Net', 'PointRCNN')
SHARED_FC = 'roi_head.shared_fc_layer.0.weight'


def check_family(model_cfg):
    """Raise unless the port can import an OpenPCDet checkpoint of the
    model that ``model_cfg`` (the MODEL node) describes."""
    name = model_cfg['NAME']
    backbone = (model_cfg.get('BACKBONE_3D', None) or {}).get('NAME')
    if name == 'PVRCNNPlusPlus':
        raise NotImplementedError(
            'OpenPCDet import of PVRCNNPlusPlus: the port\'s vector pools (as the JAX '
            'package\'s, which has no such importer either) encode a sub-voxel\'s position in '
            '3 channels where OpenPCDet\'s encode 9 (the centre and its three neighbours\' '
            'offsets), reduce the channels otherwise and pool the RoI grid by '
            'voxel_random_choice, so their local kernels differ in shape and meaning')
    if name not in FAMILIES or (name == 'PointRCNN'
                                and backbone not in ('UNetV2', 'PointNet2MSG')):
        raise NotImplementedError(
            f'OpenPCDet import of {name} ({backbone}): the port imports '
            f'{", ".join(FAMILIES)} (PointRCNN over UNetV2 or PointNet2MSG); the rest of the '
            'model zoo comes with ROADMAP Queue 1 item 14 (14h)')
    if backbone == 'VoxelResBackBone8x':
        raise NotImplementedError(
            'OpenPCDet import of VoxelResBackBone8x: the port\'s (as the JAX package\'s) keeps '
            'VoxelBackBone8x\'s shape, one SparseBasicBlock in conv1 and 64 channels in '
            'conv4, where OpenPCDet\'s has two blocks in conv1 and 128 channels in conv4 (and '
            'conv_out 128 -> 128), so those kernels have other shapes')
    head = model_cfg.get('DENSE_HEAD', None) or {}
    if head.get('NAME') == 'CenterHead' and len(head.get('CLASS_NAMES_EACH_HEAD', [[]])) > 1:
        raise NotImplementedError(
            f"OpenPCDet import of a CenterHead of {len(head['CLASS_NAMES_EACH_HEAD'])} head "
            'groups: each OpenPCDet group predicts its own classes, the port\'s head (as the '
            'JAX package\'s) is one group over every class, so the heatmap layers differ')
    if head.get('NAME') == 'AnchorHeadMulti':
        raise NotImplementedError(
            'OpenPCDet import of AnchorHeadMulti: an OpenPCDet head under '
            'SEPARATE_MULTIHEAD predicts its own classes only, the port\'s head (as the '
            'JAX package\'s) every class, so the cls layers differ in shape')


def shared_fc_layout(model):
    """(grid points, OpenPCDet's grid axes reversed) of ``model``'s RoI head's
    pooled grid: PV-RCNN's and PartA2FCHead's G³ in one order, SECONDHead's
    G² with (G_y, G_x) against the port's (G_x, G_y); None without a RoI head,
    where the layouts agree (VoxelRCNNHead) or without a shared FC
    (PointRCNNHead)."""
    roi_head = getattr(model, 'roi_head', None)
    if roi_head is None or model.model_cfg['ROI_HEAD']['NAME'] in ('VoxelRCNNHead',
                                                                    'PointRCNNHead'):
        return None
    if model.model_cfg['ROI_HEAD']['NAME'] == 'SECONDHead':
        return roi_head.grid_size ** 2, True
    return roi_head.grid_size ** 3, False


def fp_skips(model):
    """{first FP weight's name: its skip width} of a PointNet2MSG backbone,
    else {}."""
    backbone = getattr(model, 'backbone_3d', None)
    return {f'backbone_3d.FP_modules.{k}.mlp.0.weight': c
            for k, c in enumerate(getattr(backbone, 'skip_channels', ()))}


def skip_first(w, skip):
    """An FP level's first weight (Cout, pre + skip, ...) over OpenPCDet's
    [interpolated | skip] input → over the port's [skip | interpolated]."""
    pre = w.shape[1] - skip
    return torch.cat([w[:, pre:], w[:, :pre]], dim=1)


def spconv_kernel(w, c_in, c_out):
    """A 5-D spconv kernel in a shipped orientation → (K, Cin, Cout)."""
    if w.ndim != 5:
        raise ValueError(f'spconv kernels are 5-D, got {tuple(w.shape)}')
    if w.shape[-2] == c_in and w.shape[-1] == c_out:
        pass                                    # (k, k, k, in, out), spconv 1.x
    elif w.shape[0] == c_out and w.shape[-1] == c_in:
        w = w.permute(1, 2, 3, 4, 0)            # spconv 2.x native (out, k, k, k, in)
    elif w.shape[-2] == c_out and w.shape[-1] == c_in:
        w = w.permute(0, 1, 2, 4, 3)            # (k, k, k, out, in)
    else:
        raise ValueError(f'cannot orient spconv kernel {tuple(w.shape)} '
                         f'for c_in={c_in}, c_out={c_out}')
    return w.reshape(-1, c_in, c_out)


def _grid_axes(w, grid_points, reversed_xy, src_channel_major):
    """Reorder the input axis of a (Cout, n_in[, 1]) weight between
    OpenPCDet's channel-major and the port's grid-major layout."""
    c_out, n_in = w.shape[:2]
    c = n_in // grid_points
    if not reversed_xy:
        shape = (c, grid_points) if src_channel_major else (grid_points, c)
        return w.reshape(c_out, *shape, *w.shape[2:]).transpose(1, 2).reshape(w.shape)
    g = round(grid_points ** 0.5)
    shape = (c, g, g) if src_channel_major else (g, g, c)
    tail = range(4, w.ndim + 2)
    return w.reshape(c_out, *shape, *w.shape[2:]).permute(0, 3, 2, 1, *tail) \
        .reshape(w.shape)


def grid_major(w, grid_points, reversed_xy=False):
    """The first shared FC's (Cout, C·G^d[, 1]) channel-major weight → the
    port's grid-major (Cout, G^d·C[, 1]); ``reversed_xy`` for SECONDHead's
    (C, G_y, G_x) → (G_x, G_y, C)."""
    return _grid_axes(w, grid_points, reversed_xy, True)


def channel_major(w, grid_points, reversed_xy=False):
    """The inverse of ``grid_major``: the port's layout → OpenPCDet's."""
    return _grid_axes(w, grid_points, reversed_xy, False)


def fold_center_branches(sd, eps=1e-3):
    """``sd`` with each CenterHead branch's first conv and BatchNorm
    (``dense_head.heads_list.0.{branch}.0.{0,1}``) folded into one biased
    conv (``.0.0.weight`` and ``.0.0.bias``), in f64 and rounded to f32;
    a branch without BatchNorm keeps its conv, its bias zero if it has
    none."""
    out = dict(sd)
    prefix = 'dense_head.heads_list.0.'
    for key in [k for k in sd if k.startswith(prefix) and k.endswith('.0.0.weight')]:
        conv = key[:-len('.weight')]
        bn = conv[:-1] + '1'
        w = sd[key]
        if f'{bn}.running_mean' in sd:
            inv = sd[f'{bn}.weight'].double() / torch.sqrt(sd[f'{bn}.running_var'].double() + eps)
            out[key] = (w.double() * inv[:, None, None, None]).float()
            out[f'{conv}.bias'] = (sd[f'{bn}.bias'].double()
                                   - sd[f'{bn}.running_mean'].double() * inv).float()
            for name in ('weight', 'bias', 'running_mean', 'running_var', 'num_batches_tracked'):
                out.pop(f'{bn}.{name}', None)
        elif f'{conv}.bias' not in sd:
            out[f'{conv}.bias'] = w.new_zeros(w.shape[0])
    return out


def _squeeze_trailing(shape):
    shape = list(shape)
    while len(shape) > 2 and shape[-1] == 1:
        shape.pop()
    return tuple(shape)


def _convert(key, src, tgt, layout, skips):
    """``src`` in the target's layout, or None when no rule makes it fit."""
    if key in skips and src.shape == tgt.shape:
        return skip_first(src, skips[key])
    if src.ndim == 5 and (tgt.ndim == 3 and key.startswith('backbone_3d.')
                          or tgt.ndim == 5 and key.startswith(('roi_head.conv_part.',
                                                               'roi_head.conv_rpn.'))):
        try:
            return spconv_kernel(src, tgt.shape[-2], tgt.shape[-1]).reshape(tgt.shape)
        except ValueError:
            return None
    if key == SHARED_FC and layout and src.numel() == tgt.numel():
        src = grid_major(src, *layout)
    if src.shape == tgt.shape:
        return src
    if src.numel() == tgt.numel() and _squeeze_trailing(src.shape) == _squeeze_trailing(tgt.shape):
        return src.reshape(tgt.shape)
    return None


def map_openpcdet_state(sd, model):
    """An OpenPCDet ``model_state`` (name → tensor) onto ``model``'s state
    dict.  Returns (state dict, report): every target of ``model`` is in the
    state dict (those without a usable source at their current value), on
    the CPU.  ``report``: ``mapped`` (targets written), ``mismatched``
    ((name, source shape, target shape) skipped), ``unmatched_target``
    (targets kept) and ``unused_source`` (source names the model lacks)."""
    check_family(model.model_cfg)
    if (model.model_cfg.get('DENSE_HEAD', None) or {}).get('NAME') == 'CenterHead':
        sd = fold_center_branches(sd)
    layout, skips = shared_fc_layout(model), fp_skips(model)
    target = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = dict(target)
    report = {'mapped': [], 'mismatched': [], 'unmatched_target': [], 'unused_source': []}
    for key, tgt in target.items():
        src = sd.get(key)
        if not isinstance(src, torch.Tensor):
            report['unmatched_target'].append(key)
            continue
        src = src.detach().cpu()
        value = _convert(key, src, tgt, layout, skips)
        if value is None:
            report['mismatched'].append((key, tuple(src.shape), tuple(tgt.shape)))
            report['unmatched_target'].append(key)
            continue
        out[key] = value.to(tgt.dtype).contiguous()
        report['mapped'].append(key)
    report['unused_source'] = sorted(k for k in sd if k not in target)
    return out, report


def load_openpcdet_file(path):
    """(model_state, meta) of a ``.pth``: its ``model_state`` or, for a bare
    state dict, the whole file; ``meta`` its ``epoch``, ``it`` and
    ``version`` where it has them."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if 'model_state' not in ckpt:
        return ckpt, {}
    return ckpt['model_state'], {k: ckpt[k] for k in ('epoch', 'it', 'version') if k in ckpt}


def import_openpcdet_checkpoint(path, model):
    """Read an OpenPCDet ``.pth`` and load its weights into ``model`` (in
    place, on the model's device).  Returns (report, meta)."""
    sd, meta = load_openpcdet_file(path)
    state, report = map_openpcdet_state(sd, model)
    model.load_state_dict(state)
    return report, meta

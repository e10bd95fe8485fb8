"""Config-driven detector (torch): the PointPillar, SECONDNet, SECONDNetIoU,
CenterPoint, VoxelRCNN, PVRCNN, PVRCNNPlusPlus, PartA2Net and PointRCNN (over
PointNet2MSG or UNetV2) topologies of ``crb_active_3ddet_tpu/models/detectors/detector3d.py``
(reference ``detector3d_template.py:24-53``, ``pointpillar.py:9-34``,
``second_net.py:9-34``, ``second_net_iou.py``, ``centerpoint.py``,
``voxel_rcnn.py``, ``pv_rcnn.py:9-43``, ``PartA2_net.py``,
``point_rcnn.py``): [vfe] → [backbone_3d] → [map_to_bev] → [pfe] → [backbone_2d] → [dense_head] →
[point_head] → [roi_head]; each bracketed module is built when the config
names it, as the JAX detector builds them (PointPillars has no 3D
backbone: its BEV width is ``MAP_TO_BEV.NUM_BEV_FEATURES``; SECONDNetIoU's
RoI head reads the BEV map, VoxelRCNN's the sparse backbone's stages,
PV-RCNN's the keypoints, PartA2's UNetV2's voxel features and the part
head's offsets; a CenterHead's decoded peaks are PV-RCNN's and VoxelRCNN's
proposals as an anchor head's boxes are; PointRCNN has no BEV branch: its
point head's boxes are the proposals, over UNetV2's voxels (PartA2_free) or
PointNet2MSG's points, and over PointNet2MSG it has no VFE: the backbone
reads the raw points, ``num_point_features`` wide).  PVRCNNPlusPlus runs
[vfe] → backbone_3d → map_to_bev → backbone_2d → dense_head → roi_proposal
→ pfe → point_head → roi_head (JAX ``detector3d.py:111-118``): its proposals
come first (``EarlyRoIProposal``), SPC samples the keypoints around them.
``compute_loss`` is the training loss (``detector3d.py:154-218``): the
dense head's (anchor or CenterHead) when there is one, plus the point
head's (PartA2's part head: the foreground, part and box terms; PointHeadBox:
the class and box terms) and the RoI
head's when the forward made their targets.
The modules that draw random numbers in training (the RoI heads and
PVRCNNPlusPlus's early proposal step: the RoI sample and the Dropout) take the ``torch.Generator`` that ``forward`` is
given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...utils import common
from ...utils.common import resolve_device
from ..backbones_2d.base_bev_backbone import build_backbone_2d
from ..backbones_2d.map_to_bev import build_map_to_bev
from ..backbones_3d.pfe import build_pfe
from ..backbones_3d.spconv_backbone import DenseConv3d, SparseConv3d, build_backbone_3d
from ..backbones_3d.vector_pool import VectorPoolAggregation, kaiming_normal_
from ..backbones_3d.vfe import build_vfe
from ..dense_heads import anchor_head_single as ahs
from ..dense_heads.anchor_head_single import build_dense_head
from ..dense_heads.center_head import CenterHead, get_center_loss
from ..point_heads import point_head_simple as phs
from ..point_heads.point_head_box import (PointHeadBox, PointIntraPartOffsetHead,
                                          get_point_box_loss, get_point_part_loss)
from ..point_heads.point_head_simple import build_point_head
from ..roi_heads import roi_head_template as rht
from ..roi_heads.pvrcnn_head import build_roi_head
from ..roi_heads.second_head import get_box_iou_layer_loss

_PORTED = {'PointPillar', 'SECONDNet', 'SECONDNetIoU', 'CenterPoint', 'VoxelRCNN', 'PVRCNN',
           'PartA2Net', 'PointRCNN', 'PVRCNNPlusPlus'}
_DRAWS = ('roi_proposal', 'roi_head')          # modules whose training forward draws
# the modules whose outputs the dense head reads
_DENSE_PATH = ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d', 'dense_head')


class EarlyRoIProposal(nn.Module):
    """PVRCNNPlusPlus's proposal step ahead of the pfe (JAX
    ``detector3d.py:132-152``), so that SPC samples its keypoints around
    the RoIs: the RoI head's proposal layer (NMS_CONFIG.TRAIN or TEST)
    and, in training, its proposal targets drawn from ``generator``, kept
    as ``roi_targets_dict`` for the head.  Given ``rois`` (and in training
    their ``roi_targets_dict``), it keeps them, as the heads do."""

    def __init__(self, roi_cfg):
        super().__init__()
        self.model_cfg = roi_cfg

    def forward(self, batch_dict, generator=None):
        batch_dict, targets = rht.rois_and_targets(batch_dict, self.model_cfg, self.training,
                                                   generator)
        if targets is not None:
            batch_dict['roi_targets_dict'] = targets
        return batch_dict


class Detector3D(nn.Module):
    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = tuple(class_names)
        topology, point_feats = [], num_point_features
        if model_cfg.get('VFE', None) is not None:
            self.vfe = build_vfe(model_cfg['VFE'], num_point_features, voxel_size,
                                 point_cloud_range)
            topology.append('vfe')
            point_feats = self.vfe.get_output_feature_dim()
        if model_cfg.get('BACKBONE_3D', None) is not None:
            self.backbone_3d = build_backbone_3d(
                model_cfg['BACKBONE_3D'], point_feats, grid_size, voxel_size,
                point_cloud_range)
            topology.append('backbone_3d')
        if model_cfg.get('MAP_TO_BEV', None) is not None:
            self.map_to_bev = build_map_to_bev(model_cfg['MAP_TO_BEV'], grid_size)
            topology.append('map_to_bev')
        if model_cfg.get('BACKBONE_2D', None) is not None:
            self.backbone_2d = build_backbone_2d(
                model_cfg['BACKBONE_2D'], self.map_to_bev.num_bev_features)
            topology.append('backbone_2d')
        if model_cfg.get('DENSE_HEAD', None) is not None:
            self.dense_head = build_dense_head(
                model_cfg['DENSE_HEAD'], self.backbone_2d.num_bev_features,
                num_class, class_names, grid_size, point_cloud_range,
                predict_boxes_when_training=model_cfg.get('ROI_HEAD', None) is not None,
                voxel_size=voxel_size)
            topology.append('dense_head')
        if model_cfg.get('PFE', None) is not None:
            self.pfe = build_pfe(
                model_cfg['PFE'], voxel_size, point_cloud_range,
                self.map_to_bev.num_bev_features, num_point_features,
                self.backbone_3d.backbone_channels)
            # the pfe reads the BEV map before the 2D backbone consumes it
            topology.insert(topology.index('backbone_2d'), 'pfe')
        # the per-point features: the pfe's keypoints, or a backbone's with a
        # decoder (UNetV2 at its input voxels, PointNet2MSG at the points)
        point_source = getattr(self, 'pfe', None)
        if point_source is None and getattr(getattr(self, 'backbone_3d', None), 'decoder', False):
            point_source = self.backbone_3d
        if model_cfg.get('POINT_HEAD', None) is not None:
            self.point_head = build_point_head(model_cfg['POINT_HEAD'], num_class,
                                               point_source)
            topology.append('point_head')
        if model_cfg.get('ROI_HEAD', None) is not None:
            self.roi_head = build_roi_head(
                model_cfg['ROI_HEAD'], num_class,
                point_source.num_point_features if point_source is not None
                else self.backbone_2d.num_bev_features, voxel_size, point_cloud_range,
                getattr(getattr(self, 'backbone_3d', None), 'backbone_channels', None))
            topology.append('roi_head')
        if model_cfg['NAME'] == 'PVRCNNPlusPlus':
            # the proposals come before the keypoint sampling, which centres
            # on them; the pfe reads the BEV map after the 2D backbone
            self.roi_proposal = EarlyRoIProposal(model_cfg['ROI_HEAD'])
            topology = [n for n in ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d',
                                    'dense_head', 'roi_proposal', 'pfe', 'point_head',
                                    'roi_head') if n == 'roi_proposal' or n in topology]
        self.module_topology = tuple(topology)

    @property
    def device(self):
        return next(self.parameters()).device

    def forward(self, batch_dict, generator=None, dense_only=False):
        """``generator`` (a ``torch.Generator`` on the model's device) feeds
        the modules that draw in training; such a module raises without
        one, and PV-RCNN's RoI head in eval turns its Dropout live with it.
        ``dense_only``: run only the modules the dense head's outputs read
        (no point branch, no RoI head), as XLA prunes the JAX model to them
        where only those outputs are used.  The f32 layers compute in f32
        (``full_f32``)."""
        batch_dict = dict(batch_dict)       # never mutate the caller's dict
        names = [n for n in self.module_topology if not dense_only or n in _DENSE_PATH]
        with common.full_f32():
            for name in names:
                module = getattr(self, name)
                batch_dict = module(batch_dict, generator) if name in _DRAWS \
                    else module(batch_dict)
        return batch_dict

    def compute_loss(self, batch_dict, reduce: bool = True):
        """Training loss over the forward's output (training mode), as the
        JAX ``compute_loss``: the anchor head's rpn loss or CenterHead's
        loss, plus point_loss when the point head assigned its targets and
        the rcnn loss when the RoI head did.  Returns (loss, {term: value});
        ``reduce=False`` keeps one loss a frame."""
        loss, tb = 0.0, {}
        if isinstance(getattr(self, 'dense_head', None), CenterHead):
            loss, tb = get_center_loss(batch_dict,
                                       self.model_cfg['DENSE_HEAD']['LOSS_CONFIG'],
                                       reduce=reduce)
        elif hasattr(self, 'dense_head'):
            loss, tb = ahs.get_loss(batch_dict, self.dense_head, reduce=reduce)
        if 'point_cls_labels' in batch_dict:
            lw = self.model_cfg['POINT_HEAD']['LOSS_CONFIG']['LOSS_WEIGHTS']
            if isinstance(self.point_head, PointIntraPartOffsetHead):
                point_loss = get_point_part_loss(batch_dict, lw, reduce=reduce)
            elif isinstance(self.point_head, PointHeadBox):
                point_loss = get_point_box_loss(batch_dict, lw, reduce=reduce)
            else:
                point_loss = phs.get_point_loss(batch_dict, lw, reduce=reduce)
            loss = loss + point_loss
            tb['point_loss'] = point_loss
        if 'roi_iou_targets' in batch_dict:
            iou_loss = get_box_iou_layer_loss(batch_dict['roi_iou_targets'],
                                              self.model_cfg['ROI_HEAD']['LOSS_CONFIG'])
            loss = loss + iou_loss
            tb['rcnn_loss_iou'] = iou_loss
        if 'roi_targets' in batch_dict:
            rcnn_loss, rcnn_tb = rht.get_rcnn_loss(
                batch_dict['roi_targets'], self.model_cfg['ROI_HEAD']['LOSS_CONFIG'],
                reduce=reduce)
            loss = loss + rcnn_loss
            tb.update(rcnn_tb)
            tb['rcnn_loss'] = rcnn_loss
        return loss, {**tb, 'loss': loss}


def init_weights(model, generator: torch.Generator, box_std=None):
    """Seeded random weights: normal(0, 1/√fan_in) for every weight, small
    normal biases and BN affine terms, positive running variances.  The
    dense head keeps its cls bias prior (the anchor heads' focal prior,
    CenterHead's −2.19).  Fan-in: a sparse conv weight is (K, Cin, Cout);
    a dense 3D conv weight (kx, ky, kz, Cin, Cout); a vector pool's local
    kernel (G, Cin, Cout) one Cin a sub-voxel; every other weight
    (Conv2d, Conv1d, ConvTranspose2d as laid out, Linear) has its outputs
    first.

    ``box_std`` given, the dense head's box layer weights (CenterHead's
    regression output convs) are then drawn again, normal(0, box_std), as
    the JAX package and OpenPCDet draw ``conv_box`` (std 0.001).  A
    two-stage model trains from it: at 1/√fan_in its decoded proposals
    reach 1e26 m and overflow the RoI head's
    decode and corner loss.  The default keeps the weights from which the
    SECOND and eval readings of ``chip_smoke.py`` were recorded."""
    head = getattr(model, 'dense_head', None)
    cls_biases = set() if head is None else {id(conv.bias) for conv in head.cls_convs()}
    box_weights = [] if head is None else [conv.weight for conv in head.box_convs()]
    sparse = {id(m.weight) for m in model.modules()
              if isinstance(m, (SparseConv3d, DenseConv3d))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if id(p) in cls_biases:
                continue
            r = torch.randn(p.shape, generator=generator)
            if name.endswith('local_kernel'):         # (G, Cin, Cout): Cin a sub-voxel
                r = r / math.sqrt(p.shape[1])
            elif name.endswith('weight') and p.ndim > 1:
                fan_in = p[..., 0].numel() if id(p) in sparse else p[0].numel()
                r = r / math.sqrt(fan_in)
            elif name.endswith('weight'):
                r = 1.0 + 0.1 * r
            else:
                r = 0.05 * r
            p.copy_(r)
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=generator))
            elif name.endswith('running_var'):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=generator))
        if box_std is not None:       # drawn last: the other weights stay as without it
            for w in box_weights:
                w.copy_(box_std * torch.randn(w.shape, generator=generator))
    return model




def flax_init(model, generator: torch.Generator):
    """The JAX model's own initialisation, as its ``init_train_state`` draws
    it (Flax defaults plus the modules' own initializers), from a seeded
    ``generator``: every Conv, ConvTranspose and Dense kernel lecun-normal
    (a normal truncated at ±2 of its scale, std 1/√fan_in); each sparse conv
    kernel variance_scaling(1, fan_out, normal), a plain normal of std
    1/√(K·Cout); zero biases; BatchNorm scale 1, bias 0, mean 0, var 1; the
    dense head's cls biases at its ``cls_bias_init`` (the anchor heads'
    focal prior, CenterHead's −2.19) and AnchorHeadSingle's box
    kernel normal(0, 0.001), as PV-RCNN's RoI head's two output kernels
    (AnchorHeadMulti's box kernels, SECONDHead's ``iou_out`` and
    VoxelRCNNHead's ``cls_pred_layer`` and ``reg_pred_layer`` and
    PartA2FCHead's output layers are lecun-normal; the PartA2 head's dense
    3D conv kernels variance_scaling(1, fan_out, normal) as the sparse
    ones; llal's LossNet: its convs and linear map lecun-normal,
    biases 0; a vector pool's (G, 3 + C, 32) local kernel kaiming-normal,
    its fan-in G·(3 + C) as Flax counts it).  Fan-in as Flax counts it:
    a ConvTranspose2d weight (in, out, kh, kw) has in·kh·kw, every other
    weight (out, ...) the product of its trailing dims.  The draws differ
    from JAX's (another generator); their distribution is the same."""
    head = getattr(model, 'dense_head', None)
    small = {id(head.conv_box.weight)} if isinstance(head, ahs.AnchorHeadSingle) else set()
    small |= {id(w) for w in getattr(getattr(model, 'roi_head', None), 'small_init_weights', ())}
    done = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                done |= {id(m.weight), id(m.bias)}
                continue
            w = getattr(m, 'weight', None)
            if not isinstance(w, nn.Parameter) or id(w) in done:
                continue
            if id(w) in small:
                w.normal_(0.0, 0.001, generator=generator)
            elif isinstance(m, (SparseConv3d, DenseConv3d)):     # fan_out: K·Cout
                w.normal_(0.0, 1.0 / math.sqrt(w[..., 0, :].numel()), generator=generator)
            else:
                fan_in = w[0].numel() if not isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[0] * w[0, 0].numel()
                scale = 1.0 / math.sqrt(fan_in) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, scale, -2 * scale, 2 * scale,
                                      generator=generator)
            done.add(id(w))
            if getattr(m, 'bias', None) is not None:
                m.bias.zero_()
                done.add(id(m.bias))
        for conv in head.cls_convs() if head is not None else ():
            conv.bias.fill_(head.cls_bias_init)
        for m in model.modules():
            if isinstance(m, VectorPoolAggregation):
                kaiming_normal_(m.local_kernel, generator)
                done.add(id(m.local_kernel))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise NotImplementedError(f'flax_init has no initializer for {missed}')
    return model


def build_detector(model_cfg, num_class, dataset, device='cuda'):
    """dataset provides grid_size, voxel_size, point_cloud_range,
    num_point_features and class_names; a points-only dataset (no voxel
    processor: PointRCNN over PointNet2MSG) has no grid and no voxel size.
    The model lives on ``device``: CUDA unless the caller asks for the
    CPU."""
    name = model_cfg['NAME']
    if name not in _PORTED:
        raise KeyError(f'detector {name} is not ported yet')
    _, grid_size, pcr, voxel_size = common.geometry(dataset)
    model = Detector3D(model_cfg, num_class, dataset.class_names, grid_size, pcr, voxel_size,
                       int(dataset.num_point_features))
    return model.to(resolve_device(device))

"""Config-driven detector (torch): the SECONDNet and PVRCNN topologies of
``crb_active_3ddet_tpu/models/detectors/detector3d.py`` (reference
``detector3d_template.py:24-53``, ``second_net.py:9-34``, ``pv_rcnn.py:9-43``):
vfe → backbone_3d → map_to_bev → [pfe] → backbone_2d → dense_head →
[point_head → roi_head]; the bracketed modules are built when the config
names them.  ``compute_loss`` is the training loss (``detector3d.py:
154-218``): the anchor head's, plus the point head's and the RoI head's
when the forward made their targets.  The modules that draw random numbers
in training (PV-RCNN's RoI head: the RoI sample and its Dropout) take the
``torch.Generator`` that ``forward`` is given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...utils.common import resolve_device
from ..backbones_2d.base_bev_backbone import build_backbone_2d
from ..backbones_2d.map_to_bev import build_map_to_bev
from ..backbones_3d.pfe import build_pfe
from ..backbones_3d.spconv_backbone import SparseConv3d, build_backbone_3d
from ..backbones_3d.vfe import build_vfe
from ..dense_heads import anchor_head_single as ahs
from ..dense_heads.anchor_head_single import build_dense_head
from ..point_heads import point_head_simple as phs
from ..point_heads.point_head_simple import build_point_head
from ..roi_heads import roi_head_template as rht
from ..roi_heads.pvrcnn_head import build_roi_head

_PORTED = {'SECONDNet', 'PVRCNN'}
_DRAWS = ('roi_head',)          # modules whose training forward draws


class Detector3D(nn.Module):
    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = tuple(class_names)
        self.vfe = build_vfe(model_cfg['VFE'], num_point_features)
        self.backbone_3d = build_backbone_3d(
            model_cfg['BACKBONE_3D'], self.vfe.get_output_feature_dim(),
            grid_size)
        self.map_to_bev = build_map_to_bev(model_cfg['MAP_TO_BEV'])
        self.backbone_2d = build_backbone_2d(
            model_cfg['BACKBONE_2D'], self.map_to_bev.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg['DENSE_HEAD'], self.backbone_2d.num_bev_features,
            num_class, class_names, grid_size, point_cloud_range,
            predict_boxes_when_training=model_cfg.get('ROI_HEAD', None) is not None)
        topology = ['vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d',
                    'dense_head']
        if model_cfg.get('PFE', None) is not None:
            self.pfe = build_pfe(
                model_cfg['PFE'], voxel_size, point_cloud_range,
                self.map_to_bev.num_bev_features, num_point_features,
                self.backbone_3d.backbone_channels)
            # the pfe reads the BEV map before the 2D backbone consumes it
            topology.insert(topology.index('backbone_2d'), 'pfe')
        if model_cfg.get('POINT_HEAD', None) is not None:
            self.point_head = build_point_head(model_cfg['POINT_HEAD'],
                                               num_class, self.pfe)
            topology.append('point_head')
        if model_cfg.get('ROI_HEAD', None) is not None:
            self.roi_head = build_roi_head(model_cfg['ROI_HEAD'], num_class,
                                           self.pfe.num_point_features)
            topology.append('roi_head')
        self.module_topology = tuple(topology)

    @property
    def device(self):
        return self.dense_head.conv_cls.weight.device

    def forward(self, batch_dict, generator=None):
        """``generator`` (a ``torch.Generator`` on the model's device) feeds
        the modules that draw in training; such a module raises without
        one."""
        batch_dict = dict(batch_dict)       # never mutate the caller's dict
        for name in self.module_topology:
            module = getattr(self, name)
            batch_dict = module(batch_dict, generator) if name in _DRAWS \
                else module(batch_dict)
        return batch_dict

    def compute_loss(self, batch_dict, reduce: bool = True):
        """Training loss over the forward's output (training mode), as the
        JAX ``compute_loss``: the anchor head's rpn loss, plus point_loss
        when the point head assigned its targets and the rcnn loss when the
        RoI head did.  Returns (loss, {term: value}); ``reduce=False`` keeps
        one loss a frame."""
        loss, tb = ahs.get_loss(batch_dict, self.dense_head, reduce=reduce)
        if 'point_cls_labels' in batch_dict:
            lw = self.model_cfg['POINT_HEAD']['LOSS_CONFIG']['LOSS_WEIGHTS']
            point_loss = phs.get_point_loss(batch_dict, lw, reduce=reduce)
            loss = loss + point_loss
            tb['point_loss'] = point_loss
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
    anchor head keeps its focal-loss prior on the cls bias.  Fan-in: a sparse
    conv weight is (K, Cin, Cout); every other weight (Conv2d, Conv1d,
    ConvTranspose2d as laid out, Linear) has its outputs first.

    ``box_std`` given, the anchor head's box layer weight is then drawn
    again, normal(0, box_std), as the JAX package and OpenPCDet draw
    ``conv_box`` (std 0.001).  A two-stage model trains from it: at
    1/√fan_in its decoded proposals reach 1e26 m and overflow the RoI head's
    decode and corner loss.  The default keeps the weights from which the
    SECOND and eval readings of ``chip_smoke.py`` were recorded."""
    cls_bias = model.dense_head.conv_cls.bias
    box_weight = model.dense_head.conv_box.weight
    sparse = {id(m.weight) for m in model.modules() if isinstance(m, SparseConv3d)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p is cls_bias:
                continue
            r = torch.randn(p.shape, generator=generator)
            if name.endswith('weight') and p.ndim > 1:
                fan_in = p.shape[0] * p.shape[1] if id(p) in sparse \
                    else p[0].numel()
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
            box_weight.copy_(box_std * torch.randn(box_weight.shape, generator=generator))
    return model


def build_detector(model_cfg, num_class, dataset, device='cuda'):
    """dataset provides grid_size, point_cloud_range, num_point_features and
    class_names.  The model lives on ``device``: CUDA unless the caller asks
    for the CPU."""
    name = model_cfg['NAME']
    if name not in _PORTED:
        raise KeyError(f'detector {name} is not ported yet')
    model = Detector3D(model_cfg, num_class, dataset.class_names,
                       tuple(int(g) for g in dataset.grid_size),
                       tuple(float(x) for x in dataset.point_cloud_range),
                       tuple(float(v) for v in dataset.voxel_size),
                       int(dataset.num_point_features))
    return model.to(resolve_device(device))

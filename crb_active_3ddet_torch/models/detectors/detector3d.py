"""Config-driven detector (torch): the PointPillar, SECONDNet and PVRCNN
topologies of ``crb_active_3ddet_tpu/models/detectors/detector3d.py``
(reference ``detector3d_template.py:24-53``, ``pointpillar.py:9-34``,
``second_net.py:9-34``, ``pv_rcnn.py:9-43``): vfe → [backbone_3d] →
map_to_bev → [pfe] → backbone_2d → dense_head → [point_head → roi_head];
the bracketed modules are built when the config names them (PointPillars
has no 3D backbone: its BEV width is ``MAP_TO_BEV.NUM_BEV_FEATURES``).
``compute_loss`` is the training loss (``detector3d.py:154-218``): the
anchor head's, plus the point head's and the RoI head's
when the forward made their targets.  The modules that draw random numbers
in training (PV-RCNN's RoI head: the RoI sample and its Dropout) take the
``torch.Generator`` that ``forward`` is given.
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
from ..backbones_3d.spconv_backbone import SparseConv3d, build_backbone_3d
from ..backbones_3d.vfe import build_vfe
from ..dense_heads import anchor_head_single as ahs
from ..dense_heads.anchor_head_single import build_dense_head
from ..point_heads import point_head_simple as phs
from ..point_heads.point_head_simple import build_point_head
from ..roi_heads import roi_head_template as rht
from ..roi_heads.pvrcnn_head import build_roi_head

_PORTED = {'PointPillar', 'SECONDNet', 'PVRCNN'}
_DRAWS = ('roi_head',)          # modules whose training forward draws
# the modules whose outputs the dense head reads
_DENSE_PATH = ('vfe', 'backbone_3d', 'map_to_bev', 'backbone_2d', 'dense_head')


class Detector3D(nn.Module):
    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = tuple(class_names)
        self.vfe = build_vfe(model_cfg['VFE'], num_point_features, voxel_size,
                             point_cloud_range)
        topology = ['vfe']
        if model_cfg.get('BACKBONE_3D', None) is not None:
            self.backbone_3d = build_backbone_3d(
                model_cfg['BACKBONE_3D'], self.vfe.get_output_feature_dim(),
                grid_size)
            topology.append('backbone_3d')
        self.map_to_bev = build_map_to_bev(model_cfg['MAP_TO_BEV'], grid_size)
        self.backbone_2d = build_backbone_2d(
            model_cfg['BACKBONE_2D'], self.map_to_bev.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg['DENSE_HEAD'], self.backbone_2d.num_bev_features,
            num_class, class_names, grid_size, point_cloud_range,
            predict_boxes_when_training=model_cfg.get('ROI_HEAD', None) is not None)
        topology += ['map_to_bev', 'backbone_2d', 'dense_head']
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


FOCAL_PRIOR = 0.01       # the anchor head's cls bias is -log((1 - p) / p)


def flax_init(model, generator: torch.Generator):
    """The JAX model's own initialisation, as its ``init_train_state`` draws
    it (Flax defaults plus the modules' own initializers), from a seeded
    ``generator``: every Conv, ConvTranspose and Dense kernel lecun-normal
    (a normal truncated at ±2 of its scale, std 1/√fan_in); each sparse conv
    kernel variance_scaling(1, fan_out, normal), a plain normal of std
    1/√(K·Cout); zero biases; BatchNorm scale 1, bias 0, mean 0, var 1; the
    anchor head's cls bias at the focal prior and its box kernel normal(0,
    0.001), as the RoI head's two output kernels (llal's LossNet: its convs
    and linear map lecun-normal, biases 0).  Fan-in as Flax counts it:
    a ConvTranspose2d weight (in, out, kh, kw) has in·kh·kw, every other
    weight (out, ...) the product of its trailing dims.  The draws differ
    from JAX's (another generator); their distribution is the same."""
    small = {id(model.dense_head.conv_box.weight)}
    if hasattr(model, 'roi_head'):
        small |= {id(model.roi_head.cls_layers[-1].weight),
                  id(model.roi_head.reg_layers[-1].weight)}
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
            elif isinstance(m, SparseConv3d):
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[0] * w.shape[2]),
                          generator=generator)
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
        model.dense_head.conv_cls.bias.fill_(-math.log((1 - FOCAL_PRIOR) / FOCAL_PRIOR))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise NotImplementedError(f'flax_init has no initializer for {missed}')
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

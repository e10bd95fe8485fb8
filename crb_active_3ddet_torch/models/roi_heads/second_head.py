"""SECOND IoU head (torch): port of ``SECONDHead`` and
``get_box_iou_layer_loss`` from
``crb_active_3ddet_tpu/models/roi_heads/second_head.py`` (reference
``pcdet/models/roi_heads/second_head.py``): the proposal layer, in training
the proposal targets (``CLS_SCORE_TYPE: roi_iou`` gives the soft IoU labels),
a rotated G×G grid of bilinear taps over each RoI's footprint on the BEV
map, the shared FC tower with its Dropout, the IoU tower and one IoU logit
a RoI.  Both the RoIs and the BEV map are detached, so the IoU loss trains
the head alone.  Eval exports the IoU logit as ``batch_cls_preds`` with the
RoIs as ``batch_box_preds`` (the score fusions of ``post_processing`` read
them with ``roi_scores``).

Module names are OpenPCDet's: ``shared_fc_layer`` and ``iou_layers``, Conv1d
(k=1, no bias) + BatchNorm1d (eps 1e-3, Flax's training statistics) + ReLU
stacks, with Dropout entries between the shared layers when DP_RATIO > 0.
OpenPCDet's ``make_fc_layers`` puts a Dropout after the IoU tower's first
block, which the JAX head lacks: the port keeps the entry, at p = 0, so
that the indices match OpenPCDet's and the tower computes the JAX one.  The
pooled taps are flattened grid-major, (B·R, G·G·C) with the local x index
outer, as the JAX head flattens them; OpenPCDet's ``grid_sample`` gives
(B·R, C, G_y, G_x) channel-major (``utils/openpcdet_ckpt.py`` permutes the
first shared FC's input axis).

The training forward draws the RoI sample and the Dropout masks from the
``torch.Generator`` it is given; an eval forward given one turns the shared
tower's Dropout live (the BatchNorms stay in eval mode).
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils import loss_utils
from ..backbones_3d.pfe import bilinear_interpolate, pointwise_stack, run_pointwise
from . import roi_head_template as rht


class SECONDHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        pool = model_cfg['ROI_GRID_POOL']
        self.grid_size = int(pool['GRID_SIZE'])
        self.downsample = float(pool['DOWNSAMPLE_RATIO'])
        dp = float(model_cfg.get('DP_RATIO', 0.3))
        shared = list(model_cfg['SHARED_FC'])
        iou_fc = list(model_cfg['IOU_FC'])
        self.shared_fc_layer = pointwise_stack(
            [self.grid_size ** 2 * input_channels, *shared], nn.Conv1d, nn.BatchNorm1d,
            dp_ratio=dp, dropout_after=range(len(shared) - 1) if dp > 0 else ())
        self.iou_layers = pointwise_stack(
            [shared[-1], *iou_fc], nn.Conv1d, nn.BatchNorm1d, dp_ratio=0.0,
            dropout_after=(0,), out_channels=1)

    def _dropouts(self):
        return [m for m in self.shared_fc_layer if isinstance(m, nn.Dropout)]

    def roi_grid_pool(self, batch_dict):
        """The BEV map's bilinear taps at a rotated G×G grid over each RoI
        → (B·R, G·G·C), grid-major."""
        rois = batch_dict['rois'].detach()                          # (B, R, 7)
        bev = batch_dict['spatial_features_2d'].detach()            # (B, H, W, C)
        b, r = rois.shape[:2]
        g = self.grid_size
        lin = (torch.arange(g, dtype=rois.dtype, device=rois.device) + 0.5) / g - 0.5
        gx, gy = torch.meshgrid(lin, lin, indexing='ij')            # (G, G)
        ux = gx * rois[..., 3, None, None]                          # local x
        uy = gy * rois[..., 4, None, None]
        cosa = torch.cos(rois[..., 6])[..., None, None]
        sina = torch.sin(rois[..., 6])[..., None, None]
        wx = ux * cosa - uy * sina + rois[..., 0, None, None]
        wy = ux * sina + uy * cosa + rois[..., 1, None, None]
        px = (wx - self.point_cloud_range[0]) / (self.voxel_size[0] * self.downsample)
        py = (wy - self.point_cloud_range[1]) / (self.voxel_size[1] * self.downsample)
        pooled = bilinear_interpolate(bev, px.reshape(b, -1), py.reshape(b, -1))
        return pooled.reshape(b * r, -1)

    def forward(self, batch_dict, generator=None):
        """Eval: proposals (NMS_CONFIG.TEST) unless ``rois`` are given, then
        the IoU logits.  Training: proposals (NMS_CONFIG.TRAIN), the targets
        sampled with ``generator``, or, given ``rois`` and their
        ``roi_targets_dict``, those; ``roi_iou_targets`` then carries the
        targets with ``rcnn_iou``."""
        cfg = self.model_cfg
        if 'rois' not in batch_dict:
            batch_dict = rht.proposal_layer(
                batch_dict, cfg['NMS_CONFIG']['TRAIN' if self.training else 'TEST'])
            if self.training:
                targets = rht.assign_targets(batch_dict, cfg['TARGET_CONFIG'], generator)
                batch_dict['rois'] = targets['rois']
                batch_dict['roi_labels'] = targets['roi_labels']
                batch_dict['roi_scores'] = targets['roi_scores']
                batch_dict['roi_valid'] = torch.ones(targets['rois'].shape[:2],
                                                     dtype=torch.bool,
                                                     device=targets['rois'].device)
        elif self.training:
            targets = batch_dict['roi_targets_dict']
        rois = batch_dict['rois'].detach()
        b, r = rois.shape[:2]
        pooled = self.roi_grid_pool(batch_dict)
        dropouts = self._dropouts() if not self.training and generator is not None else []
        for m in dropouts:                  # only the Dropout entries go live
            m.train()
        try:
            shared = run_pointwise(self.shared_fc_layer, pooled, generator=generator)
        finally:
            for m in dropouts:
                m.eval()
        rcnn_iou = run_pointwise(self.iou_layers, shared)           # (B·R, 1)
        batch_dict['rcnn_cls'] = rcnn_iou
        if self.training:
            batch_dict['roi_iou_targets'] = {**targets, 'rcnn_iou': rcnn_iou}
        else:
            batch_dict['batch_cls_preds'] = rcnn_iou.reshape(b, r, 1)
            batch_dict['batch_box_preds'] = rois
            batch_dict['cls_preds_normalized'] = False
            batch_dict['rcnn_reg'] = rcnn_iou.new_zeros(b * r, 7)
        batch_dict['shared_features'] = shared.reshape(b, r, -1)
        return batch_dict


def get_box_iou_layer_loss(targets, loss_cfg):
    """The IoU logits against ``rcnn_cls_labels`` (BinaryCrossEntropy, L2 or
    smoothL1 by ``IOU_LOSS``), labels < 0 ignored, over the batch's valid
    count, times ``rcnn_iou_weight``: one scalar, as in the JAX package
    (which has no per-frame form)."""
    iou_pred = targets['rcnn_iou'].reshape(-1)
    labels = targets['rcnn_cls_labels'].reshape(-1)
    kind = loss_cfg.get('IOU_LOSS', 'BinaryCrossEntropy')
    if kind == 'BinaryCrossEntropy':
        per = loss_utils.binary_cross_entropy_with_logits(iou_pred, torch.clamp(labels, min=0.0))
    elif kind == 'L2':
        per = (iou_pred - labels) ** 2
    elif kind == 'smoothL1':
        per = loss_utils.smooth_l1_loss(iou_pred - labels)
    else:
        raise NotImplementedError(kind)
    valid = (labels >= 0).to(torch.float32)
    loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return loss * float(loss_cfg['LOSS_WEIGHTS']['rcnn_iou_weight'])

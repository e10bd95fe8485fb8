"""PointRCNN's RoI head (torch): port of ``PointRCNNHead`` from
``crb_active_3ddet_tpu/models/roi_heads/pointrcnn_head.py:25-157`` (reference
``pcdet/models/roi_heads/pointrcnn_head.py``).

Order of work: the proposal layer over the point head's boxes (in training
the proposal targets, or the given ``rois`` with their
``roi_targets_dict``); RoI point pooling (``ops/roi_pooling.roipoint_pool3d``)
of the first ``NUM_SAMPLED_POINTS`` member points of each RoI with [the
point head's score (detached), the depth ‖xyz‖ / DEPTH_NORMALIZER − 0.5,
the backbone features]; the canonical transform (the offset from the RoI's
centre turned by −yaw, an empty RoI all 0); ``xyz_up_layer`` over
[xyz, score, depth] and ``merge_down_layer`` over [that | the features]
(1×1 convs, with USE_BN False a bias and no BatchNorm); the set-abstraction
encoder over each RoI's points (FPS, the hand-written kernel, and ball query
at each level, then a group-all level: an MLP over [xyz | features] and a
max over the RoI's valid points, 0 for an empty RoI); the cls and reg
towers; in eval the decoded boxes.  ``shared_features`` (B, R, C) is the
group-all output.

Module names and layouts are OpenPCDet's: ``xyz_up_layer``,
``merge_down_layer`` (Conv2d stacks), ``SA_modules.{k}.mlps.0`` (Conv2d +
BatchNorm2d), ``cls_layers`` / ``reg_layers`` (``make_fc_layers``: Conv1d +
BatchNorm1d blocks, a Dropout entry after the first).  As in the JAX head
the Dropout entries are p = 0 whatever DP_RATIO says (the shipped files set
0.0), and the reg tower has 7 outputs.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.roi_pooling import roipoint_pool3d
from ...utils import common
from ..backbones_3d.pfe import StackSAModuleMSG, pointwise_stack, run_pointwise
from ..backbones_3d.pointnet2_backbone import sample_and_gather
from . import roi_head_template as rht

NUM_PREFIX = 5                  # xyz + score + depth


def conv_stack(channels, use_bn):
    """[1×1 Conv2d (a bias without BatchNorm), BatchNorm2d with ``use_bn``,
    ReLU] a layer: the layout of OpenPCDet's ``xyz_up_layer``."""
    layers = []
    for c_in, c_out in zip(channels[:-1], channels[1:]):
        layers.append(nn.Conv2d(c_in, c_out, 1, bias=not use_bn))
        if use_bn:
            layers.append(nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.01))
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class GroupAllSA(nn.Module):
    """OpenPCDet's ``PointnetSAModule`` without npoint: an MLP over every
    point's [xyz | features] (xyz not centred) and a max over the frame's
    valid points; a frame without one gives 0."""

    def __init__(self, mlp, in_channels):
        super().__init__()
        self.mlps = nn.ModuleList([pointwise_stack([in_channels + 3, *mlp], nn.Conv2d,
                                                   nn.BatchNorm2d)])
        self.num_out_channels = int(mlp[-1])

    def forward(self, xyz, valid, features):
        x = run_pointwise(self.mlps[0], torch.cat([xyz, features], dim=-1))
        x = x.masked_fill(~valid[..., None], -1e9).max(dim=1).values
        return x.masked_fill(x <= -1e8, 0.0)


class PointRCNNHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        use_bn = bool(model_cfg.get('USE_BN', False))
        up = [int(c) for c in model_cfg['XYZ_UP_LAYER']]
        self.xyz_up_layer = conv_stack([NUM_PREFIX, *up], use_bn)
        self.merge_down_layer = conv_stack([up[-1] + input_channels, up[-1]], use_bn)
        sa = model_cfg['SA_CONFIG']
        self.npoints = [int(n) for n in sa['NPOINTS']]
        if self.npoints[-1] != -1:
            raise ValueError('PointRCNNHead ends with a group-all level (NPOINTS -1)')
        c_in = up[-1]
        self.SA_modules = nn.ModuleList()
        for k, npoint in enumerate(self.npoints):
            self.SA_modules.append(
                GroupAllSA(sa['MLPS'][k], c_in) if npoint == -1
                else StackSAModuleMSG([sa['RADIUS'][k]], [sa['NSAMPLE'][k]], [sa['MLPS'][k]],
                                      c_in))
            c_in = self.SA_modules[-1].num_out_channels
        self.cls_layers = pointwise_stack([c_in, *model_cfg['CLS_FC']], nn.Conv1d,
                                          nn.BatchNorm1d, dropout_after=(0,),
                                          out_channels=num_class)
        self.reg_layers = pointwise_stack([c_in, *model_cfg['REG_FC']], nn.Conv1d,
                                          nn.BatchNorm1d, dropout_after=(0,),
                                          out_channels=rht._CODER.code_size)

    def roipoint_pool(self, batch_dict):
        """→ (B·R, S, 5 + C) pooled points in their RoI's frame, [xyz, score,
        depth, features], and the (B·R,) empty flags."""
        pool = self.model_cfg['ROI_POINT_POOL']
        rois = batch_dict['rois']                               # (B, R, 7)
        b, r = rois.shape[:2]
        coords = batch_dict['point_coords']                     # (B, N, 3)
        depth = torch.linalg.norm(coords, dim=-1) / float(pool['DEPTH_NORMALIZER']) - 0.5
        feats = torch.cat([batch_dict['point_cls_scores'].detach()[..., None],
                           depth[..., None], batch_dict['point_features']], dim=-1)
        s = int(pool['NUM_SAMPLED_POINTS'])
        pooled, empty = roipoint_pool3d(
            coords, feats, rois, batch_dict['point_valid'],
            torch.ones((b, r), dtype=torch.bool, device=rois.device), s,
            tuple(float(x) for x in pool['POOL_EXTRA_WIDTH']))
        local = common.rotate_points_along_z(
            (pooled[..., 0:3] - rois[:, :, None, 0:3]).reshape(b * r, s, 3),
            -rois.reshape(b * r, 7)[:, 6]).reshape(b, r, s, 3)
        pooled = torch.cat([local, pooled[..., 3:]], dim=-1).masked_fill(
            empty[..., None, None], 0.0)
        return pooled.reshape(b * r, s, -1), empty.reshape(b * r)

    def encode(self, pooled, empty):
        """The xyz-up and merge-down convs, then the set-abstraction levels →
        (B·R, C) shared features."""
        xyz_feats = run_pointwise(self.xyz_up_layer, pooled[..., :NUM_PREFIX])
        x = run_pointwise(self.merge_down_layer,
                          torch.cat([xyz_feats, pooled[..., NUM_PREFIX:]], dim=-1))
        xyz = pooled[..., 0:3].contiguous()
        valid = (~empty)[:, None].expand(xyz.shape[:2]).contiguous()
        for npoint, sa in zip(self.npoints[:-1], self.SA_modules[:-1]):
            new_xyz, new_valid = sample_and_gather(xyz, valid, npoint)
            x = sa(xyz, valid, new_xyz, new_valid, x)
            xyz, valid = new_xyz, new_valid
        return self.SA_modules[-1](xyz, valid, x)

    def forward(self, batch_dict, generator=None):
        """Eval: proposals (NMS_CONFIG.TEST) unless ``rois`` are given, the
        pooling, the encoder, the towers, the decoded boxes.  Training:
        proposals (NMS_CONFIG.TRAIN) and the targets sampled with
        ``generator``, or the given ``rois`` and ``roi_targets_dict``;
        ``roi_targets`` then carries the targets with rcnn_cls and
        rcnn_reg."""
        batch_dict, targets = rht.rois_and_targets(batch_dict, self.model_cfg, self.training,
                                                   generator)
        rois = batch_dict['rois']
        b, r = rois.shape[:2]
        shared = self.encode(*self.roipoint_pool(batch_dict))
        rcnn_cls = run_pointwise(self.cls_layers, shared)       # (B·R, num_class)
        rcnn_reg = run_pointwise(self.reg_layers, shared)       # (B·R, 7)
        batch_dict['rcnn_cls'] = rcnn_cls
        batch_dict['rcnn_reg'] = rcnn_reg
        batch_dict['shared_features'] = shared.reshape(b, r, -1)
        if self.training:
            batch_dict['roi_targets'] = {**targets, 'rcnn_cls': rcnn_cls, 'rcnn_reg': rcnn_reg}
            return batch_dict
        batch_cls, batch_box = rht.generate_predicted_boxes(rois, rcnn_cls, rcnn_reg)
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

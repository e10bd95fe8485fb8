"""PV-RCNN RoI head (torch): port of
``crb_active_3ddet_tpu/models/roi_heads/pvrcnn_head.py`` (reference
``pcdet/models/roi_heads/pvrcnn_head.py``): the proposal layer, in training
the proposal targets, RoI-grid pooling over the keypoint features, the
shared FC tower with its Dropout, the cls/reg heads and, in eval, the box
decode.

Module names and layouts are OpenPCDet's (``roi_grid_pool_layer``,
``shared_fc_layer``, ``cls_layers``, ``reg_layers``: Conv1d(k=1) + BatchNorm1d
stacks with Dropout entries), with one difference kept from the JAX package:
the shared FC reads the pooled grid flattened grid-major, (B·R, G³·C), where
OpenPCDet flattens channel-major.  The training forward draws the RoI
sample and the Dropout masks from the ``torch.Generator`` it is given.

An eval forward given a generator plays the JAX head's ``has_rng('dropout')``:
the tower's Dropout entries go live (drawing from the generator; the
BatchNorms stay in eval mode) and, with ``SAMPLING_ROUND`` > 1, the tower
runs that many times on the one pooled grid, so that ``rcnn_cls`` and
``rcnn_reg`` come out stacked, (S, B·R, ·).  The decoded predictions, the
shared features and the LossNet read the first round, as in the JAX head
(JAX ``pvrcnn_head.py:150-176``); without a generator the tower runs once,
deterministic.

PV-RCNN++'s ROI_GRID_POOL (NUM_GROUPS) is a vector pool over the keypoints
(``backbones_3d/vector_pool.py``; LOCAL_AGGREGATION_TYPE and
NEIGHBOR_NSAMPLE are not read, as in the JAX head), its output reshaped
grid-major as the ball-query pool's.  Its RoIs come from the detector's
early proposal step, with their ``roi_targets_dict`` in training.
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils import common
from ..backbones_3d.pfe import StackSAModuleMSG, pointwise_stack, run_pointwise
from ..backbones_3d.vector_pool import VectorPoolAggregationMSG
from . import roi_head_template as rht
from .loss_net import LossNet


def get_dense_grid_points(rois, grid_size: int):
    """(N, 7) rois → (N, G³, 3) local grid points."""
    g = grid_size
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing='ij'),
                      dim=-1).reshape(-1, 3).to(rois.dtype)
    local_size = rois[:, None, 3:6]
    return (idx[None] + 0.5) / g * local_size - local_size / 2


def get_global_grid_points_of_roi(rois, grid_size: int):
    """(N, 7) rois → (N, G³, 3) global grid points."""
    local = get_dense_grid_points(rois, grid_size)
    rotated = common.rotate_points_along_z(local, rois[:, 6])
    return rotated + rois[:, None, 0:3]


class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        pool = model_cfg['ROI_GRID_POOL']
        self.grid_size = int(pool['GRID_SIZE'])
        if 'NUM_GROUPS' in pool:                # PV-RCNN++: a vector pool
            self.roi_grid_pool_layer = VectorPoolAggregationMSG(pool, input_channels)
        else:
            self.roi_grid_pool_layer = StackSAModuleMSG(
                pool['POOL_RADIUS'], pool['NSAMPLE'], pool['MLPS'], input_channels)
        pooled = self.grid_size ** 3 * self.roi_grid_pool_layer.num_out_channels
        dp = float(model_cfg.get('DP_RATIO', 0.0))
        shared = list(model_cfg['SHARED_FC'])
        # OpenPCDet's Dropout positions: between the shared layers when
        # DP_RATIO > 0, after the first block of each head always
        self.shared_fc_layer = pointwise_stack(
            [pooled, *shared], nn.Conv1d, nn.BatchNorm1d, dp_ratio=dp,
            dropout_after=range(len(shared) - 1) if dp > 0 else ())
        self.cls_layers = pointwise_stack(
            [shared[-1], *model_cfg['CLS_FC']], nn.Conv1d, nn.BatchNorm1d,
            dropout_after=(0,), dp_ratio=dp, out_channels=num_class)
        self.reg_layers = pointwise_stack(
            [shared[-1], *model_cfg['REG_FC']], nn.Conv1d, nn.BatchNorm1d,
            dropout_after=(0,), dp_ratio=dp,
            out_channels=rht._CODER.code_size * num_class)
        for w in self.small_init_weights:
            nn.init.normal_(w, std=0.001)
        self.mc_rounds = int(model_cfg.get('SAMPLING_ROUND', 0) or 0)
        if model_cfg.get('LOSS_NET', None):
            self.loss_net = LossNet(
                shared, model_cfg['NMS_CONFIG']['TEST']['NMS_POST_MAXSIZE'])

    @property
    def small_init_weights(self):
        """The output kernels that JAX draws normal(0, 0.001)."""
        return (self.cls_layers[-1].weight, self.reg_layers[-1].weight)

    def _dropouts(self):
        return [m for stack in (self.shared_fc_layer, self.cls_layers, self.reg_layers)
                for m in stack if isinstance(m, nn.Dropout)]

    def roi_grid_pool(self, batch_dict):
        """Keypoint features, weighted by their foreground score, pooled at
        the G³ grid points of every RoI → (B·R, G³·C), grid-major."""
        rois = batch_dict['rois']                               # (B, R, 7)
        b, r = rois.shape[:2]
        g3 = self.grid_size ** 3
        point_features = batch_dict['point_features'] \
            * batch_dict['point_cls_scores'][..., None]
        grid_pts = get_global_grid_points_of_roi(
            rois.reshape(b * r, -1), self.grid_size).reshape(b, r * g3, 3)
        grid_valid = torch.ones(grid_pts.shape[:2], dtype=torch.bool,
                                device=rois.device)
        pooled = self.roi_grid_pool_layer(
            batch_dict['point_coords'], batch_dict['point_coords_valid'],
            grid_pts, grid_valid, point_features)               # (B, R·G³, C)
        return pooled.reshape(b * r, -1)

    def tower(self, pooled, generator=None):
        """(B·R, G³·C) → shared features, rcnn_cls, rcnn_reg and the shared
        layers' activations.  Dropout entries follow the modules' own mode
        (identity in eval) and draw from ``generator`` when live, so a pool
        scorer can call this again with only them in training mode."""
        latents = []
        shared = run_pointwise(self.shared_fc_layer, pooled, taps=latents,
                               generator=generator)
        return (shared, run_pointwise(self.cls_layers, shared, generator=generator),
                run_pointwise(self.reg_layers, shared, generator=generator), latents)

    def forward(self, batch_dict, generator=None):
        """Eval: proposals (NMS_CONFIG.TEST) unless ``rois`` are given, the
        tower, the decoded boxes; given a generator, live Dropout and the MC
        rounds (see the module's docstring).  Training: proposals
        (NMS_CONFIG.TRAIN), the targets sampled with ``generator`` and the
        tower on the sampled RoIs with live Dropout; or, given ``rois`` and
        their ``roi_targets_dict``, the tower on those.  ``roi_targets`` then
        carries the targets with rcnn_cls and rcnn_reg.  With a LossNet:
        ``loss_predictions`` (eval) or ``loss_predictions_train``, (B,)."""
        cfg = self.model_cfg
        batch_dict, targets = rht.rois_and_targets(batch_dict, cfg, self.training, generator)
        b, r = batch_dict['rois'].shape[:2]
        pooled = self.roi_grid_pool(batch_dict)
        live = not self.training and generator is not None
        dropouts = self._dropouts() if live else []
        for m in dropouts:                  # only the Dropout entries go live
            m.train()
        try:
            shared, rcnn_cls, rcnn_reg, latents = self.tower(pooled, generator)
            rounds = [(rcnn_cls, rcnn_reg)]
            if live and self.mc_rounds > 1:
                rounds += [self.tower(pooled, generator)[1:3]
                           for _ in range(self.mc_rounds - 1)]
        finally:
            for m in dropouts:
                m.eval()
        if hasattr(self, 'loss_net'):
            batch_dict['loss_predictions_train' if self.training
                       else 'loss_predictions'] = self.loss_net(latents, b)
        if self.training:
            batch_dict['rcnn_cls'] = rcnn_cls
            batch_dict['rcnn_reg'] = rcnn_reg
            batch_dict['roi_targets'] = {**targets, 'rcnn_cls': rcnn_cls,
                                         'rcnn_reg': rcnn_reg}
            return batch_dict
        if len(rounds) > 1:
            batch_dict['rcnn_cls'] = torch.stack([c for c, _ in rounds])   # (S, B·R, 1)
            batch_dict['rcnn_reg'] = torch.stack([g for _, g in rounds])
        else:
            batch_dict['rcnn_cls'] = rcnn_cls
            batch_dict['rcnn_reg'] = rcnn_reg
        if cfg.get('EMBEDDING_REQUIRED', False):
            batch_dict['shared_features'] = shared.reshape(b, r, -1)
        batch_cls, batch_box = rht.generate_predicted_boxes(
            batch_dict['rois'], rcnn_cls, rcnn_reg)
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict


def build_roi_head(model_cfg, num_class, input_channels, voxel_size=None,
                   point_cloud_range=None, backbone_channels=None):
    """CLASS_AGNOSTIC RoI heads score one class.  ``input_channels``: the
    keypoint features' width (PVRCNNHead) or the BEV map's (SECONDHead, which
    also takes the voxel size and the point cloud range); VoxelRCNNHead
    reads the sparse backbone's stages, of ``backbone_channels`` widths;
    PartA2FCHead UNetV2's voxel features and PointRCNNHead PointNet2MSG's
    point features, ``input_channels`` wide."""
    nc = 1 if model_cfg.get('CLASS_AGNOSTIC', True) else num_class
    if model_cfg['NAME'] == 'PVRCNNHead':
        return PVRCNNHead(model_cfg, input_channels, num_class=nc)
    if model_cfg['NAME'] == 'SECONDHead':
        from .second_head import SECONDHead
        return SECONDHead(model_cfg, input_channels, num_class=nc, voxel_size=voxel_size,
                          point_cloud_range=point_cloud_range)
    if model_cfg['NAME'] == 'PartA2FCHead':
        from .parta2_head import PartA2FCHead
        return PartA2FCHead(model_cfg, input_channels, num_class=nc)
    if model_cfg['NAME'] == 'PointRCNNHead':
        from .pointrcnn_head import PointRCNNHead
        return PointRCNNHead(model_cfg, input_channels, num_class=nc)
    if model_cfg['NAME'] == 'VoxelRCNNHead':
        from .voxelrcnn_head import VoxelRCNNHead
        return VoxelRCNNHead(model_cfg, backbone_channels, num_class=nc,
                             voxel_size=voxel_size, point_cloud_range=point_cloud_range)
    raise KeyError(f"roi head {model_cfg['NAME']} is not ported yet")

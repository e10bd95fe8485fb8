"""VoxelRCNN RoI head (torch): port of
``crb_active_3ddet_tpu/models/roi_heads/voxelrcnn_head.py`` (reference
``pcdet/models/roi_heads/voxelrcnn_head.py`` and
``pcdet/ops/pointnet2/pointnet2_stack/voxel_pool_modules.py``): the proposal
layer, in training the proposal targets, then RoI-grid pooling by voxel
query: for each of the G³ grid points of each RoI and each sparse-conv
source of ``FEATURES_SOURCE``, up to NSAMPLE non-empty voxels of a
±QUERY_RANGES window within POOL_RADIUS (``ops/voxel_query.py``), their
features through ``mlps_in`` before the grouping, their offsets through
``mlps_pos``, ReLU of the sum, a max- or avg-pool, then ``mlps_out``; the
sources' pooled features concatenated, flattened grid-major to
(B·R, G³·C), and the shared, cls and reg FC towers with ``cls_pred_layer``
and ``reg_pred_layer``; in eval the box decode.

Module names and layouts are OpenPCDet's: ``roi_grid_pool_layers.{i}`` (one
a source) hold ``mlps_in.{k}`` (Conv1d(k=1, no bias) + BatchNorm1d),
``mlps_pos.{k}`` (Conv2d(3, ·, 1) + BatchNorm2d) and ``mlps_out.{k}``
(Conv1d + BatchNorm1d + ReLU); the towers are Linear (no bias) +
BatchNorm1d + ReLU stacks with a Dropout between their layers when
DP_RATIO > 0.  OpenPCDet flattens the pooled grid grid-major too, so its
first shared FC maps across unpermuted.  As in the JAX head, only the
first entry of a source's QUERY_RANGES is read, ``PRE_MLP`` is not, and
every BatchNorm in training takes Flax's batch statistics over all rows
(``models/flax_layers.py``), with no mask: ``mlps_in``'s over every voxel
row of the buffer, invalid rows too; ``mlps_pos``'s over every slot,
repeated first hits and the zeroed slots of empty queries included;
``mlps_out``'s over every grid point, before the empty ones are zeroed.

The training forward draws the RoI sample and the Dropout masks from the
``torch.Generator`` it is given; an eval forward given one turns the
towers' Dropout live (the BatchNorms stay in eval mode), as the JAX head's
``has_rng('dropout')`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import voxel_query as vq
from ...utils.common import get_voxel_centers
from ..backbones_3d.pfe import _BN_EPS, pointwise_stack, run_pointwise
from . import roi_head_template as rht
from .pvrcnn_head import get_global_grid_points_of_roi


def _gather_rows(table, idx):
    """table (B, V, C), idx (B, M, S) rows → (B, M, S, C)."""
    b, v, c = table.shape
    rows = idx.long() + (torch.arange(b, device=idx.device) * v)[:, None, None]
    return table.reshape(b * v, c)[rows]


class NeighborVoxelSAModuleMSG(nn.Module):
    """One source's voxel-query pooling, a branch per entry of its MLPS
    (each [mid, out]: OpenPCDet prepends the source's width at build)."""

    def __init__(self, layer_cfg, in_channels):
        super().__init__()
        mlps = [(int(m[0]), int(m[-1])) for m in layer_cfg['MLPS']]
        self.query_range = tuple(int(x) for x in layer_cfg['QUERY_RANGES'][0])
        self.radii = tuple(float(r) for r in layer_cfg['POOL_RADIUS'])
        self.nsamples = tuple(int(n) for n in layer_cfg['NSAMPLE'])
        self.avg_pool = layer_cfg.get('POOL_METHOD', 'max_pool') == 'avg_pool'

        def norm(cls, c):
            return cls(c, eps=_BN_EPS, momentum=0.01)
        self.mlps_in = nn.ModuleList(
            nn.Sequential(nn.Conv1d(in_channels, mid, 1, bias=False),
                          norm(nn.BatchNorm1d, mid)) for mid, _ in mlps)
        self.mlps_pos = nn.ModuleList(
            nn.Sequential(nn.Conv2d(3, mid, 1, bias=False), norm(nn.BatchNorm2d, mid))
            for mid, _ in mlps)
        self.mlps_out = nn.ModuleList(
            pointwise_stack([mid, out], nn.Conv1d, nn.BatchNorm1d) for mid, out in mlps)
        self.num_out_channels = sum(out for _, out in mlps)

    def forward(self, ms, centers, cells, grid_pts):
        """ms: the source's stage dict; centers (B, V, 3) its voxel centres;
        cells (B, M, 3) z,y,x query cells at its stride; grid_pts (B, M, 3).
        Returns (B, M, Σ out), zero at queries without a hit."""
        outs = []
        for k, radius in enumerate(self.radii):
            feat_in = run_pointwise(self.mlps_in[k], ms['features'].to(torch.float32))
            idx, cnt = vq.voxel_query(cells, grid_pts, ms['coords'], ms['valid'], centers,
                                      ms['grid'], self.query_range, radius, self.nsamples[k])
            ok = (cnt > 0)[..., None, None]
            rel = _gather_rows(centers, idx) - grid_pts[:, :, None, :]
            rel = torch.where(ok, rel, torch.zeros_like(rel))
            # an empty query's slots all read row 0 and are zeroed next: they
            # read rows spread over the frame instead, so that the gather's
            # backward (a sorted index_put) does not pile ~10⁵ zeros onto one
            # row: that took 331 of the 411 ms of device time of a
            # voxel_rcnn_car.yaml train step at batch 4 on an H100
            spread = torch.arange(idx.shape[1] * idx.shape[2], device=idx.device)
            spread = (spread % feat_in.shape[1]).reshape(idx.shape[1:]).to(idx.dtype)
            grouped = _gather_rows(feat_in, torch.where(ok[..., 0], idx, spread))
            grouped = torch.where(ok, grouped, torch.zeros_like(grouped))
            x = torch.relu(grouped + run_pointwise(self.mlps_pos[k], rel))
            if self.avg_pool:
                pooled = x.sum(dim=2) / torch.clamp(cnt[..., None].to(x.dtype), min=1.0)
            else:
                pooled = x.amax(dim=2)      # ties share the gradient, as JAX's max
            pooled = run_pointwise(self.mlps_out[k], pooled)
            outs.append(torch.where(ok[..., 0], pooled, torch.zeros_like(pooled)))
        return torch.cat(outs, dim=-1)


class VoxelRCNNHead(nn.Module):
    def __init__(self, model_cfg, backbone_channels, num_class=1,
                 voxel_size=(0.05, 0.05, 0.1), point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        pool = model_cfg['ROI_GRID_POOL']
        self.grid_size = int(pool['GRID_SIZE'])
        self.sources = tuple(pool['FEATURES_SOURCE'])
        self.roi_grid_pool_layers = nn.ModuleList(
            NeighborVoxelSAModuleMSG(pool['POOL_LAYERS'][src], int(backbone_channels[src]))
            for src in self.sources)
        c_out = sum(layer.num_out_channels for layer in self.roi_grid_pool_layers)
        dp = float(model_cfg.get('DP_RATIO', 0.3))

        def tower(c_in, chans):
            chans = [int(c) for c in chans]
            return pointwise_stack([c_in, *chans], nn.Linear, nn.BatchNorm1d, dp_ratio=dp,
                                   dropout_after=range(len(chans) - 1) if dp > 0 else ())
        shared = list(model_cfg['SHARED_FC'])
        self.shared_fc_layer = tower(self.grid_size ** 3 * c_out, shared)
        self.cls_fc_layers = tower(int(shared[-1]), model_cfg['CLS_FC'])
        self.cls_pred_layer = nn.Linear(int(model_cfg['CLS_FC'][-1]), num_class)
        self.reg_fc_layers = tower(int(shared[-1]), model_cfg['REG_FC'])
        self.reg_pred_layer = nn.Linear(int(model_cfg['REG_FC'][-1]),
                                        rht._CODER.code_size * num_class)

    def _dropouts(self):
        return [m for stack in (self.shared_fc_layer, self.cls_fc_layers, self.reg_fc_layers)
                for m in stack if isinstance(m, nn.Dropout)]

    def roi_grid_pool(self, batch_dict):
        """Every source's pooled features at the G³ grid points of every RoI
        → (B·R, G³·C), grid-major, the sources' channels concatenated."""
        rois = batch_dict['rois']                                       # (B, R, 7)
        b, r = rois.shape[:2]
        g3 = self.grid_size ** 3
        grid_pts = get_global_grid_points_of_roi(
            rois.reshape(b * r, -1), self.grid_size).reshape(b, r * g3, 3)
        dev = grid_pts.device
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=dev)
        pooled = []
        for src, layer in zip(self.sources, self.roi_grid_pool_layers):
            ms = batch_dict['multi_scale_3d_features'][src]
            stride = int(batch_dict['multi_scale_3d_strides'][src])
            cells = torch.floor((grid_pts - pcr) / (vs * stride)).to(torch.int32).flip(-1)
            centers = get_voxel_centers(ms['coords'], stride, self.voxel_size,
                                        self.point_cloud_range)
            pooled.append(layer(ms, centers, cells, grid_pts))
        return torch.cat(pooled, dim=-1).reshape(b * r, -1)

    def tower(self, pooled, generator=None):
        """(B·R, G³·C) → shared features, rcnn_cls, rcnn_reg.  Dropout
        entries follow their modules' mode and draw from ``generator``."""
        shared = run_pointwise(self.shared_fc_layer, pooled, generator=generator)
        cls = run_pointwise(self.cls_fc_layers, shared, generator=generator)
        reg = run_pointwise(self.reg_fc_layers, shared, generator=generator)
        return shared, self.cls_pred_layer(cls), self.reg_pred_layer(reg)

    def forward(self, batch_dict, generator=None):
        """Eval: proposals (NMS_CONFIG.TEST) unless ``rois`` are given, the
        pooling, the towers and the decoded boxes.  Training: proposals
        (NMS_CONFIG.TRAIN), the targets sampled with ``generator``, or, given
        ``rois`` and their ``roi_targets_dict``, those; ``roi_targets`` then
        carries the targets with rcnn_cls and rcnn_reg."""
        cfg = self.model_cfg
        batch_dict, targets = rht.rois_and_targets(batch_dict, cfg, self.training, generator)
        rois = batch_dict['rois']
        b, r = rois.shape[:2]
        pooled = self.roi_grid_pool(batch_dict)
        dropouts = self._dropouts() if not self.training and generator is not None else []
        for m in dropouts:                  # only the Dropout entries go live
            m.train()
        try:
            shared, rcnn_cls, rcnn_reg = self.tower(pooled, generator)
        finally:
            for m in dropouts:
                m.eval()
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

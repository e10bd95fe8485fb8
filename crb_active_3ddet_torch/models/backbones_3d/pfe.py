"""Voxel Set Abstraction (PV-RCNN's PFE) and its multi-scale grouping module
(torch): port of ``crb_active_3ddet_tpu/models/backbones_3d/pfe.py``
(reference ``pcdet/models/backbones_3d/pfe/voxel_set_abstraction.py`` and
``pointnet2_stack/pointnet2_modules.py`` StackSAModuleMSG).

Ragged stacked tensors are (B, N, ...) padded buffers with masks.  Modules
and parameters carry OpenPCDet's names and shapes (``SA_rawpoints.mlps.0.0``
is a bias-free 1×1 Conv2d, ``.1`` its BatchNorm2d; ``SA_layers.{k}`` in
FEATURES_SOURCE order; ``vsa_point_feature_fusion.{0,1}``).  The tensors stay
channels-last as in the JAX package, so a 1×1 conv is applied as a linear map
over the last dim.  In training every BatchNorm takes Flax's batch
statistics over all leading axes (``models/flax_layers.py``), with no mask,
as the JAX modules' plain ``nn.BatchNorm``: zeroed empty groups and invalid
keypoints count in the mean.

PV-RCNN++ (``SAMPLE_METHOD: SPC``, JAX ``pfe.py:111-126``): the keypoints
are sampled by FPS over the candidate points alone, a valid point being a
candidate when it lies within ‖roi_dims / 2‖ + SAMPLE_RADIUS_WITH_ROI of
some RoI's centre (``spc_candidates``); a frame without a candidate falls
back to all its valid points.  As in the JAX module: NUM_SECTORS is not
read, every one of the R RoI rows counts (a zero-padded RoI makes the points
within SAMPLE_RADIUS_WITH_ROI of the origin candidates), FPS still starts at
index 0 whether or not point 0 is a candidate, and a keypoint's validity is
its point's, not its candidacy.  An SA_LAYER entry with NUM_GROUPS is a
vector pool (``vector_pool.VectorPoolAggregationMSG``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import pointnet2 as pn2
from ...utils.common import get_voxel_centers
from ..flax_layers import flax_batch_norm, flax_dropout

_BN_EPS = 1e-3
_SPC_CHUNK = 1 << 24            # (point, RoI) pairs a step of the SPC test


def pointwise_stack(channels, conv, norm, dropout_after=(), dp_ratio=0.0,
                    out_channels=None):
    """``nn.Sequential`` of [conv(k=1, no bias), norm, ReLU] per entry of
    ``channels[1:]``, a Dropout after the blocks listed in ``dropout_after``,
    and a final biased conv when ``out_channels`` is given — the layout of
    OpenPCDet's ``make_fc_layers`` / shared MLPs, so state_dict keys agree."""
    def layer(c_in, c_out, bias):
        if conv is nn.Linear:
            return nn.Linear(c_in, c_out, bias=bias)
        return conv(c_in, c_out, 1, bias=bias)

    layers = []
    for k in range(len(channels) - 1):
        layers += [layer(channels[k], channels[k + 1], False),
                   norm(channels[k + 1], eps=_BN_EPS, momentum=0.01), nn.ReLU()]
        if k in dropout_after:
            layers.append(nn.Dropout(dp_ratio))
    if out_channels is not None:
        layers.append(layer(channels[-1], out_channels, True))
    return nn.Sequential(*layers)


def run_pointwise(stack, x, taps=None, generator=None):
    """Apply a ``pointwise_stack`` to a channels-last tensor (..., C).  Each
    ReLU output is appended to ``taps`` when a list is given.  A BatchNorm
    in training mode takes Flax's batch statistics over all leading axes; a
    Dropout entry in training mode is Flax's, its mask drawn from
    ``generator`` (it raises without one when p > 0), and the identity in
    eval mode.  A caller that wants live Dropout beside eval-mode
    BatchNorms (MC dropout) puts only the Dropout entries in training
    mode."""
    for m in stack:
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            x = F.linear(x, m.weight.flatten(1), m.bias)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            if m.training:
                x = flax_batch_norm(x, m)
            else:
                inv = torch.rsqrt(m.running_var + m.eps)
                x = (x - m.running_mean) * (inv * m.weight) + m.bias
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
            if taps is not None:
                taps.append(x)
        else:                                           # nn.Dropout
            x = flax_dropout(x, m.p, m.training, generator)
    return x


class StackSAModuleMSG(nn.Module):
    """Multi-scale grouping + shared MLP + max-pool over each ball."""

    def __init__(self, radii, nsamples, mlps, in_channels, use_xyz=True):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.use_xyz = use_xyz
        c_in = in_channels + (3 if use_xyz else 0)
        self.mlps = nn.ModuleList(
            pointwise_stack([c_in, *mlp], nn.Conv2d, nn.BatchNorm2d)
            for mlp in mlps)
        self.num_out_channels = sum(int(mlp[-1]) for mlp in mlps)

    def forward(self, xyz, xyz_valid, new_xyz, new_xyz_valid, features):
        """xyz (B, N, 3); new_xyz (B, M, 3); features (B, N, C).
        Returns (B, M, Σ_k mlps[k][-1])."""
        outs = []
        table = torch.cat([xyz, features.to(xyz.dtype)], dim=-1)
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            idx, cnt = pn2.ball_query(radius, nsample, xyz, xyz_valid, new_xyz,
                                      new_xyz_valid)            # (B, M, ns)
            grouped = pn2.grouping_operation(table, idx)
            grouped[..., :3] -= new_xyz[:, :, None, :]          # in place
            if not self.use_xyz:
                grouped = grouped[..., 3:]
            # zero the empty groups and invalid centres before the MLP and
            # the pooled row after it (BN biases make zero in ≠ zero out)
            ok = (cnt > 0) & new_xyz_valid
            grouped.masked_fill_(~ok[..., None, None], 0.0)
            pooled = run_pointwise(mlp, grouped).max(dim=2).values
            outs.append(pooled.masked_fill_(~ok[..., None], 0.0))
        return torch.cat(outs, dim=-1)


def bilinear_interpolate(im, x, y):
    """im (B, H, W, C); x, y (B, M) float pixel indices → (B, M, C).
    Parity: ``voxel_set_abstraction.bilinear_interpolate_torch``: the
    neighbours are clipped to the map and the weights use the clipped
    indices."""
    b, h, w, c = im.shape
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = im.reshape(b, h * w, c)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, c))

    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (at(y0, x0) * wa[..., None] + at(y1, x0) * wb[..., None]
            + at(y0, x1) * wc[..., None] + at(y1, x1) * wd[..., None])


def _norm3(v):
    """Euclidean norm over the last axis of 3, as (x² + y²) + z²."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])


def spc_candidates(xyz, valid, rois, radius: float):
    """SPC's candidate mask: xyz (B, N, 3) with validity (B, N), rois
    (B, R, 7) → (B, N) bool, a valid point within ‖dims / 2‖ + ``radius``
    of some RoI's centre (strictly), or every valid point of a frame
    without one.  The (B, N, R) test runs over chunks of points."""
    b, n, _ = xyz.shape
    limit = _norm3(rois[..., 3:6] / 2) + radius                 # (B, R)
    rows = max(1, _SPC_CHUNK // max(1, b * rois.shape[1]))
    near = [(_norm3(xyz[:, n0:n0 + rows, None, :] - rois[:, None, :, 0:3])
             < limit[:, None, :]).any(-1) for n0 in range(0, n, rows)]
    cand = valid & torch.cat(near, dim=1)
    return torch.where(cand.any(-1, keepdim=True), cand, valid)


class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features, num_rawpoint_features, backbone_channels):
        super().__init__()
        if model_cfg.get('SAMPLE_METHOD', 'FPS') not in ('FPS', 'SPC'):
            raise NotImplementedError(f"SAMPLE_METHOD {model_cfg['SAMPLE_METHOD']}")
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        sa_cfg = model_cfg['SA_LAYER']

        def make_sa(layer_cfg, in_channels):
            if 'NUM_GROUPS' in layer_cfg:
                from .vector_pool import VectorPoolAggregationMSG
                return VectorPoolAggregationMSG(layer_cfg, in_channels)
            return StackSAModuleMSG(layer_cfg['POOL_RADIUS'], layer_cfg['NSAMPLE'],
                                    layer_cfg['MLPS'], in_channels)

        c_in = 0
        self.SA_layers = nn.ModuleList()
        self.SA_layer_names = []
        for src in model_cfg['FEATURES_SOURCE']:
            if src == 'bev':
                c_in += num_bev_features
            elif src == 'raw_points':
                # frames without point features get one zero channel
                self.SA_rawpoints = make_sa(sa_cfg['raw_points'],
                                            max(num_rawpoint_features - 3, 1))
                c_in += self.SA_rawpoints.num_out_channels
            else:
                self.SA_layers.append(make_sa(sa_cfg[src], backbone_channels[src]))
                self.SA_layer_names.append(src)
                c_in += self.SA_layers[-1].num_out_channels
        self.num_point_features_before_fusion = c_in
        self.num_point_features = int(model_cfg['NUM_OUTPUT_FEATURES'])
        self.vsa_point_feature_fusion = pointwise_stack(
            [c_in, self.num_point_features], nn.Linear, nn.BatchNorm1d)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        points = batch_dict['points']                  # (B, N, C)
        points_valid = batch_dict['points_valid']
        xyz = points[..., :3].contiguous()

        # keypoints: FPS over the raw points, or over SPC's candidates
        cand_valid = points_valid
        if cfg.get('SAMPLE_METHOD', 'FPS') == 'SPC' and 'rois' in batch_dict:
            cand_valid = spc_candidates(xyz, points_valid, batch_dict['rois'],
                                        float(cfg['SPC_SAMPLING']['SAMPLE_RADIUS_WITH_ROI']))
        kp_idx = pn2.farthest_point_sample(xyz, cand_valid,
                                           int(cfg['NUM_KEYPOINTS'])).long()
        keypoints = torch.gather(xyz, 1, kp_idx[..., None].expand(-1, -1, 3))
        kp_valid = torch.gather(points_valid, 1, kp_idx)

        feats = []
        if 'bev' in cfg['FEATURES_SOURCE']:
            bev = batch_dict['spatial_features']        # (B, H, W, C) NHWC
            stride = batch_dict.get('spatial_features_stride', 8)
            x_idx = (keypoints[..., 0] - self.point_cloud_range[0]) \
                / self.voxel_size[0] / stride
            y_idx = (keypoints[..., 1] - self.point_cloud_range[1]) \
                / self.voxel_size[1] / stride
            feats.append(bilinear_interpolate(bev, x_idx, y_idx))

        if 'raw_points' in cfg['FEATURES_SOURCE']:
            raw_feats = points[..., 3:] if points.shape[-1] > 3 \
                else points.new_zeros((*points.shape[:2], 1))
            feats.append(self.SA_rawpoints(xyz, points_valid, keypoints,
                                           kp_valid, raw_feats))

        for src, sa in zip(self.SA_layer_names, self.SA_layers):
            ms = batch_dict['multi_scale_3d_features'][src]
            down = int(cfg['SA_LAYER'][src]['DOWNSAMPLE_FACTOR'])
            centers = get_voxel_centers(ms['coords'], down, self.voxel_size,
                                        self.point_cloud_range)
            feats.append(sa(centers, ms['valid'], keypoints, kp_valid,
                            ms['features']))

        point_features = torch.cat(feats, dim=-1)       # (B, K, c_in)
        batch_dict['point_features_before_fusion'] = point_features
        batch_dict['point_features'] = run_pointwise(
            self.vsa_point_feature_fusion, point_features)      # (B, K, 128)
        batch_dict['point_coords'] = keypoints          # (B, K, 3)
        batch_dict['point_coords_valid'] = kp_valid
        return batch_dict


def build_pfe(model_cfg, voxel_size, point_cloud_range, num_bev_features,
              num_rawpoint_features, backbone_channels):
    if model_cfg['NAME'] == 'VoxelSetAbstraction':
        return VoxelSetAbstraction(model_cfg, voxel_size, point_cloud_range,
                                   num_bev_features, num_rawpoint_features,
                                   backbone_channels)
    raise KeyError(f"pfe {model_cfg['NAME']} is not ported yet")

"""PointNet++ MSG backbone (PointRCNN's point-feature extractor), torch: port
of ``crb_active_3ddet_tpu/models/backbones_3d/pointnet2_backbone.py:27-83``
(reference ``pcdet/models/backbones_3d/pointnet2_backbone.py`` PointNet2MSG
over the ``pointnet2_batch`` ops).

Set abstraction levels downsample the padded (B, N) points by farthest point
sampling (the hand-written kernel, ``ops/pointnet2.farthest_point_sample``)
and group each sample's neighbours at several radii (``StackSAModuleMSG``);
feature propagation then carries the features back up, from the deepest
level, by three-NN inverse-distance interpolation
(``ops/pointnet2.three_nn`` / ``three_interpolate``), each level's MLP
(1×1 conv without bias, BatchNorm, ReLU) over [skip features | interpolated
features], padding rows zeroed after it.  In training the FP BatchNorms
take Flax's statistics over every (B, N) row, padding included, as the JAX
module's.

Module names and layouts are OpenPCDet's: ``SA_modules.{k}.mlps.{m}`` and
``FP_modules.{k}.mlp`` (Conv2d + BatchNorm2d stacks).  One difference is
kept from the JAX package: OpenPCDet's ``PointnetFPModule`` concatenates
[interpolated | skip], the JAX module [skip | interpolated]; the port
computes as the JAX module does, and ``utils/openpcdet_ckpt.py`` swaps the
input columns of an FP module's first weight.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import pointnet2 as pn2
from .pfe import StackSAModuleMSG, pointwise_stack, run_pointwise


class PointnetFPModule(nn.Module):
    def __init__(self, mlp):
        super().__init__()
        self.mlp = pointwise_stack(list(mlp), nn.Conv2d, nn.BatchNorm2d)


def sample_and_gather(xyz, valid, npoint: int):
    """FPS of ``npoint`` of the padded (B, N, 3) points → their
    coordinates (B, npoint, 3) and validity (B, npoint)."""
    idx = pn2.farthest_point_sample(xyz, valid, npoint).long()
    return (torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3)),
            torch.gather(valid, 1, idx))


class PointNet2MSG(nn.Module):
    decoder = True      # its FP levels give every input point features: the point source

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        sa = model_cfg['SA_CONFIG']
        self.npoints = [int(n) for n in sa['NPOINTS']]
        c_in = input_channels - 3
        skip = [c_in]
        self.SA_modules = nn.ModuleList()
        for k in range(len(self.npoints)):
            self.SA_modules.append(StackSAModuleMSG(sa['RADIUS'][k], sa['NSAMPLE'][k],
                                                    sa['MLPS'][k], c_in))
            c_in = self.SA_modules[-1].num_out_channels
            skip.append(c_in)
        self.skip_channels = skip[:-1]      # each FP level's skip features
        fp = [list(m) for m in model_cfg['FP_MLPS']]
        self.FP_modules = nn.ModuleList(
            PointnetFPModule([skip[k] + (fp[k + 1][-1] if k + 1 < len(fp) else c_in), *fp[k]])
            for k in range(len(fp)))
        self.num_point_features = fp[0][-1]

    def forward(self, batch_dict):
        points, valid = batch_dict['points'], batch_dict['points_valid']
        l_xyz = [points[..., :3].contiguous()]
        l_feats, l_valid = [points[..., 3:]], [valid]
        for npoint, sa in zip(self.npoints, self.SA_modules):
            new_xyz, new_valid = sample_and_gather(l_xyz[-1], l_valid[-1], npoint)
            l_feats.append(sa(l_xyz[-1], l_valid[-1], new_xyz, new_valid, l_feats[-1]))
            l_xyz.append(new_xyz)
            l_valid.append(new_valid)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            dist, idx = pn2.three_nn(l_xyz[i], l_valid[i], l_xyz[i + 1], l_valid[i + 1])
            x = torch.cat([l_feats[i].to(l_feats[i + 1].dtype),
                           pn2.three_interpolate(l_feats[i + 1], idx, dist)], dim=-1)
            x = run_pointwise(self.FP_modules[i].mlp, x)
            l_feats[i] = x.masked_fill(~l_valid[i][..., None], 0.0)
        batch_dict['point_features'] = l_feats[0]               # (B, N, C0)
        batch_dict['point_coords'] = l_xyz[0]                   # (B, N, 3)
        batch_dict['point_valid'] = valid
        batch_dict['point_coords_valid'] = valid
        return batch_dict

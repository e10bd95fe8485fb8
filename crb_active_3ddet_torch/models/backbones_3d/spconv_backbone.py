"""Sparse 3D backbone (torch): port of ``VoxelBackBone8x`` from
``crb_active_3ddet_tpu/models/backbones_3d/spconv_backbone.py:219``
(reference ``pcdet/models/backbones_3d/spconv_backbone.py:69-180``).

Sparse tensors are fixed-capacity batched (features (B, V, C), coords
(B, V, 3) z/y/x, valid (B, V)).  Rulebooks come from sorts
(``ops/sparse/rulebook.py``): the windowed subm rulebook, unpacked to
(V, 27) taps, once per stage, and the strided rulebook from the downsample
sort.  Every layer then runs the hand-written gather-GEMM kernel
(``ops/cuda_kernels.py``) over one flat (B·V_out, K) rulebook whose entries
are offset by b·V_in.  When a gradient is wanted, each rulebook's inverse is
built once too, for the backward's input gradient, and in bf16 its (K,
B·V_out) transpose, for the weight gradient's tensor-core kernel.  Module
names follow OpenPCDet (``conv_input.0.weight``, ``conv2.0.1.running_mean``,
…); a sparse conv weight is kept as (K, Cin, Cout), the kernel's layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.cuda_kernels import SparseConvGatherGemm
from ...ops.sparse import rulebook as rb
from ...ops.sparse.sparse_ops import sparse_tensor_to_dense


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the valid rows of a padded (..., C) tensor (eps 1e-3,
    momentum 0.01 like spconv's BatchNorm1d), as the JAX package's
    ``MaskedBatchNorm`` (``spconv_backbone.py:29-54``).  Training: the mean
    and the biased variance over the valid rows of the whole batch (their
    count clipped to 1), and the running statistics become ``0.99·old +
    0.01·new``; eval: the running statistics."""

    KEEP = 0.99              # Flax's momentum: the share of the old statistic

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x, valid):
        if self.training:
            red = tuple(range(x.ndim - 1))
            rows = valid[..., None]
            n = torch.clamp(valid.sum(), min=1).to(x.dtype)
            mean = torch.where(rows, x, 0.0).sum(red) / n
            var = torch.where(rows, (x - mean) ** 2, 0.0).sum(red) / n
            with torch.no_grad():
                self.running_mean.copy_(self.KEEP * self.running_mean
                                        + (1 - self.KEEP) * mean)
                self.running_var.copy_(self.KEEP * self.running_var
                                       + (1 - self.KEEP) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.weight + self.bias


class SparseConv3d(nn.Module):
    """Holds one sparse conv's (K, Cin, Cout) weight and geometry."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1), subm=True):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.padding, self.subm = tuple(padding), subm
        k = math.prod(self.kernel_size)
        self.weight = nn.Parameter(torch.empty(k, in_channels, out_channels))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(k * out_channels))


class SparseConvLayer(nn.Sequential):
    """Sparse conv + BN + ReLU (OpenPCDet's ``post_act_block``: indices
    0 conv, 1 norm, 2 ReLU)."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1), subm=True):
        super().__init__(SparseConv3d(in_channels, out_channels, kernel_size,
                                      stride, padding, subm),
                         MaskedBatchNorm(out_channels), nn.ReLU())

    def forward(self, feats, rulebook, out_valid, compute_dtype, for_grad=(None, None)):
        """feats (B, V_in, Cin); rulebook (B·V_out, K) flat int32 and, when a
        gradient is wanted, ``for_grad`` = its (B·V_in, K) inverse and its
        (K, B·V_out) transpose (None in f32); out_valid (B, V_out) →
        (B, V_out, Cout) f32, zero at invalid rows."""
        b, v, cin = feats.shape
        w = self[0].weight
        out = SparseConvGatherGemm.apply(
            feats.to(compute_dtype).reshape(b * v, cin).contiguous(),
            w.to(compute_dtype).contiguous(), rulebook, *for_grad)
        out = out.reshape(b, out_valid.shape[1], w.shape[2])
        out = torch.relu(self[1](out, out_valid))
        return torch.where(out_valid[..., None], out, torch.zeros_like(out))


def flat_rulebook(rulebook, v_in):
    """(B, V_out, K) per-sample rows → (B·V_out, K) int32 rows of the flat
    (B·V_in, C) feature table (−1 stays −1)."""
    b = rulebook.shape[0]
    off = (torch.arange(b, device=rulebook.device, dtype=torch.int32)
           * v_in)[:, None, None]
    flat = torch.where(rulebook >= 0, rulebook + off, torch.full_like(rulebook, -1))
    return flat.reshape(-1, rulebook.shape[-1]).to(torch.int32).contiguous()


class VoxelBackBone8x(nn.Module):
    """conv_input → conv1 (16) → conv2 (32, /2) → conv3 (64, /4) →
    conv4 (64, /8) → conv_out (128, z/2), then a dense (B, D, H, W, C)
    volume for HeightCompression.  ``multi_scale_3d_features`` holds each
    stage's features, coords, validity and static (nz, ny, nx) ``grid``, as
    the JAX stage dicts do.

    ``VOXEL_CAPS`` bounds the active-site buffers after each downsample
    (fraction ≤ 1 of the input cap, or an absolute count); ``USE_BF16`` casts
    features and weights to bf16 for the gather-GEMM (f32 accumulation).
    """

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = tuple(int(g) for g in grid_size)   # (nx, ny, nz)
        self.conv_input = SparseConvLayer(input_channels, 16)
        self.conv1 = nn.Sequential(SparseConvLayer(16, 16))
        self.conv2 = nn.Sequential(
            SparseConvLayer(16, 32, stride=(2, 2, 2), subm=False),
            SparseConvLayer(32, 32), SparseConvLayer(32, 32))
        self.conv3 = nn.Sequential(
            SparseConvLayer(32, 64, stride=(2, 2, 2), subm=False),
            SparseConvLayer(64, 64), SparseConvLayer(64, 64))
        self.conv4 = nn.Sequential(
            SparseConvLayer(64, 64, stride=(2, 2, 2), padding=(0, 1, 1),
                            subm=False),
            SparseConvLayer(64, 64), SparseConvLayer(64, 64))
        self.conv_out = SparseConvLayer(64, 128, kernel_size=(3, 1, 1),
                                        stride=(2, 1, 1), padding=(0, 0, 0),
                                        subm=False)
        self.num_point_features = 128
        self.backbone_channels = {'x_conv1': 16, 'x_conv2': 32,
                                  'x_conv3': 64, 'x_conv4': 64}

    def forward(self, batch_dict):
        cfg = self.model_cfg
        cdt = torch.bfloat16 if cfg.get('USE_BF16', False) else torch.float32
        nx, ny, nz = self.grid_size
        grid = (nz + 1, ny, nx)    # spconv sparse_shape = grid[::-1] + [1, 0, 0]
        feats = batch_dict['voxel_features']
        coords, valid = batch_dict['voxel_coords'], batch_dict['voxel_valid']
        cap = feats.shape[1]
        fracs = tuple(cfg.get('VOXEL_CAPS', (1.0, 1.0, 1.0, 1.0)))
        caps = [max(16, int(cap * f) if f <= 1.0 else int(f)) for f in fracs]
        backward = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())

        def for_backward(rbk, feats):
            """The flat rulebook's inverse (for the dgrad) and its transpose
            (for the wgrad), once a rulebook, for the backward (nothing
            without a gradient, or when no weight here takes one)."""
            if not backward:
                return None, None
            return (rb.inverse_rulebook(rbk, feats.shape[0] * feats.shape[1]),
                    rb.transpose_rulebook(rbk))

        def subm_stage(feats, layers, coords, valid, grid):
            rbk = rb.unpack_window_rulebook(
                rb.subm_rulebook_window(coords, valid, grid))
            rbk = flat_rulebook(rbk, coords.shape[1])
            aux = for_backward(rbk, feats)
            for layer in layers:
                feats = layer(feats, rbk, valid, cdt, aux)
            return feats

        def down(feats, layer, coords, valid, grid, max_out):
            conv = layer[0]
            out_coords, out_valid, rbk = rb.downsample_rulebook(
                coords, valid, grid, conv.kernel_size, conv.stride,
                conv.padding, max_out)
            rbk = flat_rulebook(rbk, coords.shape[1])
            feats = layer(feats, rbk, out_valid, cdt, for_backward(rbk, feats))
            out_grid = rb.conv_out_grid(grid, conv.kernel_size, conv.stride,
                                        conv.padding)
            return feats, out_coords, out_valid, out_grid

        feats = subm_stage(feats, [self.conv_input, self.conv1[0]], coords,
                           valid, grid)
        stages = {'x_conv1': (feats, coords, valid, grid)}
        for name, stage, max_out in (('x_conv2', self.conv2, caps[0]),
                                     ('x_conv3', self.conv3, caps[1]),
                                     ('x_conv4', self.conv4, caps[2])):
            feats, coords, valid, grid = down(feats, stage[0], coords, valid,
                                              grid, max_out)
            feats = subm_stage(feats, list(stage)[1:], coords, valid, grid)
            stages[name] = (feats, coords, valid, grid)
        feats, coords, valid, grid = down(feats, self.conv_out, coords, valid,
                                          grid, caps[3])
        batch_dict['encoded_spconv_features'] = sparse_tensor_to_dense(
            feats, coords, valid, grid)             # (B, D, H, W, C)
        batch_dict['encoded_spconv_tensor_stride'] = 8
        batch_dict['multi_scale_3d_features'] = {
            k: {'features': f, 'coords': c, 'valid': m, 'grid': g}
            for k, (f, c, m, g) in stages.items()}
        batch_dict['multi_scale_3d_strides'] = {
            'x_conv1': 1, 'x_conv2': 2, 'x_conv3': 4, 'x_conv4': 8}
        return batch_dict


def build_backbone_3d(model_cfg, input_channels, grid_size):
    if model_cfg['NAME'] == 'VoxelBackBone8x':
        return VoxelBackBone8x(model_cfg, input_channels, grid_size)
    raise KeyError(f"backbone_3d {model_cfg['NAME']} is not ported yet")

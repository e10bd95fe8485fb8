"""Sparse 3D backbones (torch): ports of ``VoxelBackBone8x``,
``VoxelResBackBone8x`` and ``UNetV2`` from
``crb_active_3ddet_tpu/models/backbones_3d/spconv_backbone.py:219, 317, 388``
(reference ``pcdet/models/backbones_3d/spconv_backbone.py:69-180``,
``spconv_unet.py:49-215``), their ``SparseBasicBlock`` (:157) and
``SparseInverseConvLayer`` (:345), and the PartA2 head's
``DenseMaskedConv3d`` (:175).

Sparse tensors are fixed-capacity batched (features (B, V, C), coords
(B, V, 3) z/y/x, valid (B, V)).  Rulebooks come from sorts
(``ops/sparse/rulebook.py``): the windowed subm rulebook, unpacked to
(V, 27) taps, once per stage, and the strided rulebook from the downsample
sort.  Every layer then runs the hand-written gather-GEMM kernel
(``ops/cuda_kernels.py``) over one flat (B·V_out, K) rulebook whose entries
are offset by b·V_in.  When a gradient is wanted, each rulebook's inverse is
built once too, for the backward's input gradient, and in bf16 its (K,
B·V_out) transpose, for the weight gradient's kernels.  Module names
follow OpenPCDet (``conv_input.0.weight``, ``conv2.0.1.running_mean``,
``conv_up_t4.conv1.weight``, ``inv_conv4.0.weight``, …); a sparse conv
weight is kept as (K, Cin, Cout), the kernel's layout.

``VoxelResBackBone8x`` is ``VoxelBackBone8x`` with every subm layer a
``SparseBasicBlock``, as in the JAX package: one block in conv1 and 64
channels in conv4 (OpenPCDet's has two and 128).  A ``SparseBasicBlock``
runs in f32 whatever ``USE_BF16`` says (the JAX block builds its layers
without ``compute_dtype``), so under ``USE_BF16`` one forward runs both of
the gather-GEMM's routes.  ``UNetV2``'s decoder upsamples with inverse
convs: the gather-GEMM over the inverse of the downsample's rulebook, whose
own backward runs over the downsample's rulebook (the inverse's inverse)
and the inverse's transpose; each level builds that pair once, for the
encoder's strided layer and the decoder's inverse conv alike.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


def gather_gemm(feats, weight, rulebook, n_out, compute_dtype, for_grad):
    """(B, V_in, Cin) features through the gather-GEMM over a flat
    rulebook → (B, n_out, Cout) f32; features and weight cast to
    ``compute_dtype`` first."""
    b, v, cin = feats.shape
    out = SparseConvGatherGemm.apply(
        feats.to(compute_dtype).reshape(b * v, cin).contiguous(),
        weight.to(compute_dtype).contiguous(), rulebook, *for_grad)
    return out.reshape(b, n_out, weight.shape[2])


def _masked(x, valid):
    return torch.where(valid[..., None], x, torch.zeros_like(x))


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
        out = gather_gemm(feats, self[0].weight, rulebook, out_valid.shape[1],
                          compute_dtype, for_grad)
        return _masked(torch.relu(self[1](out, out_valid)), out_valid)


class SparseInverseConvLayer(SparseConvLayer):
    """spconv's ``SparseInverseConv3d`` + BN + ReLU (OpenPCDet's
    ``post_act_block`` with ``conv_type='inverseconv'``): the coarse
    features back onto the fine voxel set of the strided conv that made
    them, through the gather-GEMM over that conv's inverse rulebook, with
    the weight at the same offset k."""

    def __init__(self, in_channels, out_channels):
        super().__init__(in_channels, out_channels, subm=False)

    def forward(self, feats, link, compute_dtype):
        """feats (B, V_coarse, Cin); ``link`` the downsample's ``Link`` →
        (B, V_fine, Cout) f32, zero at the fine set's invalid rows."""
        return super().forward(feats, link.inverse, link.fine_valid, compute_dtype,
                               link.for_inverse_grad)


class SparseBasicBlock(nn.Module):
    """Two subm convs with BN (OpenPCDet's ``conv1``/``bn1``/``conv2``/
    ``bn2``), the identity added before the last ReLU, the result zero at
    the invalid rows.  Always f32, as the JAX block (``spconv_backbone.py:
    157``) builds its layers without ``compute_dtype``."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, feats, rulebook, valid, compute_dtype=None, for_grad=(None, None)):
        """``compute_dtype`` is ignored (f32)."""
        n = valid.shape[1]
        out = gather_gemm(feats, self.conv1.weight, rulebook, n, torch.float32, for_grad)
        out = _masked(torch.relu(self.bn1(out, valid)), valid)
        out = gather_gemm(out, self.conv2.weight, rulebook, n, torch.float32, for_grad)
        out = _masked(self.bn2(out, valid), valid)
        return _masked(torch.relu(out + feats), valid)


class DenseConv3d(nn.Module):
    """Holds one dense 3D conv's (kx, ky, kz, Cin, Cout) weight, the JAX
    package's DHWIO layout over the RoI grid's (x, y, z) axes."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*kernel_size, in_channels, out_channels))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(math.prod(kernel_size) * out_channels))


class DenseMaskedConv3d(nn.Sequential):
    """Dense 3D conv + masked BN + ReLU with sparse-conv semantics (JAX
    ``spconv_backbone.py:175``): a subm conv is the dense conv with its
    output zeroed off the (unchanged) occupancy mask; a strided one
    max-pools the mask.  BatchNorm over the mask's cells.  Indices 0 conv,
    1 norm, 2 ReLU, as OpenPCDet's ``post_act_block`` of the sparse convs
    it stands for.  The convolution is cuDNN's (the JAX package computes it
    outside any Pallas kernel, as ``lax.conv_general_dilated``)."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 padding=(1, 1, 1), subm=True):
        super().__init__(DenseConv3d(in_channels, out_channels, kernel_size),
                         MaskedBatchNorm(out_channels), nn.ReLU())
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.padding, self.subm = tuple(padding), subm

    def forward(self, x, mask):
        """x (N, D, H, W, Cin) f32, mask (N, D, H, W) bool → (y (N, D', H',
        W', Cout), its mask)."""
        w = self[0].weight.permute(4, 3, 0, 1, 2)             # (Cout, Cin, kD, kH, kW)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 4, 1)
        if not self.subm:
            mask = F.max_pool3d(mask[:, None].to(y.dtype), self.kernel_size, self.stride,
                                self.padding)[:, 0] > 0
        return _masked(torch.relu(self[1](y, mask)), mask), mask


class Link:
    """What a downsample leaves for the decoder's inverse conv: the fine
    set's validity, the flat downsample rulebook and its inverse (the
    inverse conv's rulebook), and, when a gradient is wanted, the pair
    the inverse conv's backward reads: the downsample rulebook (the dgrad's
    rulebook, the inverse's inverse) and the inverse's transpose (the
    wgrad's)."""

    def __init__(self, fine_valid, rulebook, inverse, backward):
        self.fine_valid, self.rulebook, self.inverse = fine_valid, rulebook, inverse
        self.for_inverse_grad = ((rulebook, rb.transpose_rulebook(inverse)) if backward
                                 else (None, None))


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

    residual = False     # VoxelResBackBone8x: SparseBasicBlocks for the subm layers
    decoder = False      # UNetV2: the downsamples' Links for the inverse convs, point features

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = tuple(int(g) for g in grid_size)   # (nx, ny, nz)
        subm = SparseBasicBlock if self.residual else (lambda c: SparseConvLayer(c, c))
        self.conv_input = SparseConvLayer(input_channels, 16)
        self.conv1 = nn.Sequential(subm(16))
        self.conv2 = nn.Sequential(
            SparseConvLayer(16, 32, stride=(2, 2, 2), subm=False), subm(32), subm(32))
        self.conv3 = nn.Sequential(
            SparseConvLayer(32, 64, stride=(2, 2, 2), subm=False), subm(64), subm(64))
        self.conv4 = nn.Sequential(
            SparseConvLayer(64, 64, stride=(2, 2, 2), padding=(0, 1, 1), subm=False),
            subm(64), subm(64))
        self.conv_out = SparseConvLayer(64, 128, kernel_size=(3, 1, 1),
                                        stride=(2, 1, 1), padding=(0, 0, 0),
                                        subm=False)
        self.num_point_features = 128
        self.backbone_channels = {'x_conv1': 16, 'x_conv2': 32,
                                  'x_conv3': 64, 'x_conv4': 64}

    def compute_dtype(self):
        return torch.bfloat16 if self.model_cfg.get('USE_BF16', False) else torch.float32

    def encode(self, batch_dict):
        """conv_input … conv4.  Returns ({stage: (features, coords, valid,
        grid)}, {stage: its flat subm rulebook and the pair for the
        backward}, {stage: the ``Link`` of the downsample that made it})."""
        cfg = self.model_cfg
        cdt = self.compute_dtype()
        nx, ny, nz = self.grid_size
        grid = (nz + 1, ny, nx)    # spconv sparse_shape = grid[::-1] + [1, 0, 0]
        feats = batch_dict['voxel_features']
        coords, valid = batch_dict['voxel_coords'], batch_dict['voxel_valid']
        cap = feats.shape[1]
        fracs = tuple(cfg.get('VOXEL_CAPS', (1.0, 1.0, 1.0, 1.0)))
        self.caps = [max(16, int(cap * f) if f <= 1.0 else int(f)) for f in fracs]
        self.backward_wanted = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

        def subm_stage(feats, layers, coords, valid, grid):
            rbk = rb.unpack_window_rulebook(
                rb.subm_rulebook_window(coords, valid, grid))
            rbk = flat_rulebook(rbk, coords.shape[1])
            aux = self.for_backward(rbk, feats.shape[0] * feats.shape[1])
            for layer in layers:
                feats = layer(feats, rbk, valid, cdt, aux)
            return feats, (rbk, aux)

        feats, rbks = subm_stage(feats, [self.conv_input, self.conv1[0]], coords, valid, grid)
        stages = {'x_conv1': (feats, coords, valid, grid)}
        subm, links = {'x_conv1': rbks}, {}
        for name, stage, max_out in (('x_conv2', self.conv2, self.caps[0]),
                                     ('x_conv3', self.conv3, self.caps[1]),
                                     ('x_conv4', self.conv4, self.caps[2])):
            feats, out_coords, out_valid, out_grid, links[name] = self.down(
                feats, stage[0], coords, valid, grid, max_out, self.decoder)
            coords, valid, grid = out_coords, out_valid, out_grid
            feats, subm[name] = subm_stage(feats, list(stage)[1:], coords, valid, grid)
            stages[name] = (feats, coords, valid, grid)
        return stages, subm, links

    def for_backward(self, rbk, v_in):
        """The flat rulebook's inverse (for the dgrad) and its transpose
        (for the wgrad), once a rulebook, for the backward (nothing
        without a gradient, or when no weight here takes one)."""
        if not self.backward_wanted:
            return None, None
        return rb.inverse_rulebook(rbk, v_in), rb.transpose_rulebook(rbk)

    def down(self, feats, layer, coords, valid, grid, max_out, link=False):
        """One strided layer → (features, coords, valid, grid, its ``Link``
        when ``link``, else None)."""
        conv = layer[0]
        out_coords, out_valid, rbk = rb.downsample_rulebook(
            coords, valid, grid, conv.kernel_size, conv.stride, conv.padding, max_out)
        rbk = flat_rulebook(rbk, coords.shape[1])
        v_in = coords.shape[0] * coords.shape[1]
        inverse, rbk_t = self.for_backward(rbk, v_in)
        if link:
            link = Link(valid, rbk, rb.inverse_rulebook(rbk, v_in) if inverse is None
                        else inverse, self.backward_wanted)
        feats = layer(feats, rbk, out_valid, self.compute_dtype(), (inverse, rbk_t))
        out_grid = rb.conv_out_grid(grid, conv.kernel_size, conv.stride, conv.padding)
        return feats, out_coords, out_valid, out_grid, link or None

    def encoded_tensor(self, batch_dict, stages):
        """conv_out over x_conv4, scattered to the dense (B, D, H, W, C)
        volume that HeightCompression reads."""
        feats, coords, valid, grid = stages['x_conv4']
        feats, coords, valid, grid, _ = self.down(feats, self.conv_out, coords, valid,
                                                  grid, self.caps[3])
        batch_dict['encoded_spconv_features'] = sparse_tensor_to_dense(
            feats, coords, valid, grid)             # (B, D, H, W, C)
        batch_dict['encoded_spconv_tensor_stride'] = 8

    @staticmethod
    def multi_scale(batch_dict, stages):
        batch_dict['multi_scale_3d_features'] = {
            k: {'features': f, 'coords': c, 'valid': m, 'grid': g}
            for k, (f, c, m, g) in stages.items()}
        batch_dict['multi_scale_3d_strides'] = {
            'x_conv1': 1, 'x_conv2': 2, 'x_conv3': 4, 'x_conv4': 8}

    def forward(self, batch_dict):
        stages, _, _ = self.encode(batch_dict)
        self.encoded_tensor(batch_dict, stages)
        self.multi_scale(batch_dict, stages)
        return batch_dict


class VoxelResBackBone8x(VoxelBackBone8x):
    """``VoxelBackBone8x`` with ``SparseBasicBlock``s (JAX
    ``spconv_backbone.py:317``: ``residual=True``, the stages' widths
    unchanged)."""
    residual = True


class UNetV2(VoxelBackBone8x):
    """``VoxelBackBone8x``'s encoder, ``conv_out`` when
    ``RETURN_ENCODED_TENSOR`` (default True), then four UR blocks
    (``spconv_unet.py:135-143``): at each level a ``SparseBasicBlock`` over
    the encoder's lateral features (``conv_up_t``), a subm conv over
    [bottom, lateral] (``conv_up_m``) plus the concatenation's channels
    summed in groups of n adjacent ones, then the inverse conv to the
    finer level (``inv_conv``), or at the last level the subm ``conv5``.
    Emits ``point_features`` (B, V, 16) at the input voxels, their centres
    ``point_coords`` (B, V, 3) xyz and ``point_valid``.  Each level's subm
    rulebook serves its encoder and decoder layers."""
    decoder = True

    def __init__(self, model_cfg, input_channels, grid_size,
                 voxel_size=(0.05, 0.05, 0.1), point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__(model_cfg, input_channels, grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        if not model_cfg.get('RETURN_ENCODED_TENSOR', True):
            del self.conv_out
        for level, (lat, out, inv) in zip((4, 3, 2, 1), ((64, 64, 64), (64, 64, 32),
                                                          (32, 32, 16), (16, 16, 16))):
            setattr(self, f'conv_up_t{level}', SparseBasicBlock(lat))
            setattr(self, f'conv_up_m{level}', SparseConvLayer(2 * lat, out))
            if level > 1:
                setattr(self, f'inv_conv{level}', SparseInverseConvLayer(out, inv))
        self.conv5 = nn.Sequential(SparseConvLayer(16, 16))
        self.num_point_features = 16

    def forward(self, batch_dict):
        stages, subm, links = self.encode(batch_dict)
        if hasattr(self, 'conv_out'):
            self.encoded_tensor(batch_dict, stages)
        cdt = self.compute_dtype()
        x = stages['x_conv4'][0]
        for level in (4, 3, 2, 1):
            name = f'x_conv{level}'
            lateral, _, valid, _ = stages[name]
            rbk, aux = subm[name]
            trans = getattr(self, f'conv_up_t{level}')(lateral, rbk, valid, cdt, aux)
            cat = torch.cat([x, trans], dim=-1)
            up_m = getattr(self, f'conv_up_m{level}')
            x_m = up_m(cat, rbk, valid, cdt, aux)
            n_out = x_m.shape[-1]
            x = x_m + cat.reshape(*cat.shape[:-1], n_out, -1).sum(-1)   # channel_reduction
            if level > 1:
                x = getattr(self, f'inv_conv{level}')(x, links[name], cdt)
            else:
                x = self.conv5[0](x, rbk, valid, cdt, aux)
        feats, coords, valid, _ = stages['x_conv1']
        batch_dict['point_features'] = x                          # (B, V, 16)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=x.device)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=x.device)
        batch_dict['point_coords'] = (coords.flip(-1).to(torch.float32) + 0.5) * vs + pcr
        batch_dict['point_valid'] = valid
        self.multi_scale(batch_dict, stages)
        return batch_dict


def build_backbone_3d(model_cfg, input_channels, grid_size, voxel_size=None,
                      point_cloud_range=None):
    """``voxel_size`` and ``point_cloud_range`` place UNetV2's voxel
    centres; PointNet2MSG reads the raw points, ``input_channels`` wide."""
    name = model_cfg['NAME']
    if name == 'VoxelBackBone8x':
        return VoxelBackBone8x(model_cfg, input_channels, grid_size)
    if name == 'VoxelResBackBone8x':
        return VoxelResBackBone8x(model_cfg, input_channels, grid_size)
    if name == 'UNetV2':
        return UNetV2(model_cfg, input_channels, grid_size, voxel_size, point_cloud_range)
    if name == 'PointNet2MSG':
        from .pointnet2_backbone import PointNet2MSG
        return PointNet2MSG(model_cfg, input_channels)
    raise KeyError(f'backbone_3d {name} is not ported yet')

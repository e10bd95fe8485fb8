"""Weight transfer: the JAX package's Flax ``params`` / ``batch_stats`` → the
port model's ``state_dict``.

Input: nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)`` of the
JAX variables).  Output: ``{name: torch.Tensor}`` under OpenPCDet's names
(``backbone_3d.conv_input.0.weight``, ``backbone_2d.blocks.0.1.weight``,
``dense_head.conv_cls.weight``, …), so that a later step can load an
OpenPCDet ``.pth`` into the same model.  Layouts:
  * Conv2d: Flax HWIO → torch OIHW; 1×1 head convs likewise;
  * ConvTranspose2d: Flax (kh, kw, in, out), taps mirrored relative to
    torch → torch (in, out, kh, kw) (the inverse of the JAX package's
    ``utils/torch_ckpt.py:215 _t_convtranspose2d``);
  * sparse conv kernels: kept as (K, Cin, Cout), the gather-GEMM's layout;
  * BN: scale/bias → weight/bias, batch_stats mean/var → running_mean/var.
"""

from __future__ import annotations

import numpy as np
import torch

# Flax SparseConvLayer_{i} order of VoxelBackBone8x → OpenPCDet module names
VOXEL8X_ORDER = [
    'conv_input', 'conv1.0',
    'conv2.0', 'conv2.1', 'conv2.2',
    'conv3.0', 'conv3.1', 'conv3.2',
    'conv4.0', 'conv4.1', 'conv4.2',
    'conv_out',
]


def conv2d_from_flax(w):
    """Flax Conv (kh, kw, in, out) → torch Conv2d (out, in, kh, kw)."""
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def convtranspose2d_from_flax(w):
    """Flax ConvTranspose (kh, kw, in, out) → torch ConvTranspose2d
    (in, out, kh, kw): un-mirror the taps, then move the axes."""
    return np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1))


def _bn(sd, prefix, params, stats):
    sd[f'{prefix}.weight'] = params['scale']
    sd[f'{prefix}.bias'] = params['bias']
    sd[f'{prefix}.running_mean'] = stats['mean']
    sd[f'{prefix}.running_var'] = stats['var']
    sd[f'{prefix}.num_batches_tracked'] = np.zeros((), np.int64)


def flax_to_state_dict(params, batch_stats):
    """Flax SECONDNet variables → port ``state_dict`` (torch tensors)."""
    sd = {}
    p3, s3 = params['backbone_3d'], batch_stats['backbone_3d']
    for i, name in enumerate(VOXEL8X_ORDER):
        layer = f'SparseConvLayer_{i}'
        sd[f'backbone_3d.{name}.0.weight'] = p3[layer]['kernel']
        _bn(sd, f'backbone_3d.{name}.1', p3[layer]['MaskedBatchNorm_0'],
            s3[layer]['MaskedBatchNorm_0'])

    p2, s2 = params['backbone_2d'], batch_stats['backbone_2d']
    i = 0
    while f'_ConvBlock_{i}' in p2:
        blk, sblk = p2[f'_ConvBlock_{i}'], s2[f'_ConvBlock_{i}']
        j = 0
        while f'Conv_{j}' in blk:
            sd[f'backbone_2d.blocks.{i}.{1 + 3 * j}.weight'] = \
                conv2d_from_flax(blk[f'Conv_{j}']['kernel'])
            _bn(sd, f'backbone_2d.blocks.{i}.{2 + 3 * j}',
                blk[f'BatchNorm_{j}'], sblk[f'BatchNorm_{j}'])
            j += 1
        i += 1
    i = 0
    while f'_DeBlock_{i}' in p2:
        blk, sblk = p2[f'_DeBlock_{i}'], s2[f'_DeBlock_{i}']
        sd[f'backbone_2d.deblocks.{i}.0.weight'] = \
            convtranspose2d_from_flax(blk['ConvTranspose_0']['kernel'])
        _bn(sd, f'backbone_2d.deblocks.{i}.1', blk['BatchNorm_0'],
            sblk['BatchNorm_0'])
        i += 1

    for name, conv in params['dense_head'].items():
        sd[f'dense_head.{name}.weight'] = conv2d_from_flax(conv['kernel'])
        sd[f'dense_head.{name}.bias'] = conv['bias']
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

"""LossNet of learning-loss active learning (llal), torch: port of
``crb_active_3ddet_tpu/models/roi_heads/loss_net.py`` (reference
``pcdet/models/roi_heads/loss_net.py``).

For each shared-FC activation of the RoI head, (B·R, C_k): a bias-free 1×1
conv down to one channel, its BatchNorm (Flax statistics in training, as the
head's own), ReLU, reshaped to (B, R); the layers' maps concatenated, then a
biased linear map to one predicted loss a frame, (B,).  The linear layer's
width is fixed at build time, R·(number of shared layers) with R the TEST
proposal count, where the Flax Dense reads it from the init call (the JAX
model is initialised in eval mode); a training forward needs
``TARGET_CONFIG.ROI_PER_IMAGE`` to equal it, as the JAX model does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..backbones_3d.pfe import pointwise_stack, run_pointwise


class LossNet(nn.Module):
    def __init__(self, channels, num_rois):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            pointwise_stack([int(c), 1], nn.Conv1d, nn.BatchNorm1d) for c in channels)
        self.linear = nn.Linear(int(num_rois) * len(channels), 1)

    def forward(self, latents, batch_size: int):
        """latents: the shared layers' post-ReLU activations, each (B·R,
        C_k).  Returns (B,) predicted losses."""
        maps = [run_pointwise(stack, x).reshape(batch_size, -1)
                for stack, x in zip(self.conv_layers, latents)]
        return self.linear(torch.cat(maps, dim=1))[:, 0]

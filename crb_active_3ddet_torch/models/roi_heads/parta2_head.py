"""PartA2's RoI head (torch): port of ``PartA2FCHead`` from
``crb_active_3ddet_tpu/models/roi_heads/parta2_head.py:28`` (reference
``pcdet/models/roi_heads/partA2_head.py``): the proposal layer, in training
the proposal targets, then RoI-aware pooling (``ops/roi_pooling.py``) into
a G³ grid per RoI of the part features (the part offsets, zeroed where the
foreground score is at most ``SEG_MASK_SCORE_THRESH``, and the score:
avg-pooled) and of UNetV2's voxel features (max-pooled); a cell is
occupied where either pooled grid is non-zero; two masked 3×3×3 convs a
branch (``conv_part``, ``conv_rpn``: 64 then NUM_FEATURES / 2 channels,
``DenseMaskedConv3d``), their outputs concatenated [rpn, part] and
flattened grid-major (OpenPCDet flattens channel-major: its first shared FC
maps across permuted, ``utils/openpcdet_ckpt.py``); the shared FCs (Dropout
of DP_RATIO between them), the cls and reg towers (biased output layers),
and in eval the box decode.

As in the JAX head, the pooled grids are dense and the convs run over every
cell of every RoI, padding RoIs included (OpenPCDet runs sparse convs over
the occupied cells only; the results are equal); their BatchNorms take the
statistics of the occupied cells.  The FC towers' BatchNorms in training
take Flax's statistics over every RoI row.  The cls and reg towers carry a
p = 0 Dropout after their first block, where OpenPCDet's ``make_fc_layers``
puts its Dropout, so that the state_dict's indices are OpenPCDet's: the JAX
towers have none.  The training forward draws the RoI sample and the
shared FCs' Dropout masks from the ``torch.Generator`` it is given; an eval
forward given one turns that Dropout live, as the JAX head's
``has_rng('dropout')`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.roi_pooling import roiaware_pool3d
from ..backbones_3d.pfe import pointwise_stack, run_pointwise
from ..backbones_3d.spconv_backbone import DenseMaskedConv3d
from . import roi_head_template as rht


class PartA2FCHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        pool = model_cfg['ROI_AWARE_POOL']
        self.grid_size = int(pool['POOL_SIZE'])
        c0 = int(pool['NUM_FEATURES']) // 2
        self.conv_part = nn.Sequential(DenseMaskedConv3d(4, 64), DenseMaskedConv3d(64, c0))
        self.conv_rpn = nn.Sequential(DenseMaskedConv3d(input_channels, 64),
                                      DenseMaskedConv3d(64, c0))
        dp = float(model_cfg.get('DP_RATIO', 0.3))
        shared = [int(c) for c in model_cfg['SHARED_FC']]
        self.shared_fc_layer = pointwise_stack(
            [self.grid_size ** 3 * 2 * c0, *shared], nn.Linear, nn.BatchNorm1d, dp_ratio=dp,
            dropout_after=range(len(shared) - 1) if dp > 0 else ())

        def tower(chans, out):
            return pointwise_stack([shared[-1], *[int(c) for c in chans]], nn.Linear,
                                   nn.BatchNorm1d, dropout_after=(0,), out_channels=out)
        self.cls_layers = tower(model_cfg['CLS_FC'], num_class)
        self.reg_layers = tower(model_cfg['REG_FC'], rht._CODER.code_size)

    def _dropouts(self):
        return [m for m in self.shared_fc_layer if isinstance(m, nn.Dropout)]

    def roiaware_pool(self, batch_dict):
        """The two pooled grids of every RoI: part (B·R, G, G, G, 4) avg,
        rpn (B·R, G, G, G, C) max, and their occupancy (B·R, G, G, G)."""
        g = self.grid_size
        rois = batch_dict['rois']
        b, r = rois.shape[:2]
        coords, valid = batch_dict['point_coords'], batch_dict['point_valid']
        score = batch_dict['point_cls_scores'][..., None]
        thresh = float(self.model_cfg.get('SEG_MASK_SCORE_THRESH', 0.3))
        offset = batch_dict['point_part_offset']
        offset = torch.where(score > thresh, offset, torch.zeros_like(offset))
        part_feats = torch.cat([offset, score], dim=-1)
        every = torch.ones((b, r), dtype=torch.bool, device=rois.device)
        part = roiaware_pool3d(coords, part_feats, rois, valid, every, g, 'avg')
        rpn = roiaware_pool3d(coords, batch_dict['point_features'], rois, valid, every, g,
                              'max')
        part, rpn = part.reshape(b * r, g, g, g, -1), rpn.reshape(b * r, g, g, g, -1)
        mask = part.abs().sum(-1) + rpn.abs().sum(-1) > 0
        return part, rpn, mask

    def convs(self, part, rpn, mask):
        """The two conv branches → the merged (B·R, G³·2c0) features,
        grid-major, [rpn, part] at each cell."""
        x_part, x_rpn = part, rpn
        m_part = m_rpn = mask
        for layer in self.conv_part:
            x_part, m_part = layer(x_part, m_part)
        for layer in self.conv_rpn:
            x_rpn, m_rpn = layer(x_rpn, m_rpn)
        return torch.cat([x_rpn, x_part], dim=-1).reshape(part.shape[0], -1)

    def tower(self, merged, generator=None):
        """→ shared features, rcnn_cls, rcnn_reg; Dropout entries follow
        their modules' mode and draw from ``generator``."""
        shared = run_pointwise(self.shared_fc_layer, merged, generator=generator)
        return (shared, run_pointwise(self.cls_layers, shared, generator=generator),
                run_pointwise(self.reg_layers, shared, generator=generator))

    def forward(self, batch_dict, generator=None):
        """Eval: proposals (NMS_CONFIG.TEST) unless ``rois`` are given, the
        pooling, the convs, the towers and the decoded boxes.  Training:
        proposals (NMS_CONFIG.TRAIN), the targets sampled with ``generator``,
        or, given ``rois`` and their ``roi_targets_dict``, those;
        ``roi_targets`` then carries the targets with rcnn_cls and rcnn_reg."""
        cfg = self.model_cfg
        batch_dict, targets = rht.rois_and_targets(batch_dict, cfg, self.training, generator)
        rois = batch_dict['rois']
        b, r = rois.shape[:2]
        merged = self.convs(*self.roiaware_pool(batch_dict))
        dropouts = self._dropouts() if not self.training and generator is not None else []
        for m in dropouts:                  # only the Dropout entries go live
            m.train()
        try:
            shared, rcnn_cls, rcnn_reg = self.tower(merged, generator)
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

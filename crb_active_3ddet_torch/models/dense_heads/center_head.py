"""CenterPoint's head (torch): port of ``gaussian_radius``,
``make_center_targets``, ``gaussian_focal_loss``, ``CenterHead`` and
``get_center_loss`` from ``crb_active_3ddet_tpu/models/dense_heads/center_head.py``
(reference ``pcdet/models/dense_heads/center_head.py``,
``centernet_utils.py``), with the JAX module's behaviour:

* one head group over every class; ``FEATURE_MAP_STRIDE`` and ``MAX_OBJS``
  are read at the ``DENSE_HEAD`` level (defaults 8 and 64), and
  ``CLASS_NAMES_EACH_HEAD``, ``NUM_HM_CONV``, ``HEAD_DICT``,
  ``USE_BIAS_BEFORE_NORM`` and the head's own ``POST_PROCESSING`` are not;
* a shared 3×3 conv without bias, BatchNorm (eps 1e-3, Flax's statistics),
  ReLU, then the ``hm``, ``center``, ``center_z``, ``dim`` and ``rot``
  branches, each 3×3 conv → ReLU → 3×3 conv, both biased, no BatchNorm;
  ``hm``'s output bias starts at −2.19;
* the heatmap targets: a gaussian of the CornerNet radius (overlap 0.5,
  at least 2 cells) around each gt's integer cell, over the whole map;
  regression targets at the first ``MAX_OBJS`` gts;
* decoding: a 3×3 max-pool peak test, one top-k over (C, H, W) (ties to
  the lowest index, as ``jax.lax.top_k``), boxes at the peaks and one-hot
  pseudo-logits (logit(score) at the class, −20 elsewhere), so that the
  anchor heads' post-processing reads (score, label) back.

Module names are OpenPCDet's (``shared_conv.{0,1}``,
``heads_list.0.{branch}.0.0`` and ``.1``), so that an OpenPCDet checkpoint
maps by name.  Inputs and exported maps are channels-last (B, H, W, C), as
the JAX module's: ``center_heatmap`` (B, H, W, C), ``center_reg``
(B, H, W, 8) and ``rpn_preds`` (the heatmap logits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones_2d.base_bev_backbone import FlaxBatchNorm2d

BRANCHES = (('hm', None), ('center', 2), ('center_z', 1), ('dim', 3), ('rot', 2))
HM_BIAS = -2.19


def gaussian_radius(dx, dy, min_overlap=0.5):
    """CornerNet's radius heuristic (``centernet_utils.gaussian_radius``)."""
    a1 = 1
    b1 = dy + dx
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0))
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (dy + dx)
    c2 = (1 - min_overlap) * dx * dy
    sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0))
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dy + dx)
    c3 = (min_overlap - 1) * dx * dy
    sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def make_center_targets(gt_boxes, num_classes, grid_hw, pcr, voxel_size, stride,
                        max_objs, min_radius=2.0):
    """gt_boxes (B, M, 8), zero rows padding, the class id last → heatmap
    (B, C, H, W), inds (B, K), mask (B, K), reg_targets (B, K, 8) ([dx_off,
    dy_off, z, log l, log w, log h, sin, cos]) and cls_ind (B, K), K =
    min(M, max_objs).  A gt whose centre falls off the map draws nothing and
    is masked; its ``inds`` are clipped onto the map."""
    h, w = grid_hw
    dev = gt_boxes.device
    labels = gt_boxes[..., -1].to(torch.int64)
    valid = gt_boxes.abs().sum(-1) > 0
    pcr = gt_boxes.new_tensor(pcr[:2])
    vs = gt_boxes.new_tensor(voxel_size[:2])
    st = gt_boxes.new_tensor(float(stride))

    cx = (gt_boxes[..., 0] - pcr[0]) / vs[0] / st            # (B, M) map coords
    cy = (gt_boxes[..., 1] - pcr[1]) / vs[1] / st
    dxf = gt_boxes[..., 3] / vs[0] / st
    dyf = gt_boxes[..., 4] / vs[1] / st
    radius = torch.clamp(gaussian_radius(dyf, dxf), min=min_radius)

    # the gaussian centred on the integer cell, so that its peak is 1
    cxi, cyi = torch.floor(cx), torch.floor(cy)
    xs = torch.arange(w, device=dev, dtype=gt_boxes.dtype)
    ys = torch.arange(h, device=dev, dtype=gt_boxes.dtype)
    d2 = (xs - cxi[..., None, None]) ** 2 + (ys[:, None] - cyi[..., None, None]) ** 2
    sigma2 = (2 * radius[..., None, None] / 3) ** 2 / 2
    g = torch.exp(-d2 / torch.clamp(2 * sigma2, min=1e-6))   # (B, M, H, W)
    in_bounds = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & valid
    g = torch.where(in_bounds[..., None, None], g, torch.zeros((), device=dev))
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    heatmap = torch.stack([torch.where((labels == c + 1)[..., None, None], g, zero).amax(1)
                           for c in range(num_classes)], dim=1)

    xi = torch.clamp(torch.floor(cx).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.floor(cy).to(torch.int64), 0, h - 1)
    logs = torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-3))
    reg = torch.stack([cx - xi, cy - yi, gt_boxes[..., 2], logs[..., 0], logs[..., 1],
                       logs[..., 2], torch.sin(gt_boxes[..., 6]),
                       torch.cos(gt_boxes[..., 6])], dim=-1)
    return {'heatmap': heatmap, 'inds': (yi * w + xi)[:, :max_objs],
            'mask': in_bounds[:, :max_objs], 'reg_targets': reg[:, :max_objs],
            'cls_ind': (labels - 1)[:, :max_objs]}


def gaussian_focal_loss(pred, target, alpha=2.0, beta=4.0):
    """CenterNet's focal loss (``loss_utils.FocalLossCenterNet``) of each
    frame: pred and target (B, ...) → (B,)."""
    eps = 1e-6
    pred = torch.clamp(torch.sigmoid(pred), eps, 1 - eps)
    pos = (target >= 1.0 - 1e-4).to(pred.dtype)
    neg_weights = torch.pow(1 - target, beta)
    pos_loss = -torch.log(pred) * torch.pow(1 - pred, alpha) * pos
    neg_loss = -torch.log(1 - pred) * torch.pow(pred, alpha) * neg_weights * (1 - pos)
    dims = tuple(range(1, pred.ndim))
    num_pos = torch.clamp(pos.sum(dims), min=1.0)
    return (pos_loss.sum(dims) + neg_loss.sum(dims)) / num_pos


class SeparateHead(nn.Module):
    """The branches of one head group, each conv → ReLU → conv."""

    def __init__(self, channels, num_class):
        super().__init__()
        for name, out in BRANCHES:
            setattr(self, name, nn.Sequential(
                nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU()),
                nn.Conv2d(channels, num_class if out is None else out, 3, padding=1)))
        nn.init.constant_(self.hm[1].bias, HM_BIAS)


class CenterHead(nn.Module):
    cls_bias_init = HM_BIAS

    def __init__(self, model_cfg, input_channels, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, predict_boxes_when_training=False):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
        if voxel_size is None:
            raise ValueError('CenterHead needs the voxel size: its targets and boxes are '
                             'placed in metres from the map\'s cells')
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.predict_boxes_when_training = predict_boxes_when_training
        self.stride = int(model_cfg.get('FEATURE_MAP_STRIDE', 8))
        self.max_objs = int(model_cfg.get('MAX_OBJS', 64))
        ch = int(model_cfg.get('SHARED_CONV_CHANNEL', 64))
        self.shared_conv = nn.Sequential(
            nn.Conv2d(input_channels, ch, 3, padding=1, bias=False),
            FlaxBatchNorm2d(ch), nn.ReLU())
        self.heads_list = nn.ModuleList([SeparateHead(ch, num_class)])

    def cls_convs(self):
        return [self.heads_list[0].hm[1]]

    def box_convs(self):
        head = self.heads_list[0]
        return [getattr(head, name)[1] for name, _ in BRANCHES[1:]]

    def forward(self, batch_dict):
        x = self.shared_conv(batch_dict['spatial_features_2d'].permute(0, 3, 1, 2))
        head = self.heads_list[0]
        out = {name: getattr(head, name)(x).permute(0, 2, 3, 1) for name, _ in BRANCHES}
        batch_dict['center_heatmap'] = out['hm']                      # (B, H, W, C)
        batch_dict['center_reg'] = torch.cat(
            [out['center'], out['center_z'], out['dim'], out['rot']], dim=-1)
        b, h, w, _ = out['hm'].shape
        if self.training and 'gt_boxes' in batch_dict:
            batch_dict['center_targets'] = make_center_targets(
                batch_dict['gt_boxes'], self.num_class, (h, w), self.point_cloud_range,
                self.voxel_size, self.stride, self.max_objs)
        if not self.training or self.predict_boxes_when_training:
            batch_dict.update(self.decode(out))
        return batch_dict

    def decode(self, out):
        """Peaks of the heatmap → (B, K, C) pseudo-logits and (B, K, 7)
        boxes (``centernet_utils.decode_bbox_from_heatmap``)."""
        return {**self.boxes_at(out, *self.peaks(out['hm'])),
                'cls_preds_normalized': False, 'rpn_preds': out['hm']}

    def peaks(self, heatmap):
        """The ``max_objs`` highest peaks of the heatmap logits (B, H, W, C):
        a 3×3 max-pool peak test, then one stable sort over (C, H, W), ties
        to the lowest index as ``jax.lax.top_k``.  Returns their scores
        (B, K) and flat (C, H, W) indices (B, K)."""
        b, h, w, c = heatmap.shape
        hm = torch.sigmoid(heatmap).permute(0, 3, 1, 2)               # (B, C, H, W)
        hmax = F.max_pool2d(hm, 3, stride=1, padding=1)
        peaks = torch.where(hmax == hm, hm, torch.zeros_like(hm)).reshape(b, c * h * w)
        scores, idx = torch.sort(peaks, dim=-1, descending=True, stable=True)
        return scores[:, :self.max_objs], idx[:, :self.max_objs]

    def boxes_at(self, out, scores, idx):
        """The boxes (B, K, 7) that the maps ``out`` give at the peaks
        ``idx`` (flat (C, H, W) indices), and the peaks' one-hot
        pseudo-logits (B, K, C) from ``scores``."""
        heatmap = out['hm']
        b, h, w, _ = heatmap.shape
        cls_id = torch.div(idx, h * w, rounding_mode='floor')
        yx = idx % (h * w)
        yi = torch.div(yx, w, rounding_mode='floor').to(heatmap.dtype)
        xi = (yx % w).to(heatmap.dtype)

        def at_peaks(t):
            flat = t.reshape(b, h * w, t.shape[-1])
            return torch.gather(flat, 1, yx[..., None].expand(-1, -1, t.shape[-1]))

        ctr = at_peaks(out['center'])
        z = at_peaks(out['center_z'])[..., 0]
        dims = torch.exp(at_peaks(out['dim']))
        r = at_peaks(out['rot'])
        angle = torch.atan2(r[..., 0], r[..., 1])
        pcr, vs = self.point_cloud_range, self.voxel_size
        xs = (xi + ctr[..., 0]) * self.stride * vs[0] + pcr[0]
        ys = (yi + ctr[..., 1]) * self.stride * vs[1] + pcr[1]
        boxes = torch.stack([xs, ys, z, dims[..., 0], dims[..., 1], dims[..., 2], angle],
                            dim=-1)
        s = torch.clamp(scores, 1e-6, 1 - 1e-6)
        logits = torch.log(s / (1 - s))
        onehot = F.one_hot(cls_id, self.num_class).to(heatmap.dtype)
        cls_preds = onehot * logits[..., None] + (onehot - 1) * 20.0
        return {'batch_cls_preds': cls_preds, 'batch_box_preds': boxes}


def get_center_loss(batch_dict, loss_cfg, reduce=True):
    """The heatmap's focal loss plus the masked L1 of the regression at the
    gts' cells (``center_head.get_loss``).  Returns (loss, {term: value});
    ``reduce=False`` keeps one loss a frame."""
    t = batch_dict['center_targets']
    hm_per_sample = gaussian_focal_loss(
        batch_dict['center_heatmap'].permute(0, 3, 1, 2), t['heatmap'])
    reg = batch_dict['center_reg']
    b, h, w, n = reg.shape
    pred_at = torch.gather(reg.reshape(b, h * w, n), 1, t['inds'][..., None].expand(-1, -1, n))
    l1 = torch.abs(pred_at - t['reg_targets'])
    mask = t['mask'][..., None].to(l1.dtype)
    lw = loss_cfg['LOSS_WEIGHTS']
    code_w = l1.new_tensor(lw.get('code_weights', [1.0] * 8))
    reg_per_sample = (l1 * mask * code_w).sum((1, 2)) / torch.clamp(
        mask.sum((1, 2)) * n, min=1.0)
    per_sample = hm_per_sample * lw.get('cls_weight', 1.0) \
        + reg_per_sample * lw.get('loc_weight', 2.0)
    if reduce:
        return per_sample.mean(), {'center_hm_loss': hm_per_sample.mean(),
                                   'center_reg_loss': reg_per_sample.mean()}
    return per_sample, {'center_hm_loss': hm_per_sample, 'center_reg_loss': reg_per_sample}

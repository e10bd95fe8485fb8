"""Box coders (torch). Ports of ``ResidualCoder`` and ``PointResidualCoder`` from
``crb_active_3ddet_tpu/utils/box_coder.py`` (reference
``pcdet/utils/box_coder_utils.py:5-78``): ``decode`` for the predictions,
``encode`` for the training targets."""

from __future__ import annotations

import torch


class ResidualCoder:
    """Anchor-residual box coder."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7 + C) → (..., code_size) targets."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(boxes[..., :7], 1, dim=-1)
        dxa, dya, dza = (torch.clamp(t, min=1e-5) for t in (dxa, dya, dza))
        dxg, dyg, dzg = (torch.clamp(t, min=1e-5) for t in (dxg, dyg, dzg))

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        # extras up to code_size, not the boxes' width (gt may carry more)
        n_extra = self.code_size - (8 if self.encode_angle_by_sincos else 7)
        cts = [boxes[..., 7 + i:8 + i] - anchors[..., 7 + i:8 + i]
               for i in range(n_extra)]
        return torch.cat([xt, yt, zt, dxt, dyt, dzt, *rts, *cts], dim=-1)

    def decode(self, encodings, anchors):
        """(..., code_size) encodings + anchors → (..., 7 + C) boxes."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        if not self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, rt = torch.split(encodings[..., :7], 1,
                                                        dim=-1)
            cts = encodings[..., 7:]
        else:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.split(
                encodings[..., :8], 1, dim=-1)
            cts = encodings[..., 8:]

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = rt + ra
        extra = [cts[..., i:i + 1] + anchors[..., 7 + i:8 + i]
                 for i in range(cts.shape[-1])]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, *extra], dim=-1)


class PointResidualCoder:
    """Point-anchored box coder (JAX ``utils/box_coder.py:80``, reference
    ``box_coder_utils.py:147-200``): the point heads' 8-value code
    [dx, dy, dz, log dims, cos, sin].  With ``use_mean_size`` the offsets
    are scaled by the class's mean size, indexed ``mean_size[class − 1]``
    (class 0 wraps to the last class, as in the JAX coder)."""

    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            self.mean_size = torch.tensor(kwargs['mean_size'], dtype=torch.float32)

    def _mean(self, classes):
        return self.mean_size.to(classes.device)[classes.long() - 1].unbind(-1)

    def encode(self, gt_boxes, points, gt_classes=None):
        xg, yg, zg, dxg, dyg, dzg, rg = gt_boxes[..., :7].unbind(-1)
        dxg, dyg, dzg = (torch.clamp(d, min=1e-5) for d in (dxg, dyg, dzg))
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._mean(gt_classes)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            t = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                 torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            t = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        return torch.stack(t + [torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings[..., :8].unbind(-1)
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._mean(pred_classes)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            b = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                 torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            b = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        return torch.stack(b + [torch.atan2(sint, cost)], dim=-1)


def build_box_coder(name, **kwargs):
    return {'ResidualCoder': ResidualCoder, 'PointResidualCoder': PointResidualCoder}[name](
        **kwargs)

"""Box coder (torch). Port of ``ResidualCoder`` from
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

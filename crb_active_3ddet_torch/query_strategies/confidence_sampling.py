"""Confidence sampling. Copy of ``crb_active_3ddet_tpu/query_strategies/
confidence_sampling.py`` (reference
``pcdet/query_strategies/confidence_sampling.py`` :35-68): softmax entropy
over every anchor's confidences, mean per frame (signal
``confidence_entropy``; no NMS), the top SELECT_NUMS."""

from __future__ import annotations

from .strategy import Strategy


class ConfidenceSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        assert self.cfg.ACTIVE_TRAIN.AGGREGATION == 'mean'
        records = self.scan_pool(signals=('confidence_entropy',))
        select_dic = {fid: float(r['confidence_entropy'])
                      for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        return [fid for fid, _ in ranked[len(ranked) - n:]]

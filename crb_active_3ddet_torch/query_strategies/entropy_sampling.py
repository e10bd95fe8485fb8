"""Entropy sampling. Copy of ``crb_active_3ddet_tpu/query_strategies/
entropy_sampling.py`` (reference ``pcdet/query_strategies/entropy_sampling.py``
:33-68): per-box softmax entropy over the kept boxes' logits, mean per frame
(signal ``box_entropy``), the top SELECT_NUMS."""

from __future__ import annotations

from .strategy import Strategy


class EntropySampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        assert self.cfg.ACTIVE_TRAIN.AGGREGATION == 'mean'
        records = self.scan_pool(signals=('box_entropy',))
        select_dic = {fid: float(r['box_entropy']) for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        return [fid for fid, _ in ranked[len(ranked) - n:]]

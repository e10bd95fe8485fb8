"""BALD sampling. Copy of ``crb_active_3ddet_tpu/query_strategies/
bald_sampling.py:16 BALDSampling`` (reference ``pcdet/query_strategies/bald_sampling.py``
:22-70): one dropout-live eval pass (the MC-dropout scorer at ``num_mc=1``),
the per-box softmax entropy over the kept boxes' logits, mean per frame
(signal ``box_entropy``), the top SELECT_NUMS.  The reference leaves this
class out of its factory; the JAX package registers it, and so does the
port."""

from __future__ import annotations

from .strategy import Strategy


class BALDSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        assert self.cfg.ACTIVE_TRAIN.AGGREGATION == 'mean'
        records = self.scan_pool(mc_dropout=True, num_mc=1, signals=('box_entropy',))
        select_dic = {fid: float(r['box_entropy']) for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        return [fid for fid, _ in ranked[len(ranked) - n:]]

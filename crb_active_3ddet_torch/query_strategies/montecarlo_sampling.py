"""MC-dropout regression-uncertainty sampling. Copy of
``crb_active_3ddet_tpu/query_strategies/montecarlo_sampling.py:15
MonteCarloSampling`` (reference
``pcdet/query_strategies/montecarlo_sampling.py``: dropout live at eval
:7-14,33; frames ranked by the variance over SAMPLING_ROUND MC samples of the
scores and the boxes :52-58): the signals ``mc_cls_var`` and ``mc_box_var``
of the MC-dropout scorer, the top SELECT_NUMS.  No prediction signal, so the
scan runs no NMS."""

from __future__ import annotations

from .strategy import Strategy


class MonteCarloSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        num_mc = int(self.cfg.MODEL.get('SAMPLING_ROUND', 5))
        records = self.scan_pool(mc_dropout=True, num_mc=num_mc,
                                 signals=('mc_cls_var', 'mc_box_var'))
        select_dic = {fid: float(r['mc_cls_var']) + float(r['mc_box_var'])
                      for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        return [fid for fid, _ in ranked[len(ranked) - n:]]

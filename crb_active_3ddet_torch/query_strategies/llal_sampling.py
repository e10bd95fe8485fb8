"""Learning-loss (llal) sampling. Copy of
``crb_active_3ddet_tpu/query_strategies/llal_sampling.py`` (reference
``pcdet/query_strategies/llal_sampling.py`` :38-58): rank the pool frames by
the LossNet's predicted loss (signal ``loss_predictions``; no NMS) and take
the top SELECT_NUMS, ties in pool order as Python's stable sort leaves them.
The LossNet is fitted in the active loop (``runtime/active.py
train_loss_net``)."""

from __future__ import annotations

from .strategy import Strategy


class LLALSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        records = self.scan_pool(signals=('loss_predictions',))
        if any('loss_predictions' not in r for r in records.values()):
            raise RuntimeError(
                'llal requires a model with a LossNet (MODEL.ROI_HEAD.LOSS_NET); '
                'the current model emits no loss_predictions')
        select_dic = {fid: float(r['loss_predictions'].sum())
                      for fid, r in records.items()}
        ranked = sorted(select_dic.items(), key=lambda kv: kv[1])
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        return [fid for fid, _ in ranked[len(ranked) - n:]]

"""Random selection. Copy of ``crb_active_3ddet_tpu/query_strategies/
random_sampling.py`` (reference ``pcdet/query_strategies/random_sampling.py``:
one bookkeeping pass over the pool, then shuffle and take SELECT_NUMS)."""

from __future__ import annotations

import random

from .strategy import Strategy


class RandomSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        if len(self.bbox_records) == 0:
            self.scan_pool(signals=())  # bookkeeping only: no forward
        all_frames = [p[0] for p in self.pairs]
        random.shuffle(all_frames)
        return all_frames[:self.cfg.ACTIVE_TRAIN.SELECT_NUMS]

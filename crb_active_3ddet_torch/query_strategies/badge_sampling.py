"""BADGE sampling. Port of ``crb_active_3ddet_tpu/query_strategies/
badge_sampling.py`` (reference ``pcdet/query_strategies/badge_sampling.py``):
  pass 1 (:73-108): each pool frame's hypothetical labels, the per-anchor
    argmax of the anchor head's ``rpn_preds``, from an eval forward given a
    generator seeded ``BADGE_SEED`` (the JAX ``PRNGKey(17)``; Dropout live,
    BatchNorm in eval mode).  Only the modules the dense head reads run
    (``dense_only``): the RoI head's rounds do not reach ``rpn_preds``, and
    XLA prunes them from the JAX pass likewise.  A frame that a wrap-padded
    batch scores twice keeps its last labels;
  pass 2 (:157-168): each pool frame's eval-mode gradient at
    ``dense_head.conv_cls.weight`` of the focal cls loss against those labels
    (class indices 0..C−1 fed as box labels, so class 0 acts as background),
    from a batch-1 forward of the dense path, flattened in the Flax kernel's
    order;
  k-means++ (``kmeans_pp.py``, on float64, seed 0) over the embeddings (:196).
The embeddings and their frame ids go to ``grad_embeddings_epoch_{e}.pkl``;
a query that finds that file takes them from it and runs neither pass.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..runtime.train import host_to_device_batch, prepare_device_batch
from ..utils import common
from .crb_sampling import cls_weight_grad
from .kmeans_pp import kmeans_plusplus
from .strategy import Strategy

BADGE_SEED = 17        # the JAX pass 1's PRNGKey(17)


class BadgeSampling(Strategy):
    def query(self, leave_pbar=True, cur_epoch=None):
        emb_path = os.path.join(self.active_label_dir,
                                f'grad_embeddings_epoch_{cur_epoch}.pkl')
        if os.path.isfile(emb_path):
            with open(emb_path, 'rb') as f:
                cached = pickle.load(f)
            grad_embeddings, frame_ids = cached['embeddings'], cached['frame_ids']
        else:
            self.scan_pool(signals=())                  # bookkeeping
            hyp = self.rpn_labels()
            frame_ids = [str(fid) for fid, _ in self.pairs]
            grad_embeddings = self.grad_embeddings(frame_ids, hyp)
            self.save_active_labels(
                grad_embeddings={'embeddings': grad_embeddings, 'frame_ids': frame_ids},
                cur_epoch=cur_epoch)
        n = self.cfg.ACTIVE_TRAIN.SELECT_NUMS
        selected_idx = kmeans_plusplus(grad_embeddings.astype(np.float64), n_clusters=n,
                                       random_state=0)
        return [frame_ids[i] for i in selected_idx]

    @torch.no_grad()
    def rpn_labels(self):
        """Pass 1: {frame id: (A,) int64 argmax class index} over the pool
        loader's batches."""
        model, dataset = self.model, self.unlabelled_set
        geom = common.geometry(dataset)
        generator = torch.Generator(device=model.device).manual_seed(BADGE_SEED)
        model.eval()
        hyp = {}
        for batch in self.unlabelled_loader:
            out = model(prepare_device_batch(host_to_device_batch(batch, model.device), *geom),
                        generator, dense_only=True)
            b = out['rpn_preds'].shape[0]
            labels = out['rpn_preds'].reshape(b, -1, self.num_class).argmax(-1)
            for i, fid in enumerate(batch['frame_id']):
                hyp[str(fid)] = labels[i]
        return hyp

    def grad_embeddings(self, frame_ids, hyp):
        """Pass 2: (len(frame_ids), Cin·A·C) float32, each frame's gradient
        at ``conv_cls.weight`` against its labels in ``hyp``, from batch-1
        eval forwards of the dense path."""
        model = self.model
        model.eval()
        grads = []
        for fid, b1 in zip(frame_ids, self.single_frames(frame_ids, ('gt_boxes',))):
            with torch.no_grad():
                out = model(b1, dense_only=True)
            grads.append(cls_weight_grad(model.dense_head, out, hyp[fid][None]))
        return torch.stack(grads).cpu().numpy()

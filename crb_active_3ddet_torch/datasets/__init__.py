"""Dataset registry + loader builder.

Copy of ``build_dataloader`` from ``crb_active_3ddet_tpu/datasets/__init__.py``
(parity: ``pcdet/datasets/__init__.py`` build_dataloader :49-78) for the
datasets this slice of the port carries (SyntheticDataset).  Loaders yield
numpy fixed-shape batches; training loaders use drop_last=True.
"""

from __future__ import annotations

import random

import numpy as np
from torch.utils.data import DataLoader

from .dataset import DatasetTemplate
from .synthetic import SyntheticDataset


def _registry():
    return {
        'DatasetTemplate': DatasetTemplate,
        'SyntheticDataset': SyntheticDataset,
    }


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     root_path=None, workers=4, logger=None, training=True,
                     merge_all_iters_to_one_epoch=False, total_epochs=0,
                     seed=None):
    dataset = _registry()[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, training=training, logger=logger)
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)
    dataloader = DataLoader(
        dataset, batch_size=batch_size, num_workers=workers,
        shuffle=training, collate_fn=dataset.collate_batch,
        drop_last=training, timeout=0,
        worker_init_fn=_worker_seed_fn(seed))
    return dataset, dataloader, None


def _worker_seed_fn(seed):
    if seed is None:
        return None

    def init_fn(worker_id):
        np.random.seed(seed + worker_id)
        random.seed(seed + worker_id)
    return init_fn

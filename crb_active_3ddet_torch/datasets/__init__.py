"""Dataset registry and the functions that build the loaders.

Copy of ``build_dataloader``, ``build_active_dataloader``,
``_PaddedBatchSampler``, ``loader_batch_size`` and ``_identity_attrs`` from
``crb_active_3ddet_tpu/datasets/__init__.py`` (parity:
``pcdet/datasets/__init__.py`` build_dataloader :49-78, build_active_dataloader
:80-181) for the datasets the port carries (SyntheticDataset, KittiDataset,
WaymoDataset).  Loaders yield
numpy fixed-shape batches; training loaders use drop_last=True.  The AL
loaders instead wrap-pad the final batch to full size (every pool frame is
scored, and the labelled set is too small to drop frames), so a pool frame
can be scored twice.
"""

from __future__ import annotations

import random

import numpy as np
from torch.utils.data import DataLoader

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .synthetic import SyntheticDataset
from .waymo.waymo_dataset import WaymoDataset


def _registry():
    return {
        'DatasetTemplate': DatasetTemplate,
        'SyntheticDataset': SyntheticDataset,
        'KittiDataset': KittiDataset,
        'WaymoDataset': WaymoDataset,
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


def build_active_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                            root_path=None, workers=4, logger=None,
                            training=True, merge_all_iters_to_one_epoch=False,
                            total_epochs=0, active_training=None,
                            pre_train_sample_nums=None, seed=None):
    """Returns (labelled_set, unlabelled_set, loader_labelled,
    loader_unlabelled, sampler_labelled, sampler_unlabelled).

    ``active_training`` = (sel_ids, sel_infos, unsel_ids, unsel_infos)
    re-splits explicitly; otherwise ``random.Random(seed)`` shuffles the
    (id, info) pairs and the first ``pre_train_sample_nums`` are labelled."""
    reg = _registry()
    make = lambda train: reg[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, training=train, logger=logger)
    dataset = make(training)
    labelled_set = make(True)
    unlabelled_set = make(False)

    id_attr, info_attr = _identity_attrs(dataset)
    if active_training is not None:
        setattr(labelled_set, id_attr, list(active_training[0]))
        setattr(labelled_set, info_attr, list(active_training[1]))
        setattr(unlabelled_set, id_attr, list(active_training[2]))
        setattr(unlabelled_set, info_attr, list(active_training[3]))
    else:
        pairs = list(zip(getattr(dataset, id_attr), getattr(dataset, info_attr)))
        rng = random.Random(seed) if seed is not None else random
        rng.shuffle(pairs)
        n = int(pre_train_sample_nums)
        sel, unsel = pairs[:n], pairs[n:]
        setattr(labelled_set, id_attr, [p[0] for p in sel])
        setattr(labelled_set, info_attr, [p[1] for p in sel])
        setattr(unlabelled_set, id_attr, [p[0] for p in unsel])
        setattr(unlabelled_set, info_attr, [p[1] for p in unsel])

    if merge_all_iters_to_one_epoch:
        labelled_set.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)
        unlabelled_set.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)

    loader_labelled = DataLoader(
        labelled_set, num_workers=workers,
        batch_sampler=_PaddedBatchSampler(labelled_set, batch_size,
                                          shuffle=training, seed=seed),
        collate_fn=labelled_set.collate_batch, timeout=0,
        worker_init_fn=_worker_seed_fn(seed))
    loader_unlabelled = DataLoader(
        unlabelled_set, num_workers=workers,
        batch_sampler=_PaddedBatchSampler(unlabelled_set, batch_size,
                                          shuffle=False, seed=seed),
        collate_fn=unlabelled_set.collate_batch, timeout=0,
        worker_init_fn=_worker_seed_fn(seed))
    return (labelled_set, unlabelled_set, loader_labelled, loader_unlabelled,
            None, None)


class _PaddedBatchSampler:
    """Yields full fixed-size batches; the final ragged batch is wrap-padded
    with indices from the start of the (shuffled) order.  Reads
    len(dataset) afresh each epoch."""

    def __init__(self, dataset, batch_size, shuffle, seed=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = random.Random(seed)

    def __iter__(self):
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, n, bs):
            batch = order[i:i + bs]
            if len(batch) < bs:
                batch = batch + order[:bs - len(batch)]
                if len(batch) < bs:  # dataset smaller than one batch
                    batch = (batch * bs)[:bs]
            yield batch

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)


def loader_batch_size(loader):
    """Batch size of a DataLoader with either kind of sampler (DataLoader
    reports None when a batch_sampler is used)."""
    bs = getattr(loader, 'batch_size', None)
    if bs is None:
        bs = getattr(getattr(loader, 'batch_sampler', None), 'batch_size', None)
    return bs


def _identity_attrs(dataset):
    """KITTI-style datasets key frames by sample_id_list + kitti_infos
    (or infos); Waymo-style by frame_ids + infos."""
    if hasattr(dataset, 'sample_id_list'):
        info_attr = 'kitti_infos' if hasattr(dataset, 'kitti_infos') else 'infos'
        return 'sample_id_list', info_attr
    return 'frame_ids', 'infos'


def _worker_seed_fn(seed):
    if seed is None:
        return None

    def init_fn(worker_id):
        np.random.seed(seed + worker_id)
        random.seed(seed + worker_id)
    return init_fn

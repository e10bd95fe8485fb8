"""Inference demo of the port over a folder of point clouds.

Counterpart of the JAX package's ``tools/demo.py`` (reference
``tools/demo.py:23-60``): run a port checkpoint over a folder of ``.bin``
(float32 x, y, z, intensity rows) or ``.npy`` scenes, or over the config's
synthetic test scenes (``--synthetic``, or no ``--data_path``), print each
frame's detections and save them to a ``.pkl`` with ``--out``.  ``--vis``
(the JAX demo's BEV, HTML and open3d views, ``tools/visual_utils``) is not
ported: it raises, naming ROADMAP Queue 1 item 15.

    python -m crb_active_3ddet_torch.tools.demo --cfg_file <yaml> --ckpt <pth> \\
        --data_path <dir> [--ext .npy] [--out dets.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import pickle
from pathlib import Path

import numpy as np
from torch.utils.data import DataLoader

from ..config import load_config
from ..datasets import build_dataloader
from ..datasets.dataset import DatasetTemplate
from ..models.detectors import build_detector
from ..runtime import eval as eval_rt
from ..runtime import train as train_rt
from ..utils import common as common_utils
from . import common


class DemoDataset(DatasetTemplate):
    """A folder of ``.bin`` / ``.npy`` scenes (parity: ``demo.py
    DemoDataset``), test-mode processing, no ground truth."""

    def __init__(self, dataset_cfg, class_names, root_path, ext='.bin'):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=False, root_path=root_path)
        self.ext = ext
        self.sample_file_list = sorted(glob.glob(str(Path(root_path) / f'*{ext}')))

    def __len__(self):
        return len(self.sample_file_list)

    def __getitem__(self, index):
        fn = self.sample_file_list[index]
        if self.ext == '.bin':
            points = np.fromfile(fn, dtype=np.float32).reshape(-1, 4)
        elif self.ext == '.npy':
            points = np.load(fn)
        else:
            raise NotImplementedError(self.ext)
        return self.prepare_data({'points': points, 'frame_id': Path(fn).stem})


def main(argv=None):
    """Returns the detections: a list of {frame_id, boxes, scores, labels}."""
    parser = argparse.ArgumentParser(description='detections of a port checkpoint')
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--ckpt', type=str, required=True)
    parser.add_argument('--data_path', type=str, default=None,
                        help='folder of .bin/.npy clouds; omit for synthetic scenes')
    parser.add_argument('--synthetic', action='store_true', default=False,
                        help="the config's synthetic test scenes")
    parser.add_argument('--ext', type=str, default='.bin')
    parser.add_argument('--out', type=str, default=None)
    parser.add_argument('--vis', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default; raises without a card) or 'cpu'")
    args = parser.parse_args(argv)
    if args.vis:
        raise NotImplementedError('--vis (tools/visual_utils) is not ported; it comes '
                                  'with ROADMAP Queue 1 item 15')
    device = common_utils.resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    logger = common_utils.create_logger(None, rank=0)

    if args.data_path and not args.synthetic:
        demo_set = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root_path=args.data_path,
                               ext=args.ext)
        loader = DataLoader(demo_set, batch_size=1, num_workers=0, shuffle=False,
                            collate_fn=demo_set.collate_batch)
    else:
        demo_set, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                               batch_size=1, training=False, workers=0)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), demo_set, device=device)
    common.load_port_checkpoint(model, args.ckpt)
    eval_step = eval_rt.make_eval_step(model, demo_set, cfg.MODEL.POST_PROCESSING,
                                       num_class=len(cfg.CLASS_NAMES))
    results = []
    for batch in loader:
        preds, _ = eval_step(train_rt.host_to_device_batch(batch, device))
        preds = {k: v.cpu().numpy() for k, v in preds.items()}
        for i in range(batch['batch_size']):
            valid = preds['pred_valid'][i]
            det = {'frame_id': batch['frame_id'][i],
                   'boxes': preds['pred_boxes'][i][valid],
                   'scores': preds['pred_scores'][i][valid],
                   'labels': [cfg.CLASS_NAMES[label - 1]
                              for label in preds['pred_labels'][i][valid]]}
            results.append(det)
            logger.info('%s: %d detections %s', det['frame_id'], len(det['boxes']),
                        [(n, round(float(s), 2)) for n, s in zip(det['labels'], det['scores'])])
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
        logger.info('saved %d frames to %s', len(results), args.out)
    return results


if __name__ == '__main__':
    main()

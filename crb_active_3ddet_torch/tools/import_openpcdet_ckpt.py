"""Import an OpenPCDet ``.pth`` checkpoint into a port checkpoint.

Counterpart of the JAX package's ``tools/import_torch_ckpt.py``: build the
config's model (the JAX model's initialisation, ``flax_init`` seed 0, for
what the file lacks), load the file's weights through
``utils/openpcdet_ckpt.py`` (spconv layouts, the RoI head's shared-FC
permutation; ``torch.load(weights_only=True)``), print the report and write
a port checkpoint (``runtime/checkpoint.py``: ``model_state``,
``batch_stats``, no optimizer state) that ``tools/test.py --ckpt`` and
``tools/demo.py --ckpt`` read.

    python -m crb_active_3ddet_torch.tools.import_openpcdet_ckpt \\
        --cfg_file tools/cfgs/kitti_models/pv_rcnn.yaml --ckpt pv_rcnn_8369.pth \\
        --out output/pv_rcnn_imported [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..config import cfg_from_list, load_config
from ..datasets import build_dataloader
from ..models.detectors import build_detector, flax_init
from ..runtime import checkpoint as ckpt_rt
from ..utils.common import resolve_device
from ..utils.openpcdet_ckpt import check_family, import_openpcdet_checkpoint


def main(argv=None):
    """Returns the written checkpoint's path (``<out>.pth``)."""
    ap = argparse.ArgumentParser(description='OpenPCDet .pth → port checkpoint')
    ap.add_argument('--cfg_file', required=True)
    ap.add_argument('--ckpt', required=True, help='OpenPCDet .pth file')
    ap.add_argument('--out', required=True, help='output path without the .pth suffix')
    ap.add_argument('--batch_size', type=int, default=1)
    ap.add_argument('--device', type=str, default='cuda',
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    check_family(cfg.MODEL)
    dataset, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.batch_size,
                                     training=False, workers=0)
    model = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device='cpu')
    flax_init(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    report, meta = import_openpcdet_checkpoint(args.ckpt, model)

    print(f'==> mapped {len(report["mapped"])} tensors from {args.ckpt}')
    for name, src, tgt in report['mismatched']:
        print(f'    shape mismatch (skipped): {name} src={src} tgt={tgt}')
    for name in report['unmatched_target']:
        print(f'    not updated (kept init): {name}')
    for name in report['unused_source']:
        print(f'    not used: {name}')
    params = dict(model.named_parameters())
    out = {'epoch': meta.get('epoch', 0), 'it': meta.get('it', 0),
           'version': f'imported+{meta.get("version", "unknown")}',
           'model_state': {k: v.detach().cpu().clone() for k, v in params.items()},
           'batch_stats': {k: v.detach().cpu().clone()
                           for k, v in model.state_dict().items() if k not in params},
           'optimizer_state': None}
    fn = ckpt_rt.save_checkpoint(out, args.out)
    print(f'==> wrote {fn}')
    return fn


if __name__ == '__main__':
    main()

"""The port's command-line entry points, run as modules from the repo root:

    python -m crb_active_3ddet_torch.tools.train --cfg_file <yaml> [--device cpu]
    python -m crb_active_3ddet_torch.tools.test --cfg_file <yaml> --ckpt <pth>
    python -m crb_active_3ddet_torch.tools.import_openpcdet_ckpt --cfg_file <yaml> \\
        --ckpt <openpcdet.pth> --out <name>
    python -m crb_active_3ddet_torch.tools.demo --cfg_file <yaml> --ckpt <pth> --synthetic

Each has ``main(argv=None)``, so that a program can call it in-process, and
runs on the card unless given ``--device cpu``.
"""

"""CLI entry point of the port:

    python -m hashnerf_torch.run_nerf --config configs/synthetic_smoke.txt [--device cpu]

Counterpart of run_nerf.py's `main` for the slice the port has: parse the
flags (raising for any flag that selects something not yet ported), build
the scene, name the experiment, dump its args and run the training loop.
Runs on CUDA unless --device names another device.
"""
from __future__ import annotations

import os


def main(argv=None):
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.train.config import check_supported, create_expname, parse_args
    from hashnerf_torch.train.driver import train_loop
    from hashnerf_torch.utils.io import dump_args

    args = parse_args(argv)
    check_supported(args)
    scene = load_scene(args.dataset_type, args.datadir, args)
    args.expname = create_expname(args)
    savepath = os.path.join(args.basedir, args.expname)
    os.makedirs(savepath, exist_ok=True)
    dump_args(savepath, vars(args), args.config)
    return train_loop(args, scene, device=args.device)


if __name__ == "__main__":
    main()

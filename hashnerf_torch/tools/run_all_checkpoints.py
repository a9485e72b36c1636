"""Re-render every checkpoint of an experiment (a convergence sequence).

Counterpart of hashnerf_tpu/tools/run_all_checkpoints.py: the port's
parse_args / create_expname name the experiment, and each `.ckpt` under
basedir/expname, in order, is rendered by
hashnerf_torch.run_nerf.main(argv + ["--render_only", "--ft_path", ckpt]),
into its renderonly_{test|path}_{step:06d}/ directory; tools/make_gif.py
stitches their first frames. Runs on the card unless --device names another.

    python -m hashnerf_torch.tools.run_all_checkpoints --config CFG [run_nerf flags]
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Returns the checkpoints rendered, in order; raises
    FileNotFoundError when the experiment has none."""
    from hashnerf_torch import run_nerf
    from hashnerf_torch.train.config import create_expname, parse_args

    base = list(argv) if argv is not None else sys.argv[1:]
    args = parse_args(base)
    savedir = os.path.join(args.basedir, create_expname(args))
    ckpts = sorted(f for f in os.listdir(savedir) if f.endswith(".ckpt")) \
        if os.path.isdir(savedir) else []
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {savedir}")
    done = []
    for ck in ckpts:
        path = os.path.join(savedir, ck)
        print(f"=== rendering {ck} ===", flush=True)
        run_nerf.main(base + ["--render_only", "--ft_path", path])
        done.append(path)
    return done


if __name__ == "__main__":
    main()

"""Run artifacts: experiment args and loss history (counterpart of the
dump_args / save_loss_history / save_psnr_pickle parts of
hashnerf_tpu/utils/io.py; figures and videos are ROADMAP A3/A9)."""
from __future__ import annotations

import os
import pickle
import shutil
from typing import Optional, Sequence


def dump_args(savepath: str, args_dict: dict, config_path: Optional[str] = None) -> None:
    os.makedirs(savepath, exist_ok=True)
    with open(os.path.join(savepath, "args.txt"), "w") as f:
        for k in sorted(args_dict):
            f.write("{} = {}\n".format(k, args_dict[k]))
    if config_path is not None and os.path.exists(config_path):
        shutil.copyfile(config_path, os.path.join(savepath, "config.txt"))


def save_loss_history(savepath: str, losses, psnrs, times) -> None:
    with open(os.path.join(savepath, "loss_vs_time.pkl"), "wb") as fp:
        pickle.dump({"losses": losses, "psnr": psnrs, "time": times}, fp)


def save_psnr_pickle(savedir: str, psnrs: Sequence[float]) -> None:
    os.makedirs(savedir, exist_ok=True)
    avg = sum(psnrs) / len(psnrs)
    with open(os.path.join(savedir, "test_psnrs_avg{:0.2f}.pkl".format(avg)), "wb") as fp:
        pickle.dump(list(psnrs), fp)

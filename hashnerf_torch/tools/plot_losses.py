"""Plot the loss and PSNR curves of a run's loss_vs_time.pkl.

Counterpart of hashnerf_tpu/tools/plot_losses.py: loss (log scale), PSNR,
and PSNR against wall seconds, side by side, from the pickle train_loop
writes (utils/io.py::save_loss_history). A host plot: it needs matplotlib,
imported when it draws.

    python -m hashnerf_torch.tools.plot_losses LOGDIR OUT.png
"""
from __future__ import annotations

import argparse
import os
import pickle


def plot_losses(logdir: str, out: str) -> str:
    """Write the figure to out; returns out."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(os.path.join(logdir, "loss_vs_time.pkl"), "rb") as f:
        hist = pickle.load(f)

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(hist["losses"])
    axes[0].set_title("loss")
    axes[0].set_yscale("log")
    axes[1].plot(hist["psnr"])
    axes[1].set_title("PSNR (dB)")
    axes[2].plot(hist["time"], hist["psnr"])
    axes[2].set_title("PSNR vs wall-time (s)")
    for ax in axes:
        ax.grid(True, alpha=0.3)
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir")
    ap.add_argument("out", help="the PNG to write")
    o = ap.parse_args()
    print(plot_losses(o.logdir, o.out))

"""Checkpoint save/restore of {global_step, model state, optimizer state}.

Counterpart of hashnerf_tpu/train/checkpoint.py in the port's own format:
one `torch.save` file per step, `{iter:06d}.ckpt`, holding the state_dicts
of the NGPState module and the RAdam optimizer and the name of the table
layout. A checkpoint of the other layout is refused before anything is
loaded. Loading uses `weights_only=True`. Reading the JAX msgpack
checkpoints is ROADMAP A4.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

# Table layouts: the per-corner (L, 2^T, F) table, and the packed {dense, fine}.
LAYOUTS = {
    False: "hash (per-corner (L, 2^T, F) table)",
    True: "packed ({dense, fine} tables)",
}


def _layout(state) -> str:
    return LAYOUTS[state.cfg.packed_layout]


def save_checkpoint(path: str, global_step: int, state, optimizer) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "global_step": int(global_step),
        "layout": _layout(state),
        "state": state.state_dict(),
        "opt_state": optimizer.state_dict(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state, optimizer) -> int:
    """Load into `state` and `optimizer` in place; returns global_step.
    Raises ValueError, loading nothing, for a checkpoint of the other table
    layout."""
    dev = next(state.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    # checkpoints written before the packed layout was ported name no layout
    layout = payload.get("layout", LAYOUTS[False])
    if layout != _layout(state):
        raise ValueError(
            f"{path}: the checkpoint holds the {layout} layout, the model uses the "
            f"{_layout(state)} layout"
        )
    state.load_state_dict(payload["state"])
    optimizer.load_state_dict(payload["opt_state"])
    return int(payload["global_step"])


def latest_checkpoint(savedir: str, ft_path: Optional[str] = None) -> Optional[str]:
    """The pinned ft_path, else the last `.ckpt` in savedir, else None."""
    if ft_path is not None and ft_path != "None":
        return ft_path
    if not os.path.isdir(savedir):
        return None
    ckpts = sorted(f for f in os.listdir(savedir) if f.endswith(".ckpt"))
    return os.path.join(savedir, ckpts[-1]) if ckpts else None

"""Checkpoint save/restore of {global_step, model state, optimizer state}.

Counterpart of hashnerf_tpu/train/checkpoint.py. The port writes its own
format: one `torch.save` file per step, `{iter:06d}.ckpt`, holding the
state_dicts of the NGPState module and the RAdam optimizer and the name of
the table layout; loading uses `weights_only=True`. It also reads the JAX
package's checkpoints, under the same names: a pickle of builtins holding
`global_step`, and the parameters and the optax state as flax msgpack bytes
(utils/msgpack.py). `load_checkpoint` tells the two apart by content (a
torch.save file is a zip archive). A checkpoint of the other table layout
(a JAX checkpoint: of any other part or shape) is refused before anything
is loaded.
"""
from __future__ import annotations

import os
import pickle
import zipfile
from typing import Optional

import numpy as np
import torch

from hashnerf_torch.convert import jax_pairs
from hashnerf_torch.utils.msgpack import msgpack_restore

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
    """Load a checkpoint of either format into `state` and `optimizer` in
    place; returns global_step. Raises ValueError, loading nothing, for a
    checkpoint of the other table layout (a JAX checkpoint: of any other
    part or shape)."""
    if not zipfile.is_zipfile(path):
        return load_jax_checkpoint(path, state, optimizer)
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


class _BuiltinsOnly(pickle.Unpickler):
    """The JAX checkpoint's pickle holds dicts, lists, bytes, ints and None
    only: any class it names is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"refers to {module}.{name}")


def _read_jax_payload(path: str) -> dict:
    """The outer pickle of a JAX checkpoint; ValueError if it is none."""
    with open(path, "rb") as f:
        try:
            payload = _BuiltinsOnly(f).load()
        except (pickle.UnpicklingError, EOFError, ValueError) as e:
            raise ValueError(f"{path}: neither a port nor a JAX checkpoint ({e})") from None
    if not (isinstance(payload, dict) and isinstance(payload.get("state"), bytes)
            and isinstance(payload.get("opt_state"), bytes)):
        raise ValueError(f"{path}: a pickle without the JAX checkpoint's state bytes")
    return payload


def _lists(tree):
    """flax writes a list as a dict keyed "0", "1", ...: back to lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out


def _group(opt: dict, name: str, path: str) -> dict:
    try:
        return opt["inner_states"][name]["inner_state"]
    except (KeyError, TypeError):
        raise ValueError(f"{path}: the optimizer state has no RAdam group {name!r} "
                         "(inner_states/{name}/inner_state)") from None


@torch.no_grad()
def load_jax_checkpoint(path: str, state, optimizer) -> int:
    """Load a checkpoint of the JAX package into `state` and the port's
    RAdam `optimizer` in place; returns global_step.

    Parameters as convert.load_jax_state takes them; RAdam's mu and nu per
    leaf, transposed as the parameters are; the step count of each group
    (the hash tables' "embed", the MLPs' "net") into each of its
    parameters' step tensors. Every part and shape is checked before
    anything is loaded (ValueError)."""
    payload = _read_jax_payload(path)
    params = _lists(msgpack_restore(payload["state"]))
    opt = _lists(msgpack_restore(payload["opt_state"]))
    embed, net = _group(opt, "embed", path), _group(opt, "net", path)
    try:
        p_pairs = jax_pairs(state, params["hash_table"], params["coarse"], params.get("fine"))
        moments = [jax_pairs(state, embed[m]["hash_table"], net[m]["coarse"], net[m].get("fine"))
                   for m in ("mu", "nu")]
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: not the layout of the JAX NGPState ({e!r})") from None
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    tables = {id(p) for p in state.table_parameters()}
    steps = {}
    for name, group in (("embed", embed), ("net", net)):
        step = np.asarray(group["step"])
        if step.shape != ():
            raise ValueError(f"{path}: the {name} step count has shape {step.shape}")
        steps[name] = float(step)

    for param, a in p_pairs:
        param.copy_(torch.from_numpy(a))
    optimizer.init_state()
    for (param, mu), (_, nu) in zip(*moments):
        st = optimizer.state[param]
        st["exp_avg"].copy_(torch.from_numpy(mu))
        st["exp_avg_sq"].copy_(torch.from_numpy(nu))
        st["step"].fill_(steps["embed" if id(param) in tables else "net"])
    return int(payload["global_step"])


def latest_checkpoint(savedir: str, ft_path: Optional[str] = None) -> Optional[str]:
    """The pinned ft_path, else the last `.ckpt` in savedir, else None."""
    if ft_path is not None and ft_path != "None":
        return ft_path
    if not os.path.isdir(savedir):
        return None
    ckpts = sorted(f for f in os.listdir(savedir) if f.endswith(".ckpt"))
    return os.path.join(savedir, ckpts[-1]) if ckpts else None

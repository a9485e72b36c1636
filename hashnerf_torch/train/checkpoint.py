"""Checkpoint save/restore of {global_step, model state, optimizer state}.

Counterpart of hashnerf_tpu/train/checkpoint.py. The port writes its own
format: one `torch.save` file per step, `{iter:06d}.ckpt`, holding the
state_dicts of the NGPState module and the optimizer (RAdam under the hash
grid, else Adam) and the name of the table layout; loading uses
`weights_only=True`. It also reads the JAX
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

# Table layouts: the per-corner (L, 2^T, F) table, the packed {dense, fine},
# and none (the NeRF family).
LAYOUTS = {
    False: "hash (per-corner (L, 2^T, F) table)",
    True: "packed ({dense, fine} tables)",
    None: "no table (NeRF-family MLPs)",
}


def _layout(state) -> str:
    return LAYOUTS[None if state.hash_table is None else state.cfg.packed_layout]


# Where each parameter of a multi-device run lived (`placement`):
# replicated on every rank, split into 1/N flat chunks over the data axis
# (ZeRO-1), or its levels split over the model axis (the table-sharded
# trainer). The file holds every parameter whole either way, so any layout
# restores it (parallel/checkpoint.py).
PLACEMENTS = ("replicated", "data", "model")


def save_checkpoint(path: str, global_step: int, state, optimizer,
                    placement: Optional[dict] = None) -> None:
    """Write {global_step, layout, state, opt_state} to path (through a
    temporary file); placement, {parameter name: one of PLACEMENTS}, is
    recorded for a multi-device run."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "global_step": int(global_step),
        "layout": _layout(state),
        "state": state.state_dict(),
        "opt_state": optimizer.state_dict(),
    }
    if placement is not None:
        bad = set(placement.values()) - set(PLACEMENTS)
        if bad:
            raise ValueError(f"unknown placements {sorted(bad)} (want {PLACEMENTS})")
        payload["placement"] = dict(placement)
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


def _chunk_of(t: torch.Tensor, n: int, r: int) -> torch.Tensor:
    flat = t.reshape(-1)
    c = -(-flat.numel() // n)
    return torch.nn.functional.pad(flat, (0, n * c - flat.numel()))[r * c:(r + 1) * c]


@torch.no_grad()
def gather_placed(layout, pairs) -> None:
    """Fill each whole (template) tensor from its live part on this rank's
    layout: pairs of (whole, live, placement). Every rank calls it (the
    gathers are collectives)."""
    from hashnerf_torch.parallel.mesh import all_gather

    for whole, live, kind in pairs:
        if kind == "replicated":
            whole.copy_(live)
            continue
        n, group = ((layout.n_data, layout.data_group) if kind == "data"
                    else (layout.n_model, layout.model_group))
        if n == 1:
            parts = live
        else:
            parts = torch.empty((n * live.shape[0],) + tuple(live.shape[1:]), dtype=live.dtype,
                                device=live.device)
            all_gather(parts, live.contiguous(), group)
        if kind == "data":
            whole.copy_(parts.reshape(-1)[:whole.numel()].view(whole.shape))
        else:
            whole.copy_(parts)


@torch.no_grad()
def place_loaded(layout, pairs) -> None:
    """The inverse: each live tensor takes its part of the whole one."""
    for whole, live, kind in pairs:
        if kind == "replicated":
            live.copy_(whole)
        elif kind == "data":
            live.copy_(_chunk_of(whole, layout.n_data, layout.data_index))
        else:
            per = live.shape[0]
            live.copy_(whole[layout.model_index * per:(layout.model_index + 1) * per])


def save_sharded(path: str, global_step: int, layout, state, optimizer, pairs_of,
                 placement: dict) -> None:
    """A sharded run's checkpoint: its live parts gathered into the whole
    `state` and `optimizer` (gather_placed of pairs_of(state, optimizer)),
    written by rank 0 with their placement; every rank calls it and
    returns once the file is there."""
    import torch.distributed as dist

    gather_placed(layout, pairs_of(state, optimizer))
    if layout.rank == 0:
        save_checkpoint(path, global_step, state, optimizer, placement=placement)
    dist.barrier()


def restore_sharded(path: str, layout, state, optimizer, pairs_of) -> int:
    """Load a checkpoint of either format (written by any layout, or by one
    process) into the whole `state` and `optimizer`, and place it onto this
    rank's live parts (pairs_of(state, optimizer), taken after the load:
    loading replaces the optimizer's state tensors); returns global_step."""
    step = load_checkpoint(path, state, optimizer)
    place_loaded(layout, pairs_of(state, optimizer))
    return step


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


def _adam_state(opt, path: str) -> dict:
    """optax.adam's state, a chain of (scale_by_adam: count, mu, nu) and
    (the schedule's count): the first."""
    try:
        adam = opt[0]
        adam["mu"], adam["nu"], adam["count"]
    except (KeyError, TypeError, IndexError):
        raise ValueError(f"{path}: the optimizer state is not optax.adam's "
                         "([{count, mu, nu}, {count}])") from None
    return adam


@torch.no_grad()
def load_jax_checkpoint(path: str, state, optimizer) -> int:
    """Load a checkpoint of the JAX package into `state` and the port's
    optimizer in place; returns global_step.

    Parameters as convert.load_jax_state takes them; the moments mu and nu
    per leaf, transposed as the parameters are; under the hash grid
    (RAdam) the step count of each group (the hash tables' "embed", the
    MLPs' "net") into each of its parameters' step tensors, else (Adam)
    the one count into every parameter's. Every part and shape is checked
    before anything is loaded (ValueError)."""
    payload = _read_jax_payload(path)
    params = _lists(msgpack_restore(payload["state"]))
    opt = _lists(msgpack_restore(payload["opt_state"]))
    if state.hash_table is None:
        adam = _adam_state(opt, path)
        counts = {"net": adam["count"]}
        moment = lambda m: (None, adam[m]["coarse"], adam[m].get("fine"))
    else:
        embed, net = _group(opt, "embed", path), _group(opt, "net", path)
        counts = {"embed": embed["step"], "net": net["step"]}
        moment = lambda m: (embed[m]["hash_table"], net[m]["coarse"], net[m].get("fine"))
    try:
        p_pairs = jax_pairs(state, params.get("hash_table"), params["coarse"], params.get("fine"))
        moments = [jax_pairs(state, *moment(m)) for m in ("mu", "nu")]
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"{path}: not the layout of the JAX NGPState ({e!r})") from None
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    tables = {id(p) for p in state.table_parameters()}
    steps = {}
    for name, count in counts.items():
        step = np.asarray(count)
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


def latest_checkpoint(savedir: Optional[str], ft_path: Optional[str] = None) -> Optional[str]:
    """The pinned ft_path, else the last `.ckpt` in savedir, else None."""
    if ft_path is not None and ft_path != "None":
        return ft_path
    if savedir is None or not os.path.isdir(savedir):
        return None
    ckpts = sorted(f for f in os.listdir(savedir) if f.endswith(".ckpt"))
    return os.path.join(savedir, ckpts[-1]) if ckpts else None

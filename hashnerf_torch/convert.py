"""Convert JAX parameters (as numpy arrays) into the port's NGPState.

The JAX state is an NGPState(hash_table, coarse, fine) pytree whose MLPs
are {"sigma_net": [{"w": (in, out)}, ...], "color_net": [...]}. Each (in, out)
matrix is transposed into nn.Linear.weight (out, in); the hash table
(L, 2^T, F), or the packed layout's {"dense", "fine"} dict, is copied as it
is. `fine` is None under share_fine. Takes plain numpy (np.asarray of each
leaf), so this module needs no JAX. Every shape is checked before anything
is copied.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from hashnerf_torch.models.factory import NGPState


def _mlp_pairs(module, params, what: str) -> List[Tuple[torch.nn.Parameter, np.ndarray]]:
    pairs = []
    for name in ("sigma_net", "color_net"):
        layers = getattr(module, name)
        if len(layers) != len(params[name]):
            raise ValueError(f"{what}.{name}: {len(layers)} layers, JAX params have "
                             f"{len(params[name])}")
        for layer, p in zip(layers, params[name]):
            w = np.asarray(p["w"], dtype=np.float32).T
            if tuple(layer.weight.shape) != w.shape:
                raise ValueError(f"{what}.{name}: weight {tuple(layer.weight.shape)} vs JAX {w.shape}")
            pairs.append((layer.weight, np.ascontiguousarray(w)))
    return pairs


@torch.no_grad()
def _load_mlp(module, params) -> None:
    """Copy one JAX MLP's weights into a NeRFSmall in place."""
    for param, a in _mlp_pairs(module, params, "mlp"):
        param.copy_(torch.from_numpy(a))


def jax_pairs(state: NGPState, hash_table, coarse, fine=None
              ) -> List[Tuple[torch.nn.Parameter, np.ndarray]]:
    """Each parameter of `state` with the JAX array it takes (transposed to
    the port's layout), in the order of state.table_parameters() then
    state.net_parameters(). Raises ValueError if any part or shape differs."""
    if (fine is None) != (state.fine is None):
        raise ValueError("the JAX state and the port state disagree on a fine network")
    if isinstance(hash_table, dict) != state.cfg.packed_layout:
        raise ValueError("the JAX state and the port state disagree on the packed layout")
    jax_tables = hash_table if isinstance(hash_table, dict) else {"": hash_table}
    port_tables = dict(state.hash_table) if state.cfg.packed_layout else {"": state.hash_table}
    if set(jax_tables) != set(port_tables):
        raise ValueError(f"hash_table parts {sorted(port_tables)} vs JAX {sorted(jax_tables)}")
    pairs = []
    for k, param in port_tables.items():
        if tuple(param.shape) != np.shape(jax_tables[k]):
            raise ValueError(f"hash_table {k} {tuple(param.shape)} vs JAX {np.shape(jax_tables[k])}")
        pairs.append((param, np.asarray(jax_tables[k], dtype=np.float32)))
    pairs += _mlp_pairs(state.coarse, coarse, "coarse")
    if fine is not None:
        pairs += _mlp_pairs(state.fine, fine, "fine")
    return pairs


@torch.no_grad()
def load_jax_state(state: NGPState, hash_table, coarse, fine=None) -> NGPState:
    """Copy JAX parameters (numpy leaves) into `state` in place."""
    for param, a in jax_pairs(state, hash_table, coarse, fine):
        param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return state

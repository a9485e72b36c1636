"""Convert JAX parameters (as numpy arrays) into the port's NGPState.

The JAX state is an NGPState(hash_table, coarse, fine) pytree whose MLPs
are {"sigma_net": [{"w": (in, out)}, ...], "color_net": [...]}. Each (in, out)
matrix is transposed into nn.Linear.weight (out, in); the hash table
(L, 2^T, F) is copied as it is. Takes plain numpy (np.asarray of each leaf),
so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from hashnerf_torch.models.factory import NGPState


def _load_mlp(module, params) -> None:
    for name in ("sigma_net", "color_net"):
        layers = getattr(module, name)
        if len(layers) != len(params[name]):
            raise ValueError(f"{name}: {len(layers)} layers, JAX params have {len(params[name])}")
        for layer, p in zip(layers, params[name]):
            w = np.asarray(p["w"], dtype=np.float32).T
            if tuple(layer.weight.shape) != w.shape:
                raise ValueError(f"{name}: weight {tuple(layer.weight.shape)} vs JAX {w.shape}")
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))


@torch.no_grad()
def load_jax_state(state: NGPState, hash_table, coarse, fine=None) -> NGPState:
    """Copy JAX parameters (numpy leaves) into `state` in place."""
    table = np.array(hash_table, dtype=np.float32)  # a writable copy
    if tuple(state.hash_table.shape) != table.shape:
        raise ValueError(f"hash_table {tuple(state.hash_table.shape)} vs JAX {table.shape}")
    state.hash_table.copy_(torch.from_numpy(table))
    _load_mlp(state.coarse, coarse)
    if (fine is None) != (state.fine is None):
        raise ValueError("the JAX state and the port state disagree on a fine network")
    if fine is not None:
        _load_mlp(state.fine, fine)
    return state

"""Teschner spatial hashing, bit-identical to hashnerf_tpu/ops/hashing.py.

The JAX version works in uint32. Torch has no full uint32 arithmetic, so
this one works in int64: each product is masked to its low 32 bits before
the XOR. Multiplication modulo 2^32 and XOR only depend on low bits, so the
result equals the uint32 version bit for bit (even for negative coordinates,
whose two's-complement low bits are what a uint32 cast keeps).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Same primes as Teschner et al. 2003.
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)

# Corner offsets of a voxel, bit order (i, j, k) = (n>>2, (n>>1)&1, n&1).
BOX_OFFSETS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], dtype=np.int32
)

_LOW32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def box_offsets(device: torch.device) -> torch.Tensor:
    """BOX_OFFSETS as an (8, 3) int32 tensor on `device`, copied there once:
    a CUDA graph cannot hold the host-to-device copy that converting the
    numpy array at every call would make."""
    return torch.as_tensor(BOX_OFFSETS, device=device)


def spatial_hash(coords: torch.Tensor, log2_hashmap_size: int) -> torch.Tensor:
    """Hash integer grid coordinates (..., d), d <= 7, to int64 table
    indices in [0, 2**log2_hashmap_size)."""
    d = coords.shape[-1]
    if d > len(HASH_PRIMES):
        raise ValueError(f"spatial_hash supports up to {len(HASH_PRIMES)} dims, got {d}")
    c = coords.to(torch.int64)
    acc = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for i in range(d):
        acc = acc ^ ((c[..., i] * (HASH_PRIMES[i] & _LOW32)) & _LOW32)
    return acc & ((1 << log2_hashmap_size) - 1)

"""Multiresolution hash-grid encoding (Instant-NGP), plain PyTorch.

Counterpart of hashnerf_tpu/ops/hash_encoding.py. The table is one
(L, 2^T, F) tensor. `hash_encode` here is the plain tensor-op version: it is
the oracle the CUDA kernels in kernels/hash_encode.py are held against, and
the path their wrappers take for CPU tensors.

The voxel geometry is computed in exactly the JAX order
(grid = (bmax-bmin)/res, rel = (xc-bmin)/grid, floor,
minv = bl*grid + bmin, w = (xc-minv)/grid): a different rounding can flip
`floor` at a cell boundary and select a different hashed corner.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hashnerf_torch.ops.hashing import box_offsets, spatial_hash


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 512

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return level_resolutions(
            self.base_resolution, self.finest_resolution, self.n_levels
        )

    def resolutions_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.resolutions, dtype=torch.float32, device=device)


def level_resolutions(base: int, finest: int, n_levels: int) -> Tuple[int, ...]:
    """Per-level voxel resolutions: b and floor(base * b**i) in numpy
    float32, exactly as the JAX package computes them."""
    base_f = np.float32(base)
    fin_f = np.float32(finest)
    b = np.float32(
        np.exp(
            (np.log(fin_f, dtype=np.float32) - np.log(base_f, dtype=np.float32))
            / np.float32(n_levels - 1)
        )
    )
    out = []
    for i in range(n_levels):
        res = np.floor(base_f * np.float32(b) ** np.float32(i))
        out.append(int(res))
    return tuple(out)


def init_hash_table(
    cfg: HashGridConfig, generator: Optional[torch.Generator] = None, device=None
) -> torch.Tensor:
    """U(-1e-4, 1e-4) table of shape (L, 2^T, F)."""
    t = torch.empty(
        (cfg.n_levels, cfg.table_size, cfg.n_features_per_level),
        dtype=torch.float32, device=device,
    )
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def corner_weights(w: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights. w: (..., 3) in [0, 1] -> (..., 8), corner n
    using bits (n>>2, (n>>1)&1, n&1) as BOX_OFFSETS does."""
    offs = box_offsets(w.device) > 0  # (8, 3)
    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    cx = torch.where(offs[:, 0], wx, 1.0 - wx)
    cy = torch.where(offs[:, 1], wy, 1.0 - wy)
    cz = torch.where(offs[:, 2], wz, 1.0 - wz)
    return cx * cy * cz


def corner_geometry(
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    resolutions: torch.Tensor,
    log2_hashmap_size: int,
):
    """(level-local idx (L, N, 8) int64, corner weights (L, N, 8),
    keep mask (N,)) for points x (N, 3); resolutions (L,) float32."""
    bbox_min = bbox_min.to(x.dtype)
    bbox_max = bbox_max.to(x.dtype)
    keep = torch.all((x >= bbox_min) & (x <= bbox_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, bbox_min), bbox_max)

    grid = ((bbox_max - bbox_min)[None, :] / resolutions[:, None])[:, None, :]  # (L,1,3)
    rel = (xc[None, :, :] - bbox_min) / grid  # (L, N, 3)
    bl = torch.floor(rel).to(torch.int32)
    minv = bl.to(xc.dtype) * grid + bbox_min
    w = (xc[None, :, :] - minv) / grid

    offs = box_offsets(x.device)
    corners = bl[:, :, None, :] + offs[None, None, :, :]  # (L, N, 8, 3)
    idx = spatial_hash(corners, log2_hashmap_size)
    return idx, corner_weights(w), keep


def hash_encode(
    table: torch.Tensor,
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    cfg: HashGridConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode points x (N, 3) through the grid.

    Returns (features (N, L*F) in level order, keep mask (N,) marking points
    inside the bbox before clipping). Differentiable in `table` by autograd.
    """
    res = cfg.resolutions_tensor(x.device)
    return encode_with_resolutions(
        table, x, bbox_min, bbox_max, res, cfg.log2_hashmap_size
    )


def encode_with_resolutions(table, x, bbox_min, bbox_max, resolutions, log2_hashmap_size):
    L, T, F = table.shape
    idx, cw, keep = corner_geometry(x, bbox_min, bbox_max, resolutions, log2_hashmap_size)
    flat = idx + (torch.arange(L, device=x.device) * T)[:, None, None]
    emb = table.reshape(L * T, F)[flat.reshape(-1)].reshape(L, -1, 8, F)
    feats = (cw[..., None] * emb).sum(dim=2)  # (L, N, F)
    return feats.permute(1, 0, 2).reshape(x.shape[0], L * F), keep

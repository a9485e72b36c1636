"""Corner-packed multiresolution grid encoding.

Counterpart of hashnerf_tpu/ops/packed_grid.py, the `--packed_layout`
encoder: one table-row fetch per (sample, level) instead of eight.

  * Dense levels (the leading levels whose (res+1)^3 vertex grid fits 2^T
    rows) keep a canonical (V, F) vertex table. Each call rebuilds from it a
    (sum res^3, 8F) table of per-voxel corner blocks by 8 shifted slices;
    autograd's transpose of that is the 8 shifted adds.
  * Fine levels are a (Lf * 2^B, 27F) table: the row is the Teschner hash of
    the even-anchored macro-block (b >> 1) at B bits, plus li * 2^B; the
    payload is the 3x3x3 vertex slab covering the block's 2x2x2 voxels. The
    8 trilinear weights are routed to the slots of the voxel's parity.

All dense levels go through one take_rows and all fine levels through
another, so each backward is one K5 scatter-add on the card. The blends are
torch einsums (float32, TF32 off), as the JAX package leaves them to XLA.
The geometry is computed in exactly the JAX order (grid = extent / res,
rel = (xc - bmin) / grid, b = clip(floor(rel), 0, res - 1), w = rel - b): a
different rounding flips `floor` at a cell boundary and picks another row.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hashnerf_torch.kernels.gather import take_rows
from hashnerf_torch.ops.hash_encoding import corner_weights, level_resolutions
from hashnerf_torch.ops.hashing import BOX_OFFSETS, spatial_hash

# Slab slot of corner (i, j, k) of the voxel with parity (0, 0, 0).
_SLOT_OFFSETS = BOX_OFFSETS[:, 0] * 9 + BOX_OFFSETS[:, 1] * 3 + BOX_OFFSETS[:, 2]


@dataclasses.dataclass(frozen=True)
class PackedGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 512
    log2_blocks: int = 16  # fine-level block rows per level, as log2

    # The derived sizes are cached (an encode reads them many times); a
    # frozen dataclass still lets functools.cached_property fill __dict__.

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @functools.cached_property
    def resolutions(self) -> Tuple[int, ...]:
        return level_resolutions(self.base_resolution, self.finest_resolution, self.n_levels)

    @functools.cached_property
    def dense_level_count(self) -> int:
        """Leading levels stored as dense vertex grids: (res+1)^3 <= 2^T."""
        T = 1 << self.log2_hashmap_size
        n = 0
        for r in self.resolutions:
            if (r + 1) ** 3 > T:
                break
            n += 1
        return n

    @functools.cached_property
    def dense_resolutions(self) -> Tuple[int, ...]:
        return self.resolutions[: self.dense_level_count]

    @functools.cached_property
    def fine_resolutions(self) -> Tuple[int, ...]:
        return self.resolutions[self.dense_level_count :]

    @property
    def n_block_rows(self) -> int:
        return 1 << self.log2_blocks

    @functools.cached_property
    def dense_vertex_counts(self) -> Tuple[int, ...]:
        return tuple((r + 1) ** 3 for r in self.dense_resolutions)

    @functools.cached_property
    def dense_offsets(self) -> Tuple[int, ...]:
        return tuple(itertools.accumulate(self.dense_vertex_counts, initial=0))

    @functools.cached_property
    def packed_voxel_counts(self) -> Tuple[int, ...]:
        return tuple(r**3 for r in self.dense_resolutions)

    @functools.cached_property
    def packed_offsets(self) -> Tuple[int, ...]:
        return tuple(itertools.accumulate(self.packed_voxel_counts, initial=0))


def init_packed_tables(
    cfg: PackedGridConfig, generator: Optional[torch.Generator] = None, device=None
) -> Dict[str, torch.Tensor]:
    """U(-1e-4, 1e-4) canonical tables: "dense" (V, F) when there are dense
    levels, "fine" (Lf * 2^B, 27F) when there are fine levels."""
    F = cfg.n_features_per_level
    shapes = {}
    if cfg.dense_offsets[-1]:
        shapes["dense"] = (cfg.dense_offsets[-1], F)
    if cfg.fine_resolutions:
        shapes["fine"] = (len(cfg.fine_resolutions) * cfg.n_block_rows, 27 * F)
    return {
        k: torch.empty(s, dtype=torch.float32, device=device).uniform_(-1e-4, 1e-4, generator=generator)
        for k, s in shapes.items()
    }


def build_packed_dense(dense: torch.Tensor, cfg: PackedGridConfig) -> torch.Tensor:
    """(sum res^3, 8F) per-voxel corner blocks from the canonical (V, F)
    vertex grids; corner c of a voxel sits at columns [c*F, (c+1)*F) in
    BOX_OFFSETS order."""
    F = cfg.n_features_per_level
    parts = []
    for li, res in enumerate(cfg.dense_resolutions):
        o0, o1 = cfg.dense_offsets[li], cfg.dense_offsets[li + 1]
        g = dense[o0:o1].reshape(res + 1, res + 1, res + 1, F)
        corners = [g[i : i + res, j : j + res, k : k + res] for (i, j, k) in BOX_OFFSETS.tolist()]
        parts.append(torch.cat(corners, dim=-1).reshape(res**3, 8 * F))
    return torch.cat(parts, dim=0)


class PackedGeometry(NamedTuple):
    """Row ids and blend weights of N points, level-major as the JAX package
    concatenates them: dense_rows (Ld*N,) int64 rows of the packed dense
    table, dense_w (Ld, N, 8); fine_rows (Lf*N,) int64 rows of the fine
    table, fine_w (Lf, N, 27); keep (N,) bool. A part is None when there
    are no levels of its kind."""

    dense_rows: Optional[torch.Tensor]
    dense_w: Optional[torch.Tensor]
    fine_rows: Optional[torch.Tensor]
    fine_w: Optional[torch.Tensor]
    keep: torch.Tensor


def packed_geometry(x: torch.Tensor, bbox_min: torch.Tensor, bbox_max: torch.Tensor,
                    cfg: PackedGridConfig) -> PackedGeometry:
    bbox_min = bbox_min.to(x.dtype)
    bbox_max = bbox_max.to(x.dtype)
    keep = torch.all((x >= bbox_min) & (x <= bbox_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, bbox_min), bbox_max)
    N, dev = x.shape[0], x.device

    def voxel_and_weights(res: int):
        # b is clipped before w = rel - b: a point on the top face
        # interpolates at w = 1 in the last voxel. The divisor is a tensor:
        # CUDA PyTorch divides by a Python number as a product with its
        # reciprocal, which can round grid differently and flip floor(rel).
        grid = (bbox_max - bbox_min) / torch.full_like(bbox_min, float(res))
        rel = (xc - bbox_min) / grid
        b = torch.clamp(torch.floor(rel).to(torch.int64), 0, res - 1)
        return b, corner_weights(rel - b.to(rel.dtype))

    dense_rows, dense_w = [], []
    for li, res in enumerate(cfg.dense_resolutions):
        b, cw = voxel_and_weights(res)
        dense_rows.append((b[:, 0] * res + b[:, 1]) * res + b[:, 2] + cfg.packed_offsets[li])
        dense_w.append(cw)

    slot_offs = torch.as_tensor(_SLOT_OFFSETS, dtype=torch.int64, device=dev)
    fine_rows, fine_w = [], []
    for li, res in enumerate(cfg.fine_resolutions):
        b, cw = voxel_and_weights(res)
        fine_rows.append(spatial_hash(b >> 1, cfg.log2_blocks) + li * cfg.n_block_rows)
        p = b & 1  # which of the block's 8 voxels
        slots = (p[:, 0] * 9 + p[:, 1] * 3 + p[:, 2])[:, None] + slot_offs  # (N, 8), distinct
        fine_w.append(torch.zeros((N, 27), dtype=cw.dtype, device=dev).scatter_(1, slots, cw))

    cat = lambda ts: torch.cat(ts) if ts else None
    stack = lambda ts: torch.stack(ts) if ts else None
    return PackedGeometry(cat(dense_rows), stack(dense_w), cat(fine_rows), stack(fine_w), keep)


def packed_encode(
    tables, x: torch.Tensor, bbox_min: torch.Tensor, bbox_max: torch.Tensor,
    cfg: PackedGridConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode points x (N, 3) through the packed tables {"dense", "fine"}.

    Returns (features (N, L*F) in level order, keep mask (N,) marking points
    inside the bbox before clipping). Differentiable in both tables.
    """
    F = cfg.n_features_per_level
    N = x.shape[0]
    geo = packed_geometry(x, bbox_min, bbox_max, cfg)
    feats = []
    if geo.dense_rows is not None:
        packed = build_packed_dense(tables["dense"], cfg)
        rows = take_rows(packed, geo.dense_rows).reshape(-1, N, 8, F)
        f = torch.einsum("lnc,lncf->lnf", geo.dense_w, rows)
        feats.append(f.permute(1, 0, 2).reshape(N, -1))
    if geo.fine_rows is not None:
        slabs = take_rows(tables["fine"], geo.fine_rows).reshape(-1, N, 27, F)
        for li in range(slabs.shape[0]):
            feats.append(torch.einsum("ns,nsf->nf", geo.fine_w[li], slabs[li]))
    return torch.cat(feats, dim=-1), geo.keep

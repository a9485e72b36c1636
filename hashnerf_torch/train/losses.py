"""Hash-grid total-variation regularizer.

Counterpart of hashnerf_tpu/train/losses.py (total_variation_loss_all_levels):
for every level, squared forward differences over a random cuboid of the
hashed grid, divided by the cube size, summed over levels. All levels' cube
rows are gathered in one take_rows on the flat (L*2^T, F) table, so the
backward is one sort + K1 pass. The entropy sparsity term lives in
ops/volume.py. The packed-layout TV is ROADMAP A7.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from hashnerf_torch.kernels.gather import take_rows
from hashnerf_torch.ops.hashing import spatial_hash


def tv_level_geometry(min_resolution: int, max_resolution: int, level: int, n_levels: int):
    """(resolution, cube_size) of one level, in Python float64 `math` as the
    JAX TV computes it (this differs on purpose from the float32 encoder
    resolutions of ops/hash_encoding.py)."""
    b = math.exp((math.log(max_resolution) - math.log(min_resolution)) / (n_levels - 1))
    resolution = int(math.floor(min_resolution * b**level))
    min_cube_size = min_resolution - 1
    max_cube_size = 50
    cube_size = int(math.floor(min(max(resolution / 10.0, min_cube_size), max_cube_size)))
    return resolution, cube_size


def draw_tv_min_vertices(
    n_levels: int, min_resolution: int, max_resolution: int,
    generator: Optional[torch.Generator] = None, device=None,
) -> torch.Tensor:
    """(L, 3) int64 cuboid corners, level l uniform in [0, res_l - cube_l)."""
    out = []
    for l in range(n_levels):
        res, cube = tv_level_geometry(min_resolution, max_resolution, l, n_levels)
        out.append(torch.randint(0, res - cube, (3,), generator=generator, device=device))
    return torch.stack(out)


def total_variation_loss_all_levels(
    table: torch.Tensor,
    min_resolution: int,
    max_resolution: int,
    log2_hashmap_size: int,
    min_vertices: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sum over levels of the random-cuboid TV of table (L, 2^T, F).

    min_vertices (L, 3) are the per-level cuboid corners; drawn from
    `generator` when not given.
    """
    n_levels, T, F = table.shape
    dev = table.device
    if min_vertices is None:
        min_vertices = draw_tv_min_vertices(
            n_levels, min_resolution, max_resolution, generator, dev
        )
    min_vertices = torch.as_tensor(min_vertices, device=dev).to(torch.int64)

    parts, sizes = [], []
    for l in range(n_levels):
        _, cube_size = tv_level_geometry(min_resolution, max_resolution, l, n_levels)
        r = torch.arange(cube_size + 1, dtype=torch.int64, device=dev)
        idx = min_vertices[l][None, :] + r[:, None]  # (C+1, 3)
        gx, gy, gz = torch.meshgrid(idx[:, 0], idx[:, 1], idx[:, 2], indexing="ij")
        hashed = spatial_hash(torch.stack([gx, gy, gz], dim=-1), log2_hashmap_size) + l * T
        parts.append(hashed.reshape(-1))
        sizes.append(cube_size)

    all_rows = take_rows(table.reshape(n_levels * T, F), torch.cat(parts))

    total = torch.zeros((), dtype=table.dtype, device=dev)
    off = 0
    for cube_size in sizes:
        c1 = cube_size + 1
        n = c1 * c1 * c1
        cube = all_rows[off : off + n].reshape(c1, c1, c1, F)
        off += n
        tv_x = torch.sum((cube[1:] - cube[:-1]) ** 2)
        tv_y = torch.sum((cube[:, 1:] - cube[:, :-1]) ** 2)
        tv_z = torch.sum((cube[:, :, 1:] - cube[:, :, :-1]) ** 2)
        total = total + (tv_x + tv_y + tv_z) / cube_size
    return total

"""Hash-grid total-variation regularizer.

Counterpart of hashnerf_tpu/train/losses.py (total_variation_loss_all_levels):
for every level, squared forward differences over a random cuboid of the
hashed grid, divided by the cube size, summed over levels. All levels' cube
rows are gathered in one take_rows on the flat (L*2^T, F) table, so the
backward is one K5 scatter-add on the card. The entropy sparsity term lives in
ops/volume.py. `total_variation_loss_packed` is the TV of the corner-packed
layout (ops/packed_grid.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def fine_tv_rows_per_level(n_fine: int) -> int:
    """Block rows a fine level contributes to the packed TV."""
    return max(4096 // n_fine, 512)


def draw_packed_tv(pcfg, generator: Optional[torch.Generator] = None, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed TV's draws: dense cuboid corners (Ld, 3), dense level l
    uniform in [0, max(res_l - cube_l, 1)), and fine block rows (Lf, k_rows),
    uniform over each level's rows (level-local)."""
    corners = []
    for li, res in enumerate(pcfg.dense_resolutions):
        _, cube = tv_level_geometry(pcfg.base_resolution, pcfg.finest_resolution, li, pcfg.n_levels)
        hi = max(res - min(cube, res), 1)
        corners.append(torch.randint(0, hi, (3,), generator=generator, device=device))
    n_fine = len(pcfg.fine_resolutions)
    k_rows = fine_tv_rows_per_level(n_fine) if n_fine else 0
    rows = torch.randint(0, pcfg.n_block_rows, (n_fine, k_rows), generator=generator, device=device)
    dense = torch.stack(corners) if corners else torch.zeros((0, 3), dtype=torch.int64, device=device)
    return dense, rows


def total_variation_loss_packed(
    tables,
    pcfg,
    dense_min_vertices: Optional[torch.Tensor] = None,
    fine_rows: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """TV of the corner-packed tables {"dense", "fine"} (pcfg a
    PackedGridConfig), as hashnerf_tpu/train/losses.py computes it:

      * dense levels: the exact random-cuboid TV of the vertex grid (no
        hashing), cube edge min(cube_l, res_l), divided by the cube size;
      * fine levels: within-slab forward differences over a batch of k_rows
        random block rows a level, weighted cube^3 / (k_rows * 18) / cube so
        that a level counts as much as a cube of the reference TV.

    dense_min_vertices (Ld, 3) and fine_rows (Lf, k_rows), level-local, are
    drawn together from `generator` unless both are given.
    """
    F = pcfg.n_features_per_level
    n_levels = pcfg.n_levels
    dev = next(iter(tables.values())).device
    if dense_min_vertices is None or fine_rows is None:
        dense_min_vertices, fine_rows = draw_packed_tv(pcfg, generator, dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)

    for li, res in enumerate(pcfg.dense_resolutions):
        _, cube_size = tv_level_geometry(pcfg.base_resolution, pcfg.finest_resolution, li, n_levels)
        cube_size = min(cube_size, res)  # dense grid edge guard
        r = torch.arange(cube_size + 1, dtype=torch.int64, device=dev)
        idx = torch.as_tensor(dense_min_vertices[li], device=dev).to(torch.int64)[None, :] + r[:, None]
        gx, gy, gz = torch.meshgrid(idx[:, 0], idx[:, 1], idx[:, 2], indexing="ij")
        v = (gx * (res + 1) + gy) * (res + 1) + gz + pcfg.dense_offsets[li]
        c1 = cube_size + 1
        cube = take_rows(tables["dense"], v.reshape(-1)).reshape(c1, c1, c1, F)
        tv_x = torch.sum((cube[1:] - cube[:-1]) ** 2)
        tv_y = torch.sum((cube[:, 1:] - cube[:, :-1]) ** 2)
        tv_z = torch.sum((cube[:, :, 1:] - cube[:, :, :-1]) ** 2)
        total = total + (tv_x + tv_y + tv_z) / cube_size

    n_fine = len(pcfg.fine_resolutions)
    if n_fine:
        fine = tables["fine"]
        n_dense = len(pcfg.dense_resolutions)
        rows_per_level = fine.shape[0] // n_fine
        k_rows = fine_tv_rows_per_level(n_fine)
        weights = []
        for fi in range(n_fine):
            _, cube_size = tv_level_geometry(
                pcfg.base_resolution, pcfg.finest_resolution, n_dense + fi, n_levels)
            weights.append((float(cube_size) ** 3 / (k_rows * 18.0)) / cube_size)
        rows = torch.as_tensor(fine_rows, device=dev).to(torch.int64)
        rows = rows + rows_per_level * torch.arange(n_fine, device=dev)[:, None]
        slabs = take_rows(fine, rows.reshape(-1)).reshape(n_fine, k_rows, 3, 3, 3, F)
        per_level = (
            torch.sum((slabs[:, :, 1:] - slabs[:, :, :-1]) ** 2, dim=(1, 2, 3, 4, 5))
            + torch.sum((slabs[:, :, :, 1:] - slabs[:, :, :, :-1]) ** 2, dim=(1, 2, 3, 4, 5))
            + torch.sum((slabs[..., 1:, :] - slabs[..., :-1, :]) ** 2, dim=(1, 2, 3, 4, 5))
        )
        w = torch.tensor(weights, dtype=torch.float32, device=dev)
        total = total + torch.dot(per_level, w)
    return total

"""The yardstick's arithmetic: the card's peaks, the points a step or a
frame queries, the model FLOPs they need at a family's multiply-adds a
point, and the bytes a hash-grid encode call needs.

Everything here is counted from the configuration's sizes and the points
the program was given, never read from the program. A family's own
multiply-adds a point sit in its module (families/<family>.py).
"""
from __future__ import annotations

from typing import Dict

import torch

from nerfbench import reference as ref

# NVIDIA's published H100 SXM peaks (dense, at the 700 W limit). The port
# keeps TF32 off, so float32 products run outside the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def peak_flops(s: dict) -> float:
    return PEAK_FLOPS[s.get("compute_dtype") or "float32"]


def train_points_per_step(s: dict) -> int:
    """Points the algorithm queries in a training step past the keep
    schedule: every sample of both passes of every ray (N_samples coarse,
    N_samples + N_importance fine), or under occupancy culling each pass's
    budget."""
    R, Ns, Ni = s["N_rand"], s["N_samples"], s["N_importance"]
    if not s.get("use_occupancy"):
        return R * (2 * Ns + Ni if Ni else Ns)
    fine = ref.keep_k(R * (Ns + Ni), ref.keep_at(s, 1 << 40)) if Ni else 0
    return ref.keep_k(R * Ns, s.get("occ_keep_coarse") or s["occ_keep_fraction"]) + fine


def update_points_per_step(s: dict) -> float:
    """Density queries of the occupancy-grid updates, a step's share."""
    if not s.get("use_occupancy"):
        return 0.0
    return s.get("occ_update_samples", 1 << 16) / s.get("occ_update_every", 16)


def train_flops(s: dict, macs: int, sigma_macs: int) -> float:
    """2 FLOPs a multiply-add; forward and the two backward products (x3)
    of every queried point at `macs` a point, plus the grid updates'
    density forwards at `sigma_macs` a point."""
    return (6.0 * macs * train_points_per_step(s)
            + 2.0 * sigma_macs * update_points_per_step(s))


def render_flops(s: dict, H: int, W: int, macs: int) -> float:
    """Exact eval: every sample of both passes of every pixel's ray
    (N_samples coarse, N_samples + N_importance fine), forward only, at
    `macs` a point."""
    Ns, Ni = s["N_samples"], s["N_importance"]
    return 2.0 * macs * H * W * (2 * Ns + Ni if Ni else Ns)


def _count_rows(ids: torch.Tensor, size: int) -> int:
    mark = torch.zeros(size, dtype=torch.bool, device=ids.device)
    mark[ids.reshape(-1)] = True
    return int(mark.sum())


def touched_row_bytes(g: ref.Grid, pts: torch.Tensor, bbox: torch.Tensor) -> int:
    """Bytes of the table entries that points pts (N, 3) touch, each read
    once: per level the distinct corner rows of F floats; under the packed
    layout the distinct vertices of the dense levels and the distinct live
    (slab row, slot) pairs of the fine levels, F floats each."""
    bmin, bmax = bbox[0], bbox[1]
    xc = torch.minimum(torch.maximum(pts, bmin), bmax)
    rows = 0
    if not g.packed:
        for res in g.res:
            r, _ = ref.hash_corners(xc, bmin, bmax, res, g.log2T)
            rows += _count_rows(r, g.T)
    else:
        for li, res in enumerate(g.dense_res):
            b, _ = ref.packed_voxel(xc, bmin, bmax, res)
            rows += _count_rows(ref.dense_rows(b, res, g.dense_offsets[li]), g.dense_offsets[-1])
        for li, res in enumerate(g.fine_res):
            b, _ = ref.packed_voxel(xc, bmin, bmax, res)
            row, slots = ref.fine_rows_slots(b, g, li)
            rows += _count_rows(row[:, None] * 27 + slots, len(g.fine_res) * g.n_block_rows * 27)
    return rows * g.F * 4


def encode_call_bytes(g: ref.Grid, pts: torch.Tensor, bbox: torch.Tensor,
                      backward: bool) -> Dict[str, int]:
    """The least bytes of one encode of pts (N, 3). Forward: the points
    read, the features and the in-box mask written, the touched table
    entries read. Backward: the points read, the features' cotangent read,
    the touched gradient entries written. (The dense gradient table's
    zero-fill runs in a PyTorch fill kernel that a trace cannot tell from
    other fills, so neither its bytes nor its time are counted.)"""
    N = pts.shape[0]
    rows = touched_row_bytes(g, pts, bbox)
    out = {"forward": 12 * N + 4 * g.out_dim * N + N + rows}
    if backward:
        out["backward"] = 12 * N + 4 * g.out_dim * N + rows
    return out

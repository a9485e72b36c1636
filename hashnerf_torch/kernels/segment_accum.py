"""K1 and K4: segment-sum of sorted (row, F-vector) updates; K5: the
scatter-add of updates in any order.

Counterpart of hashnerf_tpu/kernels/pallas_segment_accum.py
(segment_accumulate_sorted, the repo's one Pallas kernel) and
hashnerf_tpu/kernels/segment_scatter.py (sorted_segment_accumulate).
- K1 and K4 (csrc/segment_accum.cu) keep the sorted contract of the Pallas
  kernel: K1 for narrow rows (the per-corner hash table, F = 2), K4 for wide
  rows (the packed layout's 8F- and 27F-wide rows, up to 216 floats at
  F = 8). `segment_accumulate_sorted` routes by F.
- K5 (csrc/scatter_add.cu) adds updates in any order with vector atomics,
  so `sorted_segment_accumulate`, the contract every caller uses, needs no
  sort on the card. On Hopper a radix sort of the ids and a permutation of
  the values cost more than the whole scatter (PERF.md), where on the TPU
  the sort was the cheap part.

A wrapper takes the plain PyTorch version only for tensors on the CPU. For
a CUDA tensor it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from hashnerf_torch.kernels.launch import Kernel, device_kind, require_aligned

# Widest rows each kernel takes. K1's window is R*F floats of shared memory
# with R = _K1_WINDOW_FLOATS // F rows; K4's is _K4_WINDOW_ROWS rows, since
# skewed ids (a few hot rows, as the dense levels have) want short windows.
K1_MAX_F = 64
K4_MAX_F = 256
# F from which segment_accumulate_sorted takes K4: chip_smoke.py times both
# kernels at F = 8, 16 and 64 (M = 393,216 into 131,072 rows); on an H100
# K1 won at F = 8 and K4 at 16 and 64 (PERF.md has the times).
K4_MIN_F = 16
_K1_WINDOW_FLOATS = 4096
_K4_WINDOW_ROWS = 32
K5_MAX_F = 256
# Updates a group of K5's wide-row kernel walks, keeping runs of equal ids
# in registers (chip_smoke.py times 1 to 64), at most: the kernel takes
# fewer where a small M would leave an SM without a block.
_K5_CHUNK = 16


_SORTED_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
_K1 = Kernel("segment_accum", "segment_accumulate_k1", _SORTED_ARGS)
_K4 = Kernel("segment_accum", "segment_accumulate_k4", _SORTED_ARGS)
_K5 = Kernel("scatter_add", "segment_accumulate_k5",
             [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int])


def _check_shapes(what: str, idx: torch.Tensor, vals: torch.Tensor) -> None:
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(
            f"{what}: want ids (M,) and vals (M, F), got "
            f"{tuple(idx.shape)} and {tuple(vals.shape)}"
        )


def segment_accumulate_sorted_plain(
    sidx: torch.Tensor, svals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain version of K1 and K4: zeros((num_rows, F)).index_add_(0, sidx, svals)."""
    out = torch.zeros((num_rows, svals.shape[1]), dtype=svals.dtype, device=svals.device)
    return out.index_add_(0, sidx.to(torch.int64), svals)


def _check(what: str, sidx: torch.Tensor, svals: torch.Tensor, num_rows: int, max_f: int):
    _check_shapes(what, sidx, svals)
    _require_cuda(what, (sidx, svals))
    if sidx.dtype != torch.int32 or svals.dtype != torch.float32:
        raise TypeError(f"{what}: want int32 and float32, got {sidx.dtype} and {svals.dtype}")
    if not (sidx.is_contiguous() and svals.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if not 1 <= svals.shape[1] <= max_f:
        raise ValueError(f"{what}: F={svals.shape[1]} outside [1, {max_f}]")
    if num_rows >= 2**31:
        raise ValueError(f"{what}: num_rows={num_rows} exceeds int32")


def _require_cuda(what: str, ts) -> None:
    """K1, K4 and K5 take CUDA tensors only; their routers take the CPU's."""
    if device_kind(what, ts) != "cuda":
        raise ValueError(f"{what}: tensors on the CPU, want one CUDA device")


def _launch(kernel: Kernel, sidx, svals, num_rows: int, window_rows: int) -> torch.Tensor:
    M, F = svals.shape
    out = torch.empty((num_rows, F), dtype=torch.float32, device=svals.device)
    kernel(sidx.data_ptr(), svals.data_ptr(), out.data_ptr(), M, F, num_rows, window_rows,
           stream_of=svals)
    return out


def segment_accumulate_k1(sidx: torch.Tensor, svals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K1 on CUDA tensors, F <= 64 (contract of segment_accumulate_sorted)."""
    _check("segment_accumulate_k1", sidx, svals, num_rows, K1_MAX_F)
    return _launch(_K1, sidx, svals, num_rows, _K1_WINDOW_FLOATS // svals.shape[1])


def segment_accumulate_k4(sidx: torch.Tensor, svals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K4 on CUDA tensors, F <= 256 (contract of segment_accumulate_sorted)."""
    _check("segment_accumulate_k4", sidx, svals, num_rows, K4_MAX_F)
    return _launch(_K4, sidx, svals, num_rows, _K4_WINDOW_ROWS)


def segment_accumulate_sorted(
    sidx: torch.Tensor, svals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """out[r] = sum of svals[j] over j with sidx[j] == r -> (num_rows, F).

    sidx: (M,) int32 sorted ascending, every value in [0, num_rows);
    svals: (M, F) float32 in the same element order, F <= 256.
    CPU tensors take the plain version; CUDA tensors K1 below F = K4_MIN_F,
    K4 from it.
    """
    _check_shapes("segment_accumulate_sorted", sidx, svals)
    if device_kind("segment_accumulate_sorted", (sidx, svals)) == "cpu":
        return segment_accumulate_sorted_plain(sidx, svals, num_rows)
    if svals.shape[1] < K4_MIN_F:
        return segment_accumulate_k1(sidx, svals, num_rows)
    return segment_accumulate_k4(sidx, svals, num_rows)


def sort_segments(idx: torch.Tensor, vals: torch.Tensor):
    """Sort (idx, vals) by idx: (sidx int32, svals). The sort stays a
    library call (torch.sort), as the JAX package leaves it to XLA. It is
    stable, so the plain version adds each row's values in their original
    order, as XLA's scatter-add does on the CPU."""
    sidx, perm = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    return sidx, vals.index_select(0, perm)


def segment_accumulate_k5_plain(idx: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of K5: sort_segments, then the plain segment-sum
    (index_add_ in the sorted order)."""
    sidx, svals = sort_segments(idx, vals.contiguous())
    return segment_accumulate_sorted_plain(sidx, svals, num_rows)


def segment_accumulate_k5(idx: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K5 on CUDA tensors: out[r] = sum of vals[j] over j with idx[j] == r.

    idx: (M,) int32 or int64 in any order; an id outside [0, num_rows) is
    dropped. vals: (M, F) float32, 1 <= F <= 256, its rows aligned to their
    vector width (16 bytes where F % 4 == 0, 8 where F % 2 == 0).
    """
    what = "segment_accumulate_k5"
    _check_shapes(what, idx, vals)
    if idx.dtype not in (torch.int32, torch.int64) or vals.dtype != torch.float32:
        raise TypeError(f"{what}: want int32 or int64 ids and float32 values, got "
                        f"{idx.dtype} and {vals.dtype}")
    M, F = vals.shape
    if not 1 <= F <= K5_MAX_F:
        raise ValueError(f"{what}: F={F} outside [1, {K5_MAX_F}]")
    _require_cuda(what, (idx, vals))
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    require_aligned(what, vals, 16 if F % 4 == 0 else 8 if F % 2 == 0 else 4)
    out = torch.zeros((num_rows, F), dtype=torch.float32, device=vals.device)
    _K5(idx.data_ptr(), idx.element_size(), vals.data_ptr(), out.data_ptr(), M, F, num_rows,
        _K5_CHUNK, stream_of=vals)
    return out


def sorted_segment_accumulate(
    idx: torch.Tensor, vals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Dense equivalent of zeros((num_rows, F)).index_add_(0, idx, vals).

    idx: row ids in any order, all in [0, num_rows) (callers pass table
    rows, in range by construction; K5 drops a row outside it, as XLA's
    scatter does); vals: (M, F), F <= 256.
    CPU tensors take K5's plain version (a stable sort and index_add_, so
    that each row adds its values in their original order, as XLA's
    scatter-add does on the CPU); CUDA tensors K5, with no sort.
    """
    idx = idx.reshape(-1)
    _check_shapes("sorted_segment_accumulate", idx, vals)
    if device_kind("sorted_segment_accumulate", (idx, vals)) == "cpu":
        return segment_accumulate_k5_plain(idx, vals, num_rows)
    return segment_accumulate_k5(idx, vals.contiguous(), num_rows)

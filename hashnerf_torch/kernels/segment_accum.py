"""K1: segment-sum of sorted (row, F-vector) updates, and the scatter-add
built on it.

Counterpart of hashnerf_tpu/kernels/pallas_segment_accum.py
(segment_accumulate_sorted, the repo's one Pallas kernel) and
hashnerf_tpu/kernels/segment_scatter.py (sorted_segment_accumulate). The
CUDA kernel is csrc/segment_accum.cu; its note says what bounds it and how
it is built.

A wrapper takes the plain PyTorch version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from hashnerf_torch.kernels import build

# Widest feature count the kernel takes (its window is R*F floats of
# shared memory, with R = _WINDOW_FLOATS // F rows).
MAX_F = 64
_WINDOW_FLOATS = 4096


def _lib():
    lib = build.load("segment_accum")
    fn = lib.segment_accumulate_sorted
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def segment_accumulate_sorted_plain(
    sidx: torch.Tensor, svals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain version of K1: zeros((num_rows, F)).index_add_(0, sidx, svals)."""
    out = torch.zeros((num_rows, svals.shape[1]), dtype=svals.dtype, device=svals.device)
    return out.index_add_(0, sidx.to(torch.int64), svals)


def segment_accumulate_sorted(
    sidx: torch.Tensor, svals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """out[r] = sum of svals[j] over j with sidx[j] == r -> (num_rows, F).

    sidx: (M,) int32 sorted ascending, every value in [0, num_rows);
    svals: (M, F) float32 in the same element order.
    """
    if sidx.dim() != 1 or svals.dim() != 2 or svals.shape[0] != sidx.shape[0]:
        raise ValueError(
            f"segment_accumulate_sorted: want sidx (M,) and svals (M, F), got "
            f"{tuple(sidx.shape)} and {tuple(svals.shape)}"
        )
    if sidx.device.type == "cpu" and svals.device.type == "cpu":
        return segment_accumulate_sorted_plain(sidx, svals, num_rows)
    if sidx.device.type != "cuda" or svals.device != sidx.device:
        raise ValueError(
            f"segment_accumulate_sorted: tensors on {sidx.device} and {svals.device}"
        )
    if sidx.dtype != torch.int32 or svals.dtype != torch.float32:
        raise TypeError(
            f"segment_accumulate_sorted: want int32 and float32, got {sidx.dtype} and {svals.dtype}"
        )
    if not (sidx.is_contiguous() and svals.is_contiguous()):
        raise ValueError("segment_accumulate_sorted: inputs must be contiguous")
    M, F = svals.shape
    if not 1 <= F <= MAX_F:
        raise ValueError(f"segment_accumulate_sorted: F={F} outside [1, {MAX_F}]")
    if num_rows >= 2**31:
        raise ValueError(f"segment_accumulate_sorted: num_rows={num_rows} exceeds int32")
    out = torch.empty((num_rows, F), dtype=torch.float32, device=svals.device)
    fn = _lib()
    stream = torch.cuda.current_stream(svals.device).cuda_stream
    err = fn(sidx.data_ptr(), svals.data_ptr(), out.data_ptr(), M, F, num_rows,
             _WINDOW_FLOATS // F, stream)
    build.check(err, "segment_accumulate_sorted")
    segment_accumulate_sorted.launches += 1
    return out


segment_accumulate_sorted.launches = 0


def sort_segments(idx: torch.Tensor, vals: torch.Tensor):
    """Sort (idx, vals) by idx: (sidx int32, svals). The sort stays a
    library call (torch.sort), as the JAX package leaves it to XLA."""
    sidx, perm = torch.sort(idx.reshape(-1).to(torch.int32))
    return sidx, vals.index_select(0, perm)


def sorted_segment_accumulate(
    idx: torch.Tensor, vals: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Dense equivalent of zeros((num_rows, F)).index_add_(0, idx, vals).

    idx: (M,) row ids in any order, all in [0, num_rows) (callers pass
    hash-table rows, in range by construction; K1 drops a row outside its
    windows, as XLA's scatter does); vals: (M, F).
    Sorts with torch.sort and permutes the values, then runs K1.
    """
    sidx, svals = sort_segments(idx, vals.contiguous())
    return segment_accumulate_sorted(sidx, svals, num_rows)

"""K2 and K3: the hash-grid encode, with a scatter-add backward.

Counterpart of hashnerf_tpu/kernels/hash_encode_vjp.py (hash_encode_fast).
`HashEncode` is a torch.autograd.Function:

  forward   K2 hash_encode_fwd -> (feats (N, L*F), keep (N,))
  backward  K3 hash_encode_bwd_expand -> (flat_idx, vals) for every
            (level, point, corner), then sorted_segment_accumulate (K5 on
            the card, no sort) into d_table (L, T, F).

Only x and the bbox are saved; the backward recomputes the geometry, as the
JAX backward does. No gradient flows to x or the bbox. The CUDA kernels are
in csrc/hash_encode.cu. Each wrapper takes its plain version (built from
ops/hash_encoding.py) only for CPU tensors; for CUDA tensors it launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hashnerf_torch.kernels import build
from hashnerf_torch.kernels.segment_accum import sorted_segment_accumulate
from hashnerf_torch.ops.hash_encoding import corner_geometry, encode_with_resolutions

_ARGTYPES = {
    "hash_encode_fwd": [ctypes.c_void_p] * 7
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "hash_encode_bwd_expand": [ctypes.c_void_p] * 7
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _fn(name: str):
    fn = getattr(build.load("hash_encode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _log2(T: int) -> int:
    log2T = T.bit_length() - 1
    if T != 1 << log2T:
        raise ValueError(f"hash table size {T} is not a power of two")
    return log2T


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(name: str, ts, L: int, T: int) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if L * T >= 2**31:
        raise ValueError(f"{name}: L*T = {L * T} exceeds int32 row ids")


def _check_geometry(name, x, bbox_min, bbox_max, resolutions, L):
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: x must be (N, 3), got {tuple(x.shape)}")
    if bbox_min.shape != (3,) or bbox_max.shape != (3,) or resolutions.shape != (L,):
        raise ValueError(f"{name}: want bbox (3,) and resolutions ({L},)")


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def hash_encode_fwd_plain(table, x, bbox_min, bbox_max, resolutions):
    """Plain version of K2 (the tensor-op encode of ops/hash_encoding.py)."""
    return encode_with_resolutions(
        table, x, bbox_min, bbox_max, resolutions, _log2(table.shape[1])
    )


def hash_encode_fwd(
    table: torch.Tensor,
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    resolutions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """table (L, T, F), x (N, 3), bbox (3,) each, resolutions (L,) float32
    -> (feats (N, L*F) float32, keep (N,) bool)."""
    L, T, F = table.shape
    _check_geometry("hash_encode_fwd", x, bbox_min, bbox_max, resolutions, L)
    if _on_cpu(table, x, bbox_min, bbox_max, resolutions):
        return hash_encode_fwd_plain(table, x, bbox_min, bbox_max, resolutions)
    _check_cuda("hash_encode_fwd", (table, x, bbox_min, bbox_max, resolutions), L, T)
    N = x.shape[0]
    feats = torch.empty((N, L * F), dtype=torch.float32, device=x.device)
    keep = torch.empty((N,), dtype=torch.bool, device=x.device)
    err = _fn("hash_encode_fwd")(
        table.data_ptr(), x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
        resolutions.data_ptr(), feats.data_ptr(), keep.data_ptr(),
        N, L, _log2(T), F, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "hash_encode_fwd")
    hash_encode_fwd.launches += 1
    return feats, keep


hash_encode_fwd.launches = 0


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def hash_encode_bwd_expand_plain(x, bbox_min, bbox_max, resolutions, g_feats, T):
    """Plain version of K3: (flat_idx (L*N*8,) int32, vals (L*N*8, F))."""
    L = resolutions.shape[0]
    idx, cw, _ = corner_geometry(x, bbox_min, bbox_max, resolutions, _log2(T))
    flat_idx = idx + (torch.arange(L, device=x.device) * T)[:, None, None]
    F = g_feats.shape[1] // L
    g = g_feats.reshape(-1, L, F).permute(1, 0, 2)  # (L, N, F)
    vals = cw[..., None] * g[:, :, None, :]  # (L, N, 8, F)
    return flat_idx.reshape(-1).to(torch.int32), vals.reshape(-1, F)


def hash_encode_bwd_expand(
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    resolutions: torch.Tensor,
    g_feats: torch.Tensor,
    T: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner expansion of the encode's backward: for every (level, point,
    corner) its flat table row idx + l*T and its value cw * g[n, l*F:(l+1)*F].
    g_feats (N, L*F); returns (flat_idx (L*N*8,) int32, vals (L*N*8, F))."""
    L = resolutions.shape[0]
    _check_geometry("hash_encode_bwd_expand", x, bbox_min, bbox_max, resolutions, L)
    N = x.shape[0]
    if g_feats.dim() != 2 or g_feats.shape[0] != N or g_feats.shape[1] % L:
        raise ValueError(f"hash_encode_bwd_expand: g_feats {tuple(g_feats.shape)} for N={N}, L={L}")
    F = g_feats.shape[1] // L
    if _on_cpu(x, bbox_min, bbox_max, resolutions, g_feats):
        return hash_encode_bwd_expand_plain(x, bbox_min, bbox_max, resolutions, g_feats, T)
    _check_cuda("hash_encode_bwd_expand", (x, bbox_min, bbox_max, resolutions, g_feats), L, T)
    M = L * N * 8
    flat_idx = torch.empty((M,), dtype=torch.int32, device=x.device)
    vals = torch.empty((M, F), dtype=torch.float32, device=x.device)
    err = _fn("hash_encode_bwd_expand")(
        x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(), resolutions.data_ptr(),
        g_feats.data_ptr(), flat_idx.data_ptr(), vals.data_ptr(),
        N, L, _log2(T), F, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "hash_encode_bwd_expand")
    hash_encode_bwd_expand.launches += 1
    return flat_idx, vals


hash_encode_bwd_expand.launches = 0


class HashEncode(torch.autograd.Function):
    """feats, keep = HashEncode.apply(table, x, bbox_min, bbox_max, resolutions)."""

    @staticmethod
    def forward(ctx, table, x, bbox_min, bbox_max, resolutions):
        feats, keep = hash_encode_fwd(table, x, bbox_min, bbox_max, resolutions)
        ctx.save_for_backward(x, bbox_min, bbox_max, resolutions)
        ctx.table_shape = tuple(table.shape)
        ctx.mark_non_differentiable(keep)
        return feats, keep

    @staticmethod
    def backward(ctx, g_feats, _g_keep):
        x, bbox_min, bbox_max, resolutions = ctx.saved_tensors
        L, T, F = ctx.table_shape
        flat_idx, vals = hash_encode_bwd_expand(
            x, bbox_min, bbox_max, resolutions, g_feats.contiguous(), T
        )
        d_table = sorted_segment_accumulate(flat_idx, vals, L * T).reshape(L, T, F)
        return d_table, None, None, None, None


def hash_encode(table, x, bbox_min, bbox_max, resolutions):
    """(feats (N, L*F), keep (N,)) with the kernel backward for the table."""
    return HashEncode.apply(table, x, bbox_min, bbox_max, resolutions)

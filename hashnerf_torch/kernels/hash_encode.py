"""K2, K6 and K3: the hash-grid encode and its backward.

Counterpart of hashnerf_tpu/kernels/hash_encode_vjp.py (hash_encode_fast).
`HashEncode` is a torch.autograd.Function:

  forward   K2 hash_encode_fwd -> (feats (N, L*F), keep (N,))
  backward  K6 hash_encode_bwd -> d_table (L, T, F): the geometry recomputed
            and each corner's cw * g added straight into the table (a
            (point, level) whose cotangent row is zero adds nothing).

K3 (hash_encode_bwd_expand), which writes every (level, point, corner) as
an (id, value) pair for K5 to add, is on no path since K6; it stays as the
route K6 replaced and for the corner-id gate of chip_smoke.py.

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

from hashnerf_torch.kernels.launch import Kernel, device_kind, require_aligned
from hashnerf_torch.kernels.segment_accum import segment_accumulate_k5_plain
from hashnerf_torch.ops.hash_encoding import corner_geometry, encode_with_resolutions
from hashnerf_torch.utils.profiling import annotate

# Levels in a group of K2's and K6's launch order (csrc/hash_encode.cu):
# chip_smoke.py times groups of 1 to 16 levels on the card.
_K2_GROUP_LEVELS = 4
_K6_GROUP_LEVELS = 4

_INTS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_K2 = Kernel("hash_encode", "hash_encode_fwd", [ctypes.c_void_p] * 7 + _INTS + [ctypes.c_int])
_K6 = Kernel("hash_encode", "hash_encode_bwd", [ctypes.c_void_p] * 6 + _INTS + [ctypes.c_int])
_K3 = Kernel("hash_encode", "hash_encode_bwd_expand", [ctypes.c_void_p] * 7 + _INTS)


def _log2(T: int) -> int:
    log2T = T.bit_length() - 1
    if T != 1 << log2T:
        raise ValueError(f"hash table size {T} is not a power of two")
    return log2T


def _check_inputs(name: str, ts, L: int, T: int) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if L * T >= 2**31:
        raise ValueError(f"{name}: L*T = {L * T} exceeds int32 row ids")


def _vector_bytes(F: int) -> int:
    """Rows of F floats are read as 16-byte (F % 4 == 0) or 8-byte (F = 2)
    vectors: the first row must be aligned to that."""
    return 16 if F % 4 == 0 else 8 if F == 2 else 4


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
    name = "hash_encode_fwd"
    L, T, F = table.shape
    _check_geometry(name, x, bbox_min, bbox_max, resolutions, L)
    ts = (table, x, bbox_min, bbox_max, resolutions)
    if device_kind(name, ts) == "cpu":
        return hash_encode_fwd_plain(table, x, bbox_min, bbox_max, resolutions)
    _check_inputs(name, ts, L, T)
    N = x.shape[0]
    feats = torch.empty((N, L * F), dtype=torch.float32, device=x.device)
    keep = torch.empty((N,), dtype=torch.bool, device=x.device)
    require_aligned(name, table, _vector_bytes(F))
    _K2(table.data_ptr(), x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
        resolutions.data_ptr(), feats.data_ptr(), keep.data_ptr(),
        N, L, _log2(T), F, _K2_GROUP_LEVELS, stream_of=x)
    return feats, keep


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _check_g(name, x, g_feats, L):
    N = x.shape[0]
    if g_feats.dim() != 2 or g_feats.shape[0] != N or g_feats.shape[1] % L:
        raise ValueError(f"{name}: g_feats {tuple(g_feats.shape)} for N={N}, L={L}")
    return g_feats.shape[1] // L


def hash_encode_bwd_plain(x, bbox_min, bbox_max, resolutions, g_feats, T):
    """Plain version of K6: K3's plain expansion, then K5's plain scatter-add
    (a stable sort and index_add_) -> d_table (L, T, F)."""
    L = resolutions.shape[0]
    flat_idx, vals = hash_encode_bwd_expand_plain(x, bbox_min, bbox_max, resolutions, g_feats, T)
    return segment_accumulate_k5_plain(flat_idx, vals, L * T).reshape(L, T, vals.shape[1])


def hash_encode_bwd(
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    resolutions: torch.Tensor,
    g_feats: torch.Tensor,
    T: int,
) -> torch.Tensor:
    """The encode's table gradient: d_table[l, idx_c, :] += cw_c * g[n, l*F:(l+1)*F]
    for every (level, point, corner). x (N, 3), bbox (3,) each,
    resolutions (L,), g_feats (N, L*F), all float32 and contiguous
    -> d_table (L, T, F) float32."""
    name = "hash_encode_bwd"
    L = resolutions.shape[0]
    _check_geometry(name, x, bbox_min, bbox_max, resolutions, L)
    F = _check_g(name, x, g_feats, L)
    ts = (x, bbox_min, bbox_max, resolutions, g_feats)
    _check_inputs(name, ts, L, T)
    log2T = _log2(T)
    if device_kind(name, ts) == "cpu":
        with annotate("hn.encode.bwd"):
            return hash_encode_bwd_plain(x, bbox_min, bbox_max, resolutions, g_feats, T)
    require_aligned(name, g_feats, _vector_bytes(F))
    # the span names the gradient's zero-fill, a PyTorch fill, with K6
    with annotate("hn.encode.bwd"):
        d_table = torch.zeros((L, T, F), dtype=torch.float32, device=x.device)
        _K6(x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(), resolutions.data_ptr(),
            g_feats.data_ptr(), d_table.data_ptr(), x.shape[0], L, log2T, F,
            _K6_GROUP_LEVELS, stream_of=x)
    return d_table


# ---------------------------------------------------------------------------
# K3 (on no path since K6)
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
    name = "hash_encode_bwd_expand"
    L = resolutions.shape[0]
    _check_geometry(name, x, bbox_min, bbox_max, resolutions, L)
    N = x.shape[0]
    F = _check_g(name, x, g_feats, L)
    ts = (x, bbox_min, bbox_max, resolutions, g_feats)
    if device_kind(name, ts) == "cpu":
        return hash_encode_bwd_expand_plain(x, bbox_min, bbox_max, resolutions, g_feats, T)
    _check_inputs(name, ts, L, T)
    M = L * N * 8
    flat_idx = torch.empty((M,), dtype=torch.int32, device=x.device)
    vals = torch.empty((M, F), dtype=torch.float32, device=x.device)
    _K3(x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(), resolutions.data_ptr(),
        g_feats.data_ptr(), flat_idx.data_ptr(), vals.data_ptr(), N, L, _log2(T), F,
        stream_of=x)
    return flat_idx, vals


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
        d_table = hash_encode_bwd(
            x.contiguous(), bbox_min.contiguous(), bbox_max.contiguous(), resolutions.contiguous(),
            g_feats.contiguous(), ctx.table_shape[1],
        )
        return d_table, None, None, None, None


def hash_encode(table, x, bbox_min, bbox_max, resolutions):
    """(feats (N, L*F), keep (N,)) with the kernel backward for the table."""
    return HashEncode.apply(table, x, bbox_min, bbox_max, resolutions)

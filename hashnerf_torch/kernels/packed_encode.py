"""K7 and K8: the packed-layout encode and its fused backward.

Counterpart of hashnerf_tpu/ops/packed_grid.py::packed_encode (XLA: the
per-voxel dense table rebuilt from the canonical vertices, one take_rows
per layer kind, einsum blends; its backward the Pallas scatter-add behind
take_rows). `PackedEncode` is a torch.autograd.Function:

  forward   K7 packed_encode_fwd -> (feats (N, L*F), keep (N,)): 32 points
            of one level a warp, whole feature rows written from a
            shared-memory tile
  backward  K8 packed_encode_bwd -> (d_dense (V, F), d_fine (Lf*2^B, 27F)):
            the geometry recomputed and each corner's cw * g added straight
            into the canonical vertex row or the slab slot (a (point,
            level) whose cotangent row is zero adds nothing).

Each of a voxel's 8 corners is one F-float row: a vertex of the canonical
dense table, or one of the 8 live slots of the fine slab (csrc/packed_encode.cu
has the arithmetic). The plain versions below compute the same rows in
PyTorch; nothing rebuilds the (sum res^3, 8F) packed table or gathers a
27F slab whole. ops/packed_grid.py::packed_encode takes PackedEncode for
CUDA tensors and its torch-op route for CPU tensors.

Only x and the bbox are saved; the backward recomputes the geometry. No
gradient flows to x or the bbox. Each wrapper takes its plain version only
for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hashnerf_torch.kernels.launch import Kernel, device_kind, require_aligned
from hashnerf_torch.ops.hash_encoding import corner_weights
from hashnerf_torch.ops.hashing import box_offsets, spatial_hash
from hashnerf_torch.utils.profiling import annotate

MAX_LEVELS = 32  # csrc/packed_encode.cu: kMaxLevels
MAX_F = 8
# Levels in a group of K8's launch order (csrc/packed_encode.cu), as K6's.
_K8_GROUP_LEVELS = 4

_LEVELS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_int]
_K7 = Kernel("packed_encode", "packed_encode_fwd", [ctypes.c_void_p] * 7 + _LEVELS)
_K8 = Kernel("packed_encode", "packed_encode_bwd", [ctypes.c_void_p] * 6 + _LEVELS + [ctypes.c_int])


@functools.lru_cache(maxsize=None)
def _level_arrays(cfg):
    """(res, dense_off) as C arrays for the kernels' level table, kept alive
    with the config: ints of every level, first vertices of the dense ones."""
    res = (ctypes.c_int * cfg.n_levels)(*cfg.resolutions)
    offs = cfg.dense_offsets[: cfg.dense_level_count] or (0,)
    return res, (ctypes.c_longlong * len(offs))(*offs)


def _level_args(cfg):
    res, offs = _level_arrays(cfg)
    return (cfg.dense_level_count, len(cfg.fine_resolutions), ctypes.addressof(res),
            ctypes.addressof(offs), cfg.log2_blocks, cfg.n_features_per_level)


def table_shapes(cfg) -> Tuple[Optional[Tuple[int, int]], Optional[Tuple[int, int]]]:
    """(dense (V, F) or None, fine (Lf * 2^B, 27F) or None)."""
    F = cfg.n_features_per_level
    dense = (cfg.dense_offsets[-1], F) if cfg.dense_level_count else None
    n_fine = len(cfg.fine_resolutions)
    return dense, ((n_fine * cfg.n_block_rows, 27 * F) if n_fine else None)


def _check(name: str, cfg, ts, shapes) -> str:
    """Shapes, dtypes and contiguity of every tensor of ts (name -> tensor
    or None) against shapes (name -> shape or None); returns their
    launch.device_kind. Tensors absent from the config must be None."""
    F, L = cfg.n_features_per_level, cfg.n_levels
    if not 1 <= F <= MAX_F or L > MAX_LEVELS:
        raise ValueError(f"{name}: F={F}, L={L} outside F in [1, {MAX_F}], L <= {MAX_LEVELS}")
    dense, fine = table_shapes(cfg)
    # K8's keys are int rows of either table
    if max(dense[0] if dense else 0, fine[0] * 27 if fine else 0) >= 2**31:
        raise ValueError(f"{name}: table rows exceed int32 keys")
    for key, t in ts.items():
        want = shapes[key]
        if (t is None) != (want is None):
            raise ValueError(f"{name}: {key} is {'missing' if t is None else 'unexpected'}")
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, want {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device_kind(name, ts.values())


def _vector_bytes(F: int) -> int:
    """Rows of F floats are read and added as vectors of 4, 2 or 1 floats:
    each tensor's first row must be aligned to that."""
    return 16 if F % 4 == 0 else 8 if F % 2 == 0 else 4


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Plain versions: the kernels' index arithmetic in PyTorch
# ---------------------------------------------------------------------------

def corner_rows(x, bbox_min, bbox_max, cfg):
    """keep (N,) and, for each level in order, (table, rows, cw): the table
    ("dense" or "fine"), the F-float rows of the 8 corners (N, 8) int64 in
    that table viewed as (-1, F) (a canonical vertex, or slab row * 27 +
    slot), and the trilinear weights (N, 8), corners in BOX_OFFSETS order.
    The geometry is ops/packed_grid.py's, in its order."""
    keep = torch.all((x >= bbox_min) & (x <= bbox_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, bbox_min), bbox_max)
    offs = box_offsets(x.device).to(torch.int64)  # (8, 3)
    n_dense = cfg.dense_level_count
    levels = []
    for li, res in enumerate(cfg.resolutions):
        # the divisor is a tensor, as in ops/packed_grid.py: CUDA PyTorch
        # divides by a Python number as a product with its reciprocal
        grid = (bbox_max - bbox_min) / torch.full_like(bbox_min, float(res))
        rel = (xc - bbox_min) / grid
        b = torch.clamp(torch.floor(rel).to(torch.int64), 0, res - 1)
        cw = corner_weights(rel - b.to(rel.dtype))
        if li < n_dense:
            v = b[:, None, :] + offs
            r1 = res + 1
            levels.append(("dense", (v[..., 0] * r1 + v[..., 1]) * r1 + v[..., 2]
                           + cfg.dense_offsets[li], cw))
        else:
            slab = spatial_hash(b >> 1, cfg.log2_blocks) + (li - n_dense) * cfg.n_block_rows
            p = (b & 1)[:, None, :] + offs
            levels.append(("fine", slab[:, None] * 27 + p[..., 0] * 9 + p[..., 1] * 3 + p[..., 2],
                           cw))
    return keep, levels


def packed_encode_fwd_plain(dense, fine, x, bbox_min, bbox_max, cfg):
    """Plain version of K7: each level's 8 corner rows, weighted and summed
    -> (feats (N, L*F), keep (N,))."""
    F = cfg.n_features_per_level
    keep, levels = corner_rows(x, bbox_min, bbox_max, cfg)
    tabs = {"dense": dense, "fine": None if fine is None else fine.reshape(-1, F)}
    feats = [(cw[..., None] * tabs[kind][rows]).sum(dim=1) for kind, rows, cw in levels]
    return torch.cat(feats, dim=-1), keep


def packed_encode_bwd_plain(x, bbox_min, bbox_max, g_feats, cfg):
    """Plain version of K8: cw_c * g of each (point, level, corner) added
    into its row by index_add_ -> (d_dense (V, F) or None, d_fine
    (Lf*2^B, 27F) or None)."""
    F = cfg.n_features_per_level
    dense, fine = table_shapes(cfg)
    z = lambda s: None if s is None else torch.zeros(s, dtype=torch.float32, device=x.device)
    out = {"dense": z(dense), "fine": z(fine)}
    _, levels = corner_rows(x, bbox_min, bbox_max, cfg)
    for li, (kind, rows, cw) in enumerate(levels):
        vals = cw[..., None] * g_feats[:, None, li * F:(li + 1) * F]
        out[kind].view(-1, F).index_add_(0, rows.reshape(-1), vals.reshape(-1, F))
    return out["dense"], out["fine"]


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def packed_encode_fwd(
    dense: Optional[torch.Tensor],
    fine: Optional[torch.Tensor],
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    cfg,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dense (V, F) or None, fine (Lf*2^B, 27F) or None (as cfg, a
    PackedGridConfig, has levels of each kind), x (N, 3), bbox (3,) each,
    all float32 and contiguous -> (feats (N, L*F) float32, keep (N,) bool)."""
    name = "packed_encode_fwd"
    N = x.shape[0] if x.dim() == 2 else -1
    dshape, fshape = table_shapes(cfg)
    ts = {"dense": dense, "fine": fine, "x": x, "bbox_min": bbox_min, "bbox_max": bbox_max}
    shapes = {"dense": dshape, "fine": fshape, "x": (N, 3), "bbox_min": (3,), "bbox_max": (3,)}
    if _check(name, cfg, ts, shapes) == "cpu":
        return packed_encode_fwd_plain(dense, fine, x, bbox_min, bbox_max, cfg)
    for t in (dense, fine):
        require_aligned(name, t, _vector_bytes(cfg.n_features_per_level))
    feats = torch.empty((N, cfg.out_dim), dtype=torch.float32, device=x.device)
    keep = torch.empty((N,), dtype=torch.bool, device=x.device)
    _K7(_ptr(dense), _ptr(fine), x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(),
        feats.data_ptr(), keep.data_ptr(), N, *_level_args(cfg), stream_of=x)
    return feats, keep


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def packed_encode_bwd(
    x: torch.Tensor,
    bbox_min: torch.Tensor,
    bbox_max: torch.Tensor,
    g_feats: torch.Tensor,
    cfg,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The encode's table gradients: cw_c * g[n, l*F:(l+1)*F] added into the
    row of every (point, level, corner). x (N, 3), bbox (3,) each, g_feats
    (N, L*F), all float32 and contiguous -> (d_dense (V, F) or None,
    d_fine (Lf*2^B, 27F) or None), zeroed and then added into on the
    stream."""
    name = "packed_encode_bwd"
    N = x.shape[0] if x.dim() == 2 else -1
    ts = {"x": x, "bbox_min": bbox_min, "bbox_max": bbox_max, "g_feats": g_feats}
    shapes = {"x": (N, 3), "bbox_min": (3,), "bbox_max": (3,), "g_feats": (N, cfg.out_dim)}
    if _check(name, cfg, ts, shapes) == "cpu":
        with annotate("hn.encode.bwd"):
            return packed_encode_bwd_plain(x, bbox_min, bbox_max, g_feats, cfg)
    require_aligned(name, g_feats, _vector_bytes(cfg.n_features_per_level))
    dense, fine = table_shapes(cfg)
    z = lambda s: None if s is None else torch.zeros(s, dtype=torch.float32, device=x.device)
    # the span names the gradients' zero-fills, PyTorch fills, with K8
    with annotate("hn.encode.bwd"):
        d_dense, d_fine = z(dense), z(fine)
        _K8(x.data_ptr(), bbox_min.data_ptr(), bbox_max.data_ptr(), g_feats.data_ptr(),
            _ptr(d_dense), _ptr(d_fine), N, *_level_args(cfg), _K8_GROUP_LEVELS, stream_of=x)
    return d_dense, d_fine


class PackedEncode(torch.autograd.Function):
    """feats, keep = PackedEncode.apply(dense, fine, x, bbox_min, bbox_max, cfg),
    dense or fine None where cfg has no level of that kind."""

    @staticmethod
    def forward(ctx, dense, fine, x, bbox_min, bbox_max, cfg):
        feats, keep = packed_encode_fwd(dense, fine, x, bbox_min, bbox_max, cfg)
        ctx.save_for_backward(x, bbox_min, bbox_max)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(keep)
        return feats, keep

    @staticmethod
    def backward(ctx, g_feats, _g_keep):
        x, bbox_min, bbox_max = ctx.saved_tensors
        d_dense, d_fine = packed_encode_bwd(x, bbox_min, bbox_max, g_feats.contiguous(), ctx.cfg)
        return d_dense, d_fine, None, None, None, None

"""K9: the field query's colour-net input and raw output.

No TPU kernel's counterpart: the JAX package concatenates NeRFSmall's
colour input [view encoding, geo features] and query_fn's raw [rgb,
sigma] under the keep mask, and XLA fuses those concatenations into their
consumers. The port encodes the view directions once a ray
(models/factory.py::query_fn) and writes each row once (csrc/field_query.cu):

  field_colour_input(views (R, Cv) or None, h (N, 1+G), S), N = R*S
      -> (N, Cv+G) = [views[n // S], h[n, 1:]]: a view of rows padded to
      P = Cv+G rounded up to 4 floats, which the colour net's first GEMM
      reads with a leading dimension of P. Forward K9 field_colour_input_fwd;
      backward field_colour_input_bwd, d_h = [0, g[:, Cv:]]. Where views
      require a gradient (NeRFSmall's call on a concatenated x), it is the
      sum of their cotangent columns over a ray's samples, in PyTorch ops;
      the field query's directions carry none.
  field_raw(rgb (N, 3), h (N, 1+G), keep (N,) bool or None)
      -> (N, 4) = [rgb, keep ? h[:, 0] : 0]. Forward field_raw_fwd; backward
      field_raw_bwd, d_h = [keep ? g[:, 3] : 0, 0, ...], and rgb's
      cotangent is g[:, :3] itself.

Bounds (csrc/field_query.cu): bytes, about 184 a sample for the colour
input at Cv 16, G 15 (188 with the row's pad float) and 33 for the raw. Every value is a copy or +0, so
the kernels equal their plain versions bit for bit. Each launcher takes its
plain version only for CPU tensors; for CUDA tensors it launches its kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hashnerf_torch.kernels.launch import Kernel, device_kind

_LL, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_K9 = Kernel("field_query", "field_colour_input_fwd", [_P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _LL])
_K9_BWD = Kernel("field_query", "field_colour_input_bwd", [_P, _P, _LL, _I, _I, _LL])
_RAW = Kernel("field_query", "field_raw_fwd", [_P, _P, _P, _P, _LL, _LL, _LL])
_RAW_BWD = Kernel("field_query", "field_raw_bwd", [_P, _P, _P, _LL, _I, _LL])


def padded_width(c: int) -> int:
    """The colour input's row: c floats rounded up to 16 bytes."""
    return (c + 3) // 4 * 4


def _adjacent(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t with adjacent columns (the kernels take any row stride): a
    cotangent can come expanded, with stride 0."""
    return t if t is None or t.stride(-1) == 1 else t.contiguous()


def device_of(name: str, ts) -> str:
    """launch.device_kind of ts, float32 tensors and bool masks (None
    skipped); raises TypeError for another dtype first."""
    for t in ts:
        if t is not None and t.dtype != torch.float32 and t.dtype != torch.bool:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
    return device_kind(name, ts)


def _rows(name: str, t: torch.Tensor, N: int, width: Optional[int] = None) -> None:
    if t.dim() != 2 or t.shape[0] != N or (width is not None and t.shape[1] != width):
        raise ValueError(f"{name}: want ({N}, {width or 'C'}), got {tuple(t.shape)}")


def keep_mask(name: str, keep: Optional[torch.Tensor], N: int) -> Optional[torch.Tensor]:
    """keep (N,) bool, contiguous, or None."""
    if keep is not None and (keep.shape != (N,) or keep.dtype != torch.bool):
        raise ValueError(f"{name}: keep must be a ({N},) bool tensor")
    return None if keep is None else keep.contiguous()


# ---------------------------------------------------------------------------
# K9: the colour net's input
# ---------------------------------------------------------------------------

def field_colour_input_fwd_plain(views: Optional[torch.Tensor], h: torch.Tensor,
                                 S: int) -> torch.Tensor:
    """Plain version of field_colour_input_fwd: the same padded rows."""
    N, H = h.shape
    Cv = 0 if views is None else views.shape[1]
    out = h.new_zeros((N, padded_width(Cv + H - 1)))
    if views is not None:
        out[:, :Cv] = views.repeat_interleave(S, dim=0)
    out[:, Cv:Cv + H - 1] = h[:, 1:]
    return out[:, :Cv + H - 1]


def field_colour_input_fwd(views: Optional[torch.Tensor], h: torch.Tensor,
                           S: int) -> torch.Tensor:
    """[views[n // S], h[n, 1:]] for every row n of h (N, 1+G); views
    (N // S, Cv) or None -> (N, Cv+G), a view of (N, P) rows."""
    name = "field_colour_input_fwd"
    if h.dim() != 2 or h.shape[1] < 1 or S < 1 or h.shape[0] % S:
        raise ValueError(f"{name}: h {tuple(h.shape)} is not S = {S} samples a ray")
    N, H = h.shape
    views, h = _adjacent(views), _adjacent(h)
    if views is not None:
        _rows(name, views, N // S)
    if device_of(name, (views, h)) == "cpu":
        return field_colour_input_fwd_plain(views, h, S)
    Cv, G = (0 if views is None else views.shape[1]), H - 1
    P = padded_width(Cv + G)
    out = torch.empty((N, P), dtype=torch.float32, device=h.device)
    _K9(None if views is None else views.data_ptr(), h.data_ptr(), out.data_ptr(),
        N, S, Cv, G, P, 0 if views is None else views.stride(0), h.stride(0), stream_of=h)
    return out[:, :Cv + G]


def field_colour_input_bwd_plain(g: torch.Tensor, Cv: int, H: int) -> torch.Tensor:
    """Plain version of field_colour_input_bwd."""
    d_h = g.new_zeros((g.shape[0], H))
    d_h[:, 1:] = g[:, Cv:Cv + H - 1]
    return d_h


def field_colour_input_bwd(g: torch.Tensor, Cv: int, H: int) -> torch.Tensor:
    """The sigma net output's gradient from the colour input's cotangent g
    (N, Cv + H - 1): d_h (N, H) = [0, g[:, Cv:]]."""
    name = "field_colour_input_bwd"
    N, g = g.shape[0], _adjacent(g)
    _rows(name, g, N, Cv + H - 1)
    if device_of(name, (g,)) == "cpu":
        return field_colour_input_bwd_plain(g, Cv, H)
    d_h = torch.empty((N, H), dtype=torch.float32, device=g.device)
    _K9_BWD(g.data_ptr(), d_h.data_ptr(), N, H, Cv, g.stride(0), stream_of=g)
    return d_h


class FieldColourInput(torch.autograd.Function):
    """c = FieldColourInput.apply(views, h, S)."""

    @staticmethod
    def forward(ctx, views, h, S):
        ctx.S, ctx.H = S, h.shape[1]
        ctx.Cv = 0 if views is None else views.shape[1]
        return field_colour_input_fwd(views, h, S)

    @staticmethod
    def backward(ctx, g):
        d_views = d_h = None
        if ctx.needs_input_grad[0]:
            Cv = ctx.Cv
            d_views = g[:, :Cv].reshape(-1, ctx.S, Cv).sum(dim=1)
        if ctx.needs_input_grad[1]:
            d_h = field_colour_input_bwd(g, ctx.Cv, ctx.H)
        return d_views, d_h, None


def field_colour_input(views: Optional[torch.Tensor], h: torch.Tensor, S: int) -> torch.Tensor:
    """The colour net's input (N, Cv+G) = [views[n // S], h[n, 1:]], with a
    gradient for h (and for views where they require one)."""
    return FieldColourInput.apply(views, h, S)


# ---------------------------------------------------------------------------
# field_raw: the query's raw
# ---------------------------------------------------------------------------

def field_raw_fwd_plain(rgb, h, keep):
    """Plain version of field_raw_fwd."""
    sigma = h[:, :1]
    if keep is not None:
        sigma = torch.where(keep[:, None], sigma, torch.zeros_like(sigma))
    return torch.cat([rgb, sigma], dim=-1)


def field_raw_fwd(rgb: torch.Tensor, h: torch.Tensor,
                  keep: Optional[torch.Tensor]) -> torch.Tensor:
    """rgb (N, 3), h (N, H), keep (N,) bool or None -> raw (N, 4) =
    [rgb, keep ? h[:, 0] : 0]."""
    name = "field_raw_fwd"
    N, rgb, h = h.shape[0], _adjacent(rgb), _adjacent(h)
    _rows(name, rgb, N, 3)
    _rows(name, h, N)
    keep = keep_mask(name, keep, N)
    if device_of(name, (rgb, h, keep)) == "cpu":
        return field_raw_fwd_plain(rgb, h, keep)
    raw = torch.empty((N, 4), dtype=torch.float32, device=h.device)
    _RAW(rgb.data_ptr(), h.data_ptr(), None if keep is None else keep.data_ptr(),
         raw.data_ptr(), N, rgb.stride(0), h.stride(0), stream_of=h)
    return raw


def field_raw_bwd_plain(g, keep, H):
    """Plain version of field_raw_bwd."""
    d_h = g.new_zeros((g.shape[0], H))
    d_sigma = g[:, 3]
    d_h[:, 0] = d_sigma if keep is None else torch.where(keep, d_sigma, torch.zeros_like(d_sigma))
    return d_h


def field_raw_bwd(g: torch.Tensor, keep: Optional[torch.Tensor], H: int) -> torch.Tensor:
    """h's gradient from the raw's cotangent g (N, 4): d_h (N, H) =
    [keep ? g[:, 3] : 0, 0, ...]."""
    name = "field_raw_bwd"
    N, g = g.shape[0], _adjacent(g)
    _rows(name, g, N, 4)
    keep = keep_mask(name, keep, N)
    if device_of(name, (g, keep)) == "cpu":
        return field_raw_bwd_plain(g, keep, H)
    d_h = torch.empty((N, H), dtype=torch.float32, device=g.device)
    _RAW_BWD(g.data_ptr(), None if keep is None else keep.data_ptr(), d_h.data_ptr(),
             N, H, g.stride(0), stream_of=g)
    return d_h


class FieldRaw(torch.autograd.Function):
    """raw = FieldRaw.apply(rgb, h, keep)."""

    @staticmethod
    def forward(ctx, rgb, h, keep):
        ctx.H = h.shape[1]
        ctx.save_for_backward(keep)
        return field_raw_fwd(rgb, h, keep)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        d_rgb = g[:, :3] if ctx.needs_input_grad[0] else None
        d_h = field_raw_bwd(g, keep, ctx.H) if ctx.needs_input_grad[1] else None
        return d_rgb, d_h, None


def field_raw(rgb: torch.Tensor, h: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """The query's raw (N, 4) = [rgb, keep ? h[:, 0] : 0], with gradients
    for rgb and h."""
    return FieldRaw.apply(rgb, h, keep)

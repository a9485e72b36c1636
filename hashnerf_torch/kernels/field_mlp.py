"""field_mlp: NeRFSmall's whole forward with bf16 or float32 operands, in
one kernel.

No TPU kernel's counterpart: the JAX package's apply_nerf_small multiplies
each layer in a float32 dot (of bf16-rounded inputs and weights in the bf16
compute mode), and XLA fuses the casts, ReLUs and concatenations into the
dots. The port's PyTorch route (models/nerf.py::NeRFSmall.forward_rays)
writes each of those as a pass of its own. For a call that takes no
gradient (frames, grid updates) NeRFSmall hands the whole forward to
csrc/field_mlp.cu:

  field_mlp_fwd(x (N, 32), views (N // S, 16) or None, S, keep (N,) bool or
                None, weights (w0, w1, wc0, wc1, wc2), rounding)
      -> raw (N, 4) = [rgb logits, keep ? sigma : 0], float32.

The weights are nn.Linear's (out, in): the sigma net's (64, 32) and
(16, 64), the colour net's (64, Cv + 15), (64, 64) and (3, 64). `rounding`
is the net's compute type, torch.bfloat16 or None (float32): with bf16 the
kernel rounds every layer's input and weight to bf16 (the weights as it
stages them, on every call), with None it rounds nothing between the
layers. `takes(cfg)` says which NeRFSmall widths the kernel has.

Bound (csrc/field_mlp.cu): the float32 multiply-adds on the CUDA cores,
9,344 a point. Each output is the float32 chain acc = fmaf(a_k, w_k, acc)
in k order from 0: the order of cuBLAS's float32 GEMM on the PyTorch
route. With bf16 operands each product is exact, so every hidden value
rounds to the same bf16 value as on that route. The kernel equals
field_mlp_fwd_ordered, that arithmetic in PyTorch ops, bit for bit; on the
card the PyTorch route's GEMMs depart from that order only in rare last
bits. The launcher takes its plain version, the PyTorch route's
composition, only for CPU tensors; for CUDA tensors it launches its kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hashnerf_torch.kernels.field_query import (
    device_of, field_colour_input_fwd_plain, field_raw_fwd_plain, keep_mask,
)
from hashnerf_torch.kernels.launch import Kernel

_LL, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_ARGS = [_P] * 9 + [_LL, _LL, _I, _LL, _LL]
_MLP = Kernel("field_mlp", "field_mlp_fwd", _ARGS)
_MLP_F32 = Kernel("field_mlp", "field_mlp_fwd_f32", _ARGS)
# the kernel of each rounding
_KERNELS = {torch.bfloat16: _MLP, None: _MLP_F32}

# (num_layers, hidden_dim, geo_feat_dim, num_layers_color, hidden_dim_color,
# input_ch): the widths csrc/field_mlp.cu is written for; input_ch_views 16,
# or 0 without views
WIDTHS = (2, 64, 15, 3, 64, 32)
VIEWS = 16


def takes(cfg) -> bool:
    """Whether the kernel has NeRFSmall config cfg's widths."""
    return ((cfg.num_layers, cfg.hidden_dim, cfg.geo_feat_dim, cfg.num_layers_color,
             cfg.hidden_dim_color, cfg.input_ch) == WIDTHS
            and cfg.input_ch_views in (0, VIEWS))


def _rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _linear(a: torch.Tensor, w: torch.Tensor, rounding) -> torch.Tensor:
    if rounding is None:
        return F.linear(a, w)
    return F.linear(_rounded(a), _rounded(w))


_ORDERED_ROWS = 1 << 18


def _fma_f32(acc: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fmaf(a, w, acc) of float32 tensors, elementwise: the exact a * w + acc
    rounded once to float32.

    The product of two float32 values is exact in float64, and TwoSum gives
    the float64 sum s and its exact error e. Rounding s to float32 would
    round twice: it differs from one rounding where s lands exactly on a
    midpoint between two float32 values while e is not 0 (the tie then
    breaks to even, the exact sum lies to one side), about one addition in
    2^28. So s is first rounded to odd: where e is not 0 and s is even, s
    steps one float64 ulp toward the exact sum. A value rounded to odd with
    at least two more bits than float32's 24 rounds to float32 as the exact
    value does (Boldo and Melquiond, 2008)."""
    acc, p = acc.double(), a.double() * w.double()
    s = acc + p
    b = s - acc
    e = (acc - (s - b)) + (p - b)
    even = (s.view(torch.int64) & 1) == 0
    step = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def _ordered_linear(a: torch.Tensor, w: torch.Tensor, rounding) -> torch.Tensor:
    """_linear with each output the float32 chain acc = fmaf(a_k, w_k, acc)
    in k order from 0 (each product of bf16 values is exact in float32, so
    a bf16 step is one float32 addition). The float32 chain runs over
    _ORDERED_ROWS rows at a time: its float64 temporaries are 2 x float32's."""
    out = a.new_zeros((a.shape[0], w.shape[0]))
    if rounding is None:
        for r in range(0, a.shape[0], _ORDERED_ROWS):
            acc = out[r:r + _ORDERED_ROWS]
            for k in range(a.shape[1]):
                acc = _fma_f32(acc, a[r:r + _ORDERED_ROWS, k:k + 1], w[:, k])
            out[r:r + _ORDERED_ROWS] = acc
        return out
    a, w = _rounded(a), _rounded(w)
    for k in range(a.shape[1]):
        out = torch.addcmul(out, a[:, k:k + 1], w[:, k])
    return out


def _forward(x, views, S, keep, weights, linear):
    w0, w1, wc0, wc1, wc2 = weights
    h = linear(torch.relu(linear(x, w0)), w1)
    c = field_colour_input_fwd_plain(views, h, S)
    c = torch.relu(linear(torch.relu(linear(c, wc0)), wc1))
    return field_raw_fwd_plain(linear(c, wc2), h, keep)


def field_mlp_fwd_plain(x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                        keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor],
                        rounding: Optional[torch.dtype]):
    """Plain version of field_mlp_fwd: the PyTorch route's forward (each
    layer a float32 `linear`, of bf16-rounded input and weight where
    rounding is torch.bfloat16, a ReLU after every hidden layer, K9's
    colour input and field_raw's raw)."""
    return _forward(x, views, S, keep, weights, lambda a, w: _linear(a, w, rounding))


def field_mlp_fwd_ordered(x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                          keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor],
                          rounding: Optional[torch.dtype]):
    """The plain version with every sum in k order, as the kernel adds: the
    card's kernel equals it bit for bit (a few launches a k, for checks
    only)."""
    return _forward(x, views, S, keep, weights, lambda a, w: _ordered_linear(a, w, rounding))


def _check(name: str, x, views, S, weights):
    cv = 0 if views is None else VIEWS
    shapes = [(64, 32), (16, 64), (64, cv + 15), (64, 64), (3, 64)]
    N = x.shape[0] if x.dim() == 2 else -1
    if x.dim() != 2 or x.shape[1] != 32 or S < 1 or N % S:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (N, 32) at S = {S} samples a ray")
    if views is not None and tuple(views.shape) != (N // S, VIEWS):
        raise ValueError(f"{name}: views must be ({N // S}, {VIEWS}), got {tuple(views.shape)}")
    if len(weights) != 5 or any(tuple(w.shape) != s for w, s in zip(weights, shapes)):
        raise ValueError(f"{name}: weights must be {shapes}, got "
                         f"{[tuple(w.shape) for w in weights]}")


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t with adjacent columns, rows of whole 16-byte vectors and a
    16-byte aligned start (the kernel's float4 loads), copied if need be."""
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def field_mlp_fwd(x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                  keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor],
                  rounding: Optional[torch.dtype]) -> torch.Tensor:
    """raw (N, 4) = [rgb logits, keep ? sigma : 0] of NeRFSmall's forward on
    x (N, 32), views (N // S, 16) or None, keep (N,) or None, with operands
    rounded to `rounding` (torch.bfloat16, or None: float32); no gradient.
    An error names the C entry the call launches."""
    if rounding not in _KERNELS:
        raise ValueError(f"field_mlp_fwd: rounding {rounding} is neither torch.bfloat16 nor None")
    kernel = _KERNELS[rounding]
    name = kernel.entry
    _check(name, x, views, S, weights)
    N = x.shape[0]
    keep = keep_mask(name, keep, N)
    if device_of(name, [x, *weights, views, keep]) == "cpu":
        return field_mlp_fwd_plain(x, views, S, keep, weights, rounding)
    x = _rows16(x)
    views = None if views is None else _rows16(views)
    ws = [w.contiguous() for w in weights]
    raw = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    kernel(x.data_ptr(), None if views is None else views.data_ptr(),
           None if keep is None else keep.data_ptr(), *(w.data_ptr() for w in ws),
           raw.data_ptr(), N, S, 0 if views is None else VIEWS, x.stride(0),
           0 if views is None else views.stride(0), stream_of=x)
    return raw

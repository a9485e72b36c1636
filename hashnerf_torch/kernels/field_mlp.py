"""field_mlp: NeRFSmall's whole forward with bf16 operands, in one kernel.

No TPU kernel's counterpart: the JAX package's apply_nerf_small rounds each
layer's input and weight to bf16 and multiplies them in a float32 dot,
and XLA fuses the casts, ReLUs and concatenations into the dots. The port's
PyTorch route (models/nerf.py::NeRFSmall.forward_rays) writes each of
those as a pass of its own. For a call that takes no gradient (frames,
grid updates) NeRFSmall hands the whole forward to csrc/field_mlp.cu:

  field_mlp_fwd(x (N, 32), views (N // S, 16) or None, S, keep (N,) bool or
                None, weights (w0, w1, wc0, wc1, wc2))
      -> raw (N, 4) = [rgb logits, keep ? sigma : 0], float32.

The weights are nn.Linear's (out, in): the sigma net's (64, 32) and
(16, 64), the colour net's (64, Cv + 15), (64, 64) and (3, 64); the kernel
rounds them to bf16 as it stages them, on every call. `takes(cfg)` says
which NeRFSmall widths the kernel has.

Bound (csrc/field_mlp.cu): the float32 multiply-adds on the CUDA cores,
9,344 a point. Each output is the float32 sum of its exact bf16 products in
k order, one FMA after another from 0: the order of cuBLAS's float32 GEMM on
the PyTorch route, so that every hidden value rounds to the same bf16 value.
The kernel equals field_mlp_fwd_ordered, that arithmetic in PyTorch ops,
bit for bit; on the card the PyTorch route's GEMMs depart from that order
only in rare last bits. The launcher takes its plain version, the PyTorch
route's composition, only for CPU tensors; for CUDA tensors it launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hashnerf_torch.kernels import build
from hashnerf_torch.kernels.field_query import (
    _keep, _on_cpu, _stream, field_colour_input_fwd_plain, field_raw_fwd_plain,
)

_LL, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_P] * 9 + [_LL, _LL, _I, _LL, _LL, _P]

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


def _fn():
    fn = build.load("field_mlp").field_mlp_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _linear(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.linear(_rounded(a), _rounded(w))


def _ordered_linear(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """_linear with each output the float32 sum of its products in k order,
    one rounding an addition (each product of bf16 values is exact)."""
    a, w = _rounded(a), _rounded(w)
    out = a.new_zeros((a.shape[0], w.shape[0]))
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
                        keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor]):
    """Plain version of field_mlp_fwd: the PyTorch route's forward (each
    layer a float32 `linear` of bf16-rounded input and weight, a ReLU after
    every hidden layer, K9's colour input and field_raw's raw)."""
    return _forward(x, views, S, keep, weights, _linear)


def field_mlp_fwd_ordered(x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                          keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor]):
    """The plain version with every sum in k order, as the kernel adds: the
    card's kernel equals it bit for bit (one launch a k, for checks only)."""
    return _forward(x, views, S, keep, weights, _ordered_linear)


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
                  keep: Optional[torch.Tensor], weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """raw (N, 4) = [rgb logits, keep ? sigma : 0] of NeRFSmall's bf16
    forward on x (N, 32), views (N // S, 16) or None, keep (N,) or None;
    no gradient."""
    name = "field_mlp_fwd"
    _check(name, x, views, S, weights)
    N = x.shape[0]
    keep = _keep(name, keep, N)
    ts = [x, *weights] + ([] if views is None else [views]) + ([] if keep is None else [keep])
    if _on_cpu(name, ts):
        return field_mlp_fwd_plain(x, views, S, keep, weights)
    x = _rows16(x)
    views = None if views is None else _rows16(views)
    ws = [w.contiguous() for w in weights]
    raw = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), None if views is None else views.data_ptr(),
                None if keep is None else keep.data_ptr(), *(w.data_ptr() for w in ws),
                raw.data_ptr(), N, S, 0 if views is None else VIEWS, x.stride(0),
                0 if views is None else views.stride(0), _stream(x))
    build.check(err, name)
    field_mlp_fwd.launches += 1
    return raw


field_mlp_fwd.launches = 0

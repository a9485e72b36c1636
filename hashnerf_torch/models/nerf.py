"""The NeRF MLPs as nn.Modules: NeRFSmall, NeRF and NeRFGradient.

Counterparts of hashnerf_tpu/models/nerf.py:
  * NeRFSmall, the Instant-NGP-style tiny pair: a bias-free sigma net
    (num_layers x hidden_dim) to 1 + geo_feat_dim outputs, then a bias-free
    color net over [view encoding, geo features] to 3 rgb logits;
  * NeRF, the classic D x W trunk with biases, the encoded points concatenated
    back in after each layer in `skips`, then either the viewdir branch
    (alpha_linear and feature_linear on the trunk, one views_linears layer
    of W // 2 over [feature, views], rgb_linear) or output_linear;
  * NeRFGradient, NeRF with a gradient_linear head (W // 2 -> 3) beside
    rgb_linear: (N, 7) = [rgb, alpha, gradient].
Every MLP answers the field query through forward_rays(x, views, S,
keep): the encoded points (N, input_ch), one view encoding a ray (N // S,
input_ch_views) and the samples a ray S. NeRFSmall widens the views to the
samples inside K9's colour input (kernels/field_query.py); NeRF widens them
before its view branch. forward(x), on the points' and the views'
encodings side by side (the JAX package's call), is forward_rays with one
sample a ray.
Weights are nn.Linear's (out, in); the JAX package stores (in, out) (see
convert.py). Weights and biases are drawn from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), nn.Linear's default bound, from an explicit
torch.Generator. The products are plain float32 `F.linear`s, as JAX runs
them outside any Pallas kernel.

compute_dtype "bfloat16" or "float16" (or a float8 type) follows the JAX
package's compute mode: the input and the weight of each layer are rounded
to that type and multiplied with a float32 product, whose output is not
rounded; "float32" and "float64" run the float32 product
(compute_dtype_of). The port
writes that as a float32 `linear` of the rounded values (a product of two
bf16 or two f16 values is exact in float32); autograd's casts then round
the gradients of x and w to the compute type as JAX's transpose of the dot
does. A bf16 or f16 matmul would round its output.

A bf16 or float32 NeRFSmall at the widths kernels/field_mlp.py has
(32-64-16 / 31-64-64-3, views 16 or none) answers a call that autograd
records nothing for (a frame, a grid update) with that one kernel: the same
operands, each product's sum one float32 FMA after another in cuBLAS's k
order, so that a bf16 net's every hidden value rounds to the same bf16
value as on the route above. Every other call (a gradient, a float16 or
float8 net, other widths) takes the route above.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hashnerf_torch.kernels import field_mlp
from hashnerf_torch.kernels.field_query import field_colour_input, field_raw
from hashnerf_torch.utils.profiling import annotate, count


@dataclasses.dataclass(frozen=True)
class NeRFSmallConfig:
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    input_ch: int = 32
    input_ch_views: int = 16
    compute_dtype: Optional[str] = None  # None (float32) or a name compute_dtype_of takes


def _linear(fan_in: int, fan_out: int, generator, device, bias: bool = False) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out, bias=bias, device=device)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


# The floating types jnp.dtype names beyond numpy's (ml_dtypes'), with the
# torch type whose rounding is theirs (None: torch has no such type).
_ML_FLOATS = {name: getattr(torch, name, None) for name in (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz",
    "float8_e4m3b11fnuz", "float8_e3m4", "float8_e4m3", "float8_e8m0fnu", "float4_e2m1fn")}


def compute_dtype_of(name: Optional[str], what: str = "compute_dtype"):
    """The torch type an MLP's operands are rounded to under compute_dtype
    `name`, or None for the plain float32 product. Takes every floating
    type name jnp.dtype takes: float32 and its aliases ("f4", "single",
    ...) run the float32 product, as JAX's DEFAULT-precision float32 dot
    computes it off the TPU (on the card TF32 is off, hashnerf_torch/
    __init__.py); float64 ("double", "f8", ...) runs in float32 too, as
    JAX runs it without x64; float16 ("half", ...), bfloat16 and the
    float8 types torch has round the operands. A name numpy cannot parse
    raises TypeError (as jnp.dtype does), float128 TypeError (as JAX's
    astype does); a type that is not floating, or that torch cannot
    represent, raises ValueError."""
    if name is None:
        return None
    if name in _ML_FLOATS:
        if _ML_FLOATS[name] is None:
            raise ValueError(f"{what} {name!r}: torch has no {name} type to round to")
        return _ML_FLOATS[name]
    d = np.dtype(name)
    if d.kind != "f":
        raise ValueError(f"{what} {name!r}: {d} is not a floating type")
    if d.itemsize > 8:
        raise TypeError(f"{what} {name!r}: JAX only supports number, bool, and string dtypes, "
                        f"got dtype {d}")
    return torch.float16 if d.itemsize == 2 else None


def _apply(layer: nn.Linear, h: torch.Tensor, dtype) -> torch.Tensor:
    """layer(h) in float32, or with input and weight rounded to dtype (the
    bias is added in float32, as JAX adds it)."""
    if dtype is None:
        return layer(h)
    return F.linear(h.to(dtype).float(), layer.weight.to(dtype).float(), layer.bias)


class NeRFSmall(nn.Module):
    def __init__(
        self,
        cfg: NeRFSmallConfig,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.cfg = cfg
        sigma = []
        for l in range(cfg.num_layers):
            in_dim = cfg.input_ch if l == 0 else cfg.hidden_dim
            out_dim = 1 + cfg.geo_feat_dim if l == cfg.num_layers - 1 else cfg.hidden_dim
            sigma.append(_linear(in_dim, out_dim, generator, device))
        color = []
        for l in range(cfg.num_layers_color):
            in_dim = cfg.input_ch_views + cfg.geo_feat_dim if l == 0 else cfg.hidden_dim
            out_dim = 3 if l == cfg.num_layers_color - 1 else cfg.hidden_dim_color
            color.append(_linear(in_dim, out_dim, generator, device))
        self.sigma_net = nn.ModuleList(sigma)
        self.color_net = nn.ModuleList(color)
        self._dtype = compute_dtype_of(cfg.compute_dtype, "NeRFSmall: compute_dtype")
        # bf16 or float32 operands at the widths csrc/field_mlp.cu has: a
        # forward that takes no gradient runs as that one kernel
        self._fused = self._dtype in (torch.bfloat16, None) and field_mlp.takes(cfg)

    def _layer(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        return _apply(layer, h, self._dtype)

    def _records_grad(self, x: torch.Tensor, views: Optional[torch.Tensor]) -> bool:
        """Whether autograd records a forward on x and views."""
        return torch.is_grad_enabled() and (
            x.requires_grad or (views is not None and views.requires_grad)
            or any(p.requires_grad for p in self.parameters()))

    def forward_rays(self, x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, input_ch) encoded points, S samples a ray; views (N // S,
        input_ch_views), one view encoding a ray, or None; keep (N,) bool or
        None -> (N, 4) = [rgb logits, keep ? sigma : 0]. The sigma net
        multiplies x as it is; K9 (kernels/field_query.py) widens the views
        to the samples in the colour net's input, and field_raw writes the
        raw. A bf16 or float32 net whose call autograd records nothing for
        (grad mode off, or nothing requiring a gradient) runs the whole
        forward as kernels/field_mlp.py's one kernel instead, which saves no
        activations, and counts its N points as `mlp_fused_points`."""
        cfg = self.cfg
        if self._fused and not self._records_grad(x, views):
            count("mlp_fused_points", x.shape[0])
            return field_mlp.field_mlp_fwd(
                x, views, S, keep, [l.weight for l in [*self.sigma_net, *self.color_net]],
                self._dtype)
        h = x
        for l, layer in enumerate(self.sigma_net):
            h = self._layer(layer, h)
            if l != cfg.num_layers - 1:
                h = torch.relu(h)
        # h = [sigma, geo_feat]
        c = field_colour_input(views, h, S)
        for l, layer in enumerate(self.color_net):
            c = self._layer(layer, c)
            if l != cfg.num_layers_color - 1:
                c = torch.relu(c)
        return field_raw(c, h, keep)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., input_ch + input_ch_views) -> (..., 4) = [rgb logits,
        sigma]: forward_rays on one sample a ray."""
        cfg = self.cfg
        flat = x.reshape(-1, x.shape[-1])
        raw = self.forward_rays(flat[:, : cfg.input_ch],
                                flat[:, cfg.input_ch : cfg.input_ch + cfg.input_ch_views], 1)
        return raw.reshape(x.shape[:-1] + (4,))


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    input_ch: int = 3
    input_ch_views: int = 3
    output_ch: int = 4
    skips: Sequence[int] = (4,)
    use_viewdirs: bool = False
    compute_dtype: Optional[str] = None  # None (float32) or a name compute_dtype_of takes


class NeRF(nn.Module):
    """x (N, input_ch + input_ch_views) -> (N, 4) = [rgb logits, alpha] with
    use_viewdirs, else (N, output_ch)."""

    def __init__(self, cfg: NeRFConfig, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        W = cfg.W
        lin = lambda i, o: _linear(i, o, generator, device, bias=True)
        self.pts_linears = nn.ModuleList(
            [lin(cfg.input_ch, W)]
            + [lin(W + cfg.input_ch if i in cfg.skips else W, W) for i in range(cfg.D - 1)]
        )
        if cfg.use_viewdirs:
            self.views_linears = nn.ModuleList([lin(cfg.input_ch_views + W, W // 2)])
            self.feature_linear = lin(W, W)
            self.alpha_linear = lin(W, 1)
            self.rgb_linear = lin(W // 2, 3)
        else:
            self.output_linear = lin(W, cfg.output_ch)
        self._dtype = compute_dtype_of(cfg.compute_dtype, f"{type(self).__name__}: compute_dtype")

    def _heads(self, h: torch.Tensor) -> list:
        """The outputs of the viewdir branch's last hidden layer h."""
        return [_apply(self.rgb_linear, h, self._dtype)]

    def forward_rays(self, x: torch.Tensor, views: Optional[torch.Tensor], S: int,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, input_ch) encoded points, S samples a ray; views (N // S,
        input_ch_views), one view encoding a ray, or None. The views are
        widened to the samples, as the concatenated input carried them. The
        NeRF family's encoders keep every point: keep must be None. The D
        trunk layers and the skip concatenations run in an `hn.mlp.trunk`
        span, the view branch (feature, alpha, the widened views, the view
        layers, the heads) in `hn.mlp.views`."""
        if keep is not None:
            raise ValueError(f"{type(self).__name__}: no keep mask (its encoders keep every point)")
        cfg, dt = self.cfg, self._dtype
        pts = h = x
        with annotate("hn.mlp.trunk"):
            for i, layer in enumerate(self.pts_linears):
                h = torch.relu(_apply(layer, h, dt))
                if i in cfg.skips:
                    h = torch.cat([pts, h], dim=-1)
        if not cfg.use_viewdirs:
            return _apply(self.output_linear, h, dt)
        with annotate("hn.mlp.views"):
            if views is not None and S > 1:
                views = views.repeat_interleave(S, dim=0)
            alpha = _apply(self.alpha_linear, h, dt)
            h = torch.cat([_apply(self.feature_linear, h, dt), views], dim=-1)
            for layer in self.views_linears:
                h = torch.relu(_apply(layer, h, dt))
            rgb, *rest = self._heads(h)
            return torch.cat([rgb, alpha] + rest, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., input_ch + input_ch_views), the points' and the views'
        encodings side by side: forward_rays on one sample a ray."""
        cfg = self.cfg
        return self.forward_rays(x[..., : cfg.input_ch],
                                 x[..., cfg.input_ch : cfg.input_ch + cfg.input_ch_views], 1)


class NeRFGradient(NeRF):
    """NeRF with a gradient head: (N, 7) = [rgb logits, alpha, gradient]
    with use_viewdirs (without it, NeRF's output_linear alone)."""

    def __init__(self, cfg: NeRFConfig, generator: Optional[torch.Generator] = None, device=None):
        super().__init__(cfg, generator, device)
        if cfg.use_viewdirs:
            self.gradient_linear = _linear(cfg.W // 2, 3, generator, device, bias=True)

    def _heads(self, h: torch.Tensor) -> list:
        return [_apply(self.rgb_linear, h, self._dtype), _apply(self.gradient_linear, h, self._dtype)]


@torch.no_grad()
def load_nerf_weights_from_keras(model: NeRF, weights) -> NeRF:
    """Copy the original TF-NeRF Keras weight list into `model` in place.
    The list alternates [W (in, out), b] per layer in the order
    pts_linears, feature_linear, views_linears[0], rgb_linear, alpha_linear
    (the JAX package's load_nerf_weights_from_keras); each W goes in
    transposed. Needs use_viewdirs."""
    cfg = model.cfg
    if not cfg.use_viewdirs:
        raise NotImplementedError("Keras import requires use_viewdirs=True")
    layers = list(model.pts_linears) + [model.feature_linear, model.views_linears[0],
                                        model.rgb_linear, model.alpha_linear]
    for k, layer in enumerate(layers):
        w = np.asarray(weights[2 * k], dtype=np.float32).T
        b = np.asarray(weights[2 * k + 1], dtype=np.float32).reshape(-1)
        if tuple(layer.weight.shape) != w.shape or tuple(layer.bias.shape) != b.shape:
            raise ValueError(f"Keras layer {k}: {w.shape} / {b.shape}, the model has "
                             f"{tuple(layer.weight.shape)} / {tuple(layer.bias.shape)}")
        layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        layer.bias.copy_(torch.from_numpy(b))
    return model

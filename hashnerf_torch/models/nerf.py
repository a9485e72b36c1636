"""NeRFSmall, the Instant-NGP-style tiny MLP pair, as an nn.Module.

Counterpart of NeRFSmall in hashnerf_tpu/models/nerf.py: a bias-free sigma
net (num_layers x hidden_dim) to 1 + geo_feat_dim outputs, then a bias-free
color net over [view encoding, geo features] to 3 rgb logits. Weights are
nn.Linear's (out, in); the JAX package stores (in, out) (see convert.py).
Init is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), nn.Linear's default bound,
drawn from an explicit torch.Generator.

compute_dtype "bfloat16" follows the JAX package's bf16 compute mode: the
input and the weight of each layer are rounded to bf16 and multiplied with
a float32 product, whose output is not rounded. The port writes that as a
float32 `linear` of the rounded values (products of bf16 values are exact in
float32); autograd's casts then round the gradients of x and w to bf16 as
JAX's transpose of the bf16 dot does. A bf16 matmul would round its output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class NeRFSmallConfig:
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    input_ch: int = 32
    input_ch_views: int = 16
    compute_dtype: Optional[str] = None  # None (float32) or "bfloat16"


def _linear(fan_in: int, fan_out: int, generator, device) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out, bias=False, device=device)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
    return lin


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
        if cfg.compute_dtype not in (None, "bfloat16"):
            raise NotImplementedError(
                f"NeRFSmall: compute_dtype {cfg.compute_dtype!r} is not ported (ROADMAP A7.4)"
            )

    def _layer(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.compute_dtype is None:
            return layer(h)
        bf16 = torch.bfloat16
        return F.linear(h.to(bf16).float(), layer.weight.to(bf16).float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, input_ch + input_ch_views) -> (N, 4) = [rgb logits, sigma]."""
        cfg = self.cfg
        h = x[..., : cfg.input_ch]
        views = x[..., cfg.input_ch : cfg.input_ch + cfg.input_ch_views]
        for l, layer in enumerate(self.sigma_net):
            h = self._layer(layer, h)
            if l != cfg.num_layers - 1:
                h = torch.relu(h)
        sigma, geo_feat = h[..., :1], h[..., 1:]

        h = torch.cat([views, geo_feat], dim=-1)
        for l, layer in enumerate(self.color_net):
            h = self._layer(layer, h)
            if l != cfg.num_layers_color - 1:
                h = torch.relu(h)
        return torch.cat([h, sigma], dim=-1)

"""Volume-rendering integrator: raw network outputs -> pixel maps.

Counterpart of hashnerf_tpu/ops/volume.py: alpha = 1 - exp(-relu(sigma) *
dist), transmittance by the exclusive cumprod of (1 - alpha + 1e-10),
white-background compositing, the entropy-of-weights sparsity term, and the
depth denominator clamped at 1e-10.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod along the last axis of an input with no zero entry.

    The backward is PyTorch's own formula for that case, the reversed
    cumsum of output * grad over the input, without the host read of
    `(input == 0).any()` by which PyTorch picks it: a CUDA graph can capture
    it. The transmittance's factors are at least 1e-10."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1) / x


class VolumeOutputs(NamedTuple):
    rgb_map: torch.Tensor  # (N_rays, 3)
    disp_map: torch.Tensor  # (N_rays,)
    acc_map: torch.Tensor  # (N_rays,)
    weights: torch.Tensor  # (N_rays, N_samples)
    depth_map: torch.Tensor  # (N_rays,)
    sparsity_loss: torch.Tensor  # (N_rays,)


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dists: Optional[torch.Tensor] = None,
) -> VolumeOutputs:
    """raw: (N_rays, N_samples, C>=4); channels [:3] rgb logits, [3] sigma.

    With raw_noise_std > 0 the sigma noise is `noise` (a standard-normal
    draw of sigma's shape) when given, else drawn from `generator`.
    `dists` (z units, z_vals' shape) replaces the forward differences with
    their 1e10 tail: per-ray culling composites the kept samples with their
    original intervals.
    """
    if dists is None:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(
                sigma.shape, generator=generator, device=sigma.device, dtype=sigma.dtype
            )
        sigma = sigma + noise * raw_noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = _CumprodNonzero.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1)
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, -1)
    depth_map = torch.sum(weights * z_vals, -1) / torch.clamp(acc_map, min=1e-10)
    disp_map = 1.0 / torch.clamp(depth_map, min=1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    # Entropy sparsity with torch Categorical semantics: normalize, clamp
    # to [tiny, 1 - eps] before the log.
    residual = 1.0 - acc_map[..., None] + 1e-6
    p = torch.cat([weights, residual], dim=-1)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    fi = torch.finfo(p.dtype)
    logp = torch.log(torch.clamp(p, fi.tiny, 1.0 - fi.eps))
    sparsity_loss = -torch.sum(p * logp, dim=-1)

    return VolumeOutputs(rgb_map, disp_map, acc_map, weights, depth_map, sparsity_loss)

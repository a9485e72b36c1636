"""Ray-march z-value samplers: stratified and hierarchical (inverse-CDF).

Counterpart of hashnerf_tpu/ops/sampling.py (stratified_z_vals,
perturb_z_vals, sample_pdf, and fast_merge's sorted_uniform and
merge_sorted). Every random draw can be handed in as a
tensor (`t_rand=`, `u=`) instead of being drawn from a torch.Generator, so
tests can feed both packages the same numbers.
"""
from __future__ import annotations

from typing import Optional

import torch


def linspace01(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """n points from 0 to 1 as jnp.linspace(0, 1, n) defines them in float32:
    i / (n - 1) for i < n - 1, then exactly 1. torch.linspace rounds
    differently (2 of 8 values, 30 of 64 differ by an ulp). XLA's jit turns
    the division into a product with the reciprocal, which rounds otherwise
    again; the port follows the JAX source, as the JAX package runs it op by
    op. The divisor is a tensor: CUDA PyTorch would take a Python number's
    reciprocal too."""
    if n == 1:
        return torch.zeros(1, device=device, dtype=dtype)
    i = torch.arange(n - 1, device=device, dtype=dtype)
    t = i / torch.full_like(i, float(n - 1))
    return torch.cat([t, torch.ones(1, device=device, dtype=dtype)])


def stratified_z_vals(
    near: torch.Tensor, far: torch.Tensor, N_samples: int, lindisp: bool = False
) -> torch.Tensor:
    """Deterministic z-values linear in depth (or inverse depth);
    near/far (N_rays,) -> (N_rays, N_samples)."""
    near = near.reshape(-1, 1)
    far = far.reshape(-1, 1)
    t_vals = linspace01(N_samples, device=near.device, dtype=near.dtype)
    if not lindisp:
        return near * (1.0 - t_vals) + far * t_vals
    return 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)


def perturb_z_vals(
    z_vals: torch.Tensor,
    t_rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stratified jitter of z-values within their mid-point intervals;
    t_rand (U[0,1) of z_vals' shape) is drawn from `generator` if not given."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t_rand is None:
        t_rand = torch.rand(
            z_vals.shape, generator=generator, device=z_vals.device, dtype=z_vals.dtype
        )
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    N_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    tap=None,
) -> torch.Tensor:
    """Inverse-transform sampling from the piecewise-constant weight PDF.

    bins: (N_rays, M) bin edges; weights: (N_rays, M-1).
    Returns (N_rays, N_samples). `u` overrides the uniform draws. A `tap`
    (utils/debug.py::StageTap) records the search and its denominators.
    """
    weights = weights + 1e-5  # prevent nans
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # (N_rays, M)

    if u is None:
        shape = cdf.shape[:-1] + (N_samples,)
        if det:
            u = linspace01(N_samples, device=cdf.device, dtype=cdf.dtype)
            u = u.expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device, dtype=cdf.dtype)
    u = u.contiguous()

    # cdf is non-decreasing, so searchsorted(right=True) equals the count of
    # cdf entries <= u, as the JAX version computes it.
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    switched = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / switched
    z = bins_below + t * (bins_above - bins_below)
    if tap is not None:
        tap.record("sample_pdf", bins=bins, u=u, cdf=cdf, inds=inds, below=below, above=above,
                   denom=denom, z=z)
    return z


def sorted_uniform(shape, generator: Optional[torch.Generator] = None, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Sorted iid U(0,1) along the last axis, without a sort: with E_1 ...
    E_{n+1} ~ Exp(1), the partial sums of E over their total are
    distributed as the order statistics of n uniforms."""
    *lead, n = shape
    e = torch.empty((*lead, n + 1), device=device, dtype=dtype).exponential_(generator=generator)
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows a (..., n) and b (..., m) merged into sorted (..., n + m).

    JAX places each element by rank (its index plus the count of the other
    row's elements before it, ties a first) to avoid a sort network on the
    TPU. On values the merge equals the sorted concatenation, ties
    included, so the port takes one segmented sort instead of the rank
    merge's two (..., n, m) comparisons and its scatter."""
    return torch.sort(torch.cat([a, b], -1), dim=-1).values

"""Pinhole ray generation and the ray-bbox clip.

Counterpart of get_rays / get_rays_at / get_rays_np / ray_aabb_near_far in
hashnerf_tpu/ops/rays.py. The NDC
warp, camera-frame direction fields and equirect directions come with the
loaders that use them (ROADMAP A1/A6).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_rays(H: int, W: int, K, c2w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays for a full image; K (3, 3), c2w (3, 4) or (4, 4) tensors.

    Returns rays_o, rays_d, each (H, W, 3); directions are not normalized.
    The rotation is a float32 multiply-and-sum, never a TF32 product.
    """
    K = torch.as_tensor(K, dtype=torch.float32)
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=dev),
        torch.arange(H, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    K = K.to(dev)
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)], -1
    )
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_at(K: torch.Tensor, c2w: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays at the pixels (ys, xs) only, as get_rays computes them
    for the whole image: K (3, 3) and c2w (3, 4) tensors on the pixels'
    device, ys and xs (N,) integer tensors -> rays_o, rays_d, each (N, 3).
    The training step draws its pixels first, so it never builds H x W rays."""
    i = xs.to(torch.float32)
    j = ys.to(torch.float32)
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)], -1
    )
    rays_d = torch.sum(dirs[:, None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of get_rays for host-side scene construction."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], np.shape(rays_d))
    return rays_o, rays_d


def ray_aabb_near_far(rays_o, rays_d, bbox, near, far):
    """Tighten per-ray [near, far] to the ray's bbox intersection (slab test).

    rays_o/rays_d (R, 3), bbox (2, 3), near/far (R,) -> (near', far'). A ray
    that misses the bbox collapses to [near, near + 1e-3]: its samples lie
    outside the bbox, get sigma 0 and stay transparent. A direction component
    with |d| <= 1e-10 counts as 1e10 in the inverse.
    """
    inv = torch.where(rays_d.abs() > 1e-10, 1.0 / rays_d, torch.full_like(rays_d, 1e10))
    t1 = (bbox[0] - rays_o) * inv
    t2 = (bbox[1] - rays_o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    lo = torch.minimum(torch.maximum(tmin, near), far)
    hi = torch.minimum(torch.maximum(tmax, near), far)
    hit = tmax > torch.clamp(tmin, min=0.0)
    new_near = torch.where(hit, lo, near)
    new_far = torch.where(hit, torch.maximum(hi, lo + 1e-4), near + 1e-3)
    return new_near, new_far

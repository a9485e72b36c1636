"""Pinhole ray generation and the ray-bbox clip.

Counterpart of get_rays / get_rays_at / get_rays_np / get_directions /
ray_from_directions / get_ndc_rays / equirect_directions /
ray_aabb_near_far in hashnerf_tpu/ops/rays.py.
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


def get_directions(H: int, W: int, focal: float) -> np.ndarray:
    """Camera-frame direction field (H, W, 3) for the bbox of the camera
    frusta: float64 pixel grids (no +0.5 centering), then float32."""
    xs = np.linspace(0, W - 1, W, dtype=np.float64)
    ys = np.linspace(0, H - 1, H, dtype=np.float64)
    i, j = np.meshgrid(xs, ys)
    return np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1
    ).astype(np.float32)


def ray_from_directions(directions: np.ndarray, c2w: np.ndarray):
    """World-space origins and normalized directions of one camera, each
    (H * W, 3)."""
    c2w = np.asarray(c2w, dtype=np.float32)
    rays_d = directions @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def get_ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Warp rays into the NDC space of a forward-facing scene: the ray is
    moved to the near plane z = -near, then projected. Takes torch tensors
    (on any device, and inside a captured graph) or numpy arrays, as the JAX
    function takes jnp or np. Each division is a division of two arrays, as
    JAX computes it (PyTorch would compute `2 * near / z` as a product with
    the reciprocal of z); the factors -1 / (W / (2 f)) are Python floats in
    both."""
    if isinstance(rays_o, torch.Tensor):
        stack = torch.stack

        def two_near_over(z):
            return torch.full_like(z, 2.0 * near) / z
    else:
        stack = np.stack

        def two_near_over(z):
            return 2.0 * near / z

    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + two_near_over(rays_o[..., 2])

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return stack([o0, o1, o2], -1), stack([d0, d1, d2], -1)


def equirect_directions(H: int, W: int) -> np.ndarray:
    """(H, W, 3) float32 unit directions of an equirectangular panorama
    (st3d): row x has latitude theta = (1 - 2x/H) pi/2, column y longitude
    phi = 2 pi (0.5 - y/W); direction [cos t cos p, sin t, -cos t sin p]
    (y up), in float64, then float32."""
    x = np.arange(H, dtype=np.float64)[:, None]
    y = np.arange(W, dtype=np.float64)[None, :]
    theta = (1.0 - 2.0 * x / H) * np.pi / 2.0
    phi = 2.0 * np.pi * (0.5 - y / W)
    a0 = np.cos(theta) * np.cos(phi)
    a1 = np.broadcast_to(np.sin(theta), (H, W))
    a2 = -np.cos(theta) * np.sin(phi)
    return np.stack([a0, a1, a2], axis=-1).astype(np.float32)


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

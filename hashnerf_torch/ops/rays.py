"""Pinhole ray generation.

Counterpart of get_rays / get_rays_np in hashnerf_tpu/ops/rays.py. The NDC
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


def get_rays_np(H: int, W: int, K, c2w) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of get_rays for host-side scene construction."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], np.shape(rays_d))
    return rays_o, rays_d

"""Scene bounding box from the train cameras' frusta.

Counterpart of get_bbox3d_for_blenderobj in hashnerf_tpu/ops/bbox.py: the
corner rays of each train camera, at near and far, padded by 1. The LLFF
box comes with the LLFF loader (ROADMAP A6).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from hashnerf_torch.ops.rays import get_directions, ray_from_directions


def _corner_indices(H: int, W: int):
    return [0, W - 1, H * W - W, H * W - 1]


def get_bbox3d_for_blenderobj(
    camera_transforms: dict, H: int, W: int, near: float = 2.0, far: float = 6.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(min (3,), max (3,)) float32 over every frame's four corner rays at
    near and far, padded by 1."""
    camera_angle_x = float(camera_transforms["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    directions = get_directions(H, W, focal)

    min_bound = np.array([100.0, 100.0, 100.0])
    max_bound = np.array([-100.0, -100.0, -100.0])
    corners = _corner_indices(H, W)
    for frame in camera_transforms["frames"]:
        c2w = np.array(frame["transform_matrix"], dtype=np.float32)
        rays_o, rays_d = ray_from_directions(directions, c2w)
        o, d = rays_o[corners], rays_d[corners]
        pts = np.concatenate([o + near * d, o + far * d], axis=0)
        min_bound = np.minimum(min_bound, pts.min(axis=0))
        max_bound = np.maximum(max_bound, pts.max(axis=0))

    return (
        (min_bound - 1.0).astype(np.float32),
        (max_bound + 1.0).astype(np.float32),
    )

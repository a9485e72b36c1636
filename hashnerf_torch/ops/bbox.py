"""Scene bounding box from the train cameras' frusta.

Counterpart of hashnerf_tpu/ops/bbox.py, numpy on the host:
get_bbox3d_for_blenderobj (the corner rays of each train camera at near and
far, padded by 1) and get_bbox3d_for_llff (the same corners warped to NDC,
padded by (0.1, 0.1, 1e-4)).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from hashnerf_torch.ops.rays import get_directions, get_ndc_rays, ray_from_directions


def _corner_indices(H: int, W: int):
    return [0, W - 1, H * W - W, H * W - 1]


def _corner_bounds(poses, H: int, W: int, focal: float, near: float, far: float, ndc: bool):
    """(min (3,), max (3,)) float64 over each c2w's four corner rays (warped
    to NDC when ndc) at near and far."""
    directions = get_directions(H, W, focal)
    min_bound = np.array([100.0, 100.0, 100.0])
    max_bound = np.array([-100.0, -100.0, -100.0])
    corners = _corner_indices(H, W)
    for c2w in poses:
        rays_o, rays_d = ray_from_directions(directions, c2w)
        if ndc:
            rays_o, rays_d = get_ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        o, d = rays_o[corners], rays_d[corners]
        pts = np.concatenate([o + near * d, o + far * d], axis=0)
        min_bound = np.minimum(min_bound, pts.min(axis=0))
        max_bound = np.maximum(max_bound, pts.max(axis=0))
    return min_bound, max_bound


def get_bbox3d_for_blenderobj(
    camera_transforms: dict, H: int, W: int, near: float = 2.0, far: float = 6.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(min (3,), max (3,)) float32 over every frame's four corner rays at
    near and far, padded by 1."""
    camera_angle_x = float(camera_transforms["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    poses = [np.array(f["transform_matrix"], dtype=np.float32) for f in camera_transforms["frames"]]
    min_bound, max_bound = _corner_bounds(poses, H, W, focal, near, far, ndc=False)
    return (
        (min_bound - 1.0).astype(np.float32),
        (max_bound + 1.0).astype(np.float32),
    )


def get_bbox3d_for_llff(
    poses: np.ndarray, hwf, near: float = 0.0, far: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(min (3,), max (3,)) float32 over every pose's four corner rays,
    warped to NDC, at near and far, padded by (0.1, 0.1, 1e-4)."""
    H, W, focal = hwf
    min_bound, max_bound = _corner_bounds(np.asarray(poses, dtype=np.float32), int(H), int(W),
                                          focal, near, far, ndc=True)
    pad = np.array([0.1, 0.1, 0.0001])
    return (
        (min_bound - pad).astype(np.float32),
        (max_bound + pad).astype(np.float32),
    )

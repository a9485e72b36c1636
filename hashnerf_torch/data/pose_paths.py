"""Numpy copy of hashnerf_tpu/data/pose_paths.py (the port imports nothing of
the JAX package).

Demo-path pose generators shared by loaders.
"""
from __future__ import annotations

import numpy as np


def trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def rot_phi(phi):
    return np.array(
        [
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rot_theta(th):
    return np.array(
        [
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera on a sphere looking at the origin; angles in degrees."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
        )
        @ c2w
    )
    return c2w


def spherical_render_poses(n: int = 40, phi: float = -30.0, radius: float = 4.0):
    """n poses on a ring at phi=-30, r=4."""
    return np.stack(
        [
            pose_spherical(angle, phi, radius)
            for angle in np.linspace(-180, 180, n + 1)[:-1]
        ],
        0,
    )

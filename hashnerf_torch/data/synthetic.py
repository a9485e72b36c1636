"""Numpy copy of hashnerf_tpu/data/synthetic.py (the port imports nothing of
the JAX package).

Procedural test scenes: analytically ray-traced, no file dependencies.

Gives trainable ground-truth images for smoke tests, benchmarks, and quality
curves (no real datasets exist in this environment). Cameras sit on the
blender-style spherical ring (r=4, looking at the origin), so the scenes
exercise the same geometry path as nerf-synthetic (near=2, far=6,
blender-style bbox).

Scenes:
  * "sphere": one Lambertian sphere with normal-coloured albedo (the round-1/2
    quality scene);
  * "multi": four spheres with procedural textures (checker / sinusoid /
    rings) + mirror-ish highlights — harder geometry + appearance so PSNR
    discriminates between execution configs (VERDICT r2: the single sphere
    saturates).

Anti-aliasing: ground truth is rendered at `ss`x supersampling and
box-downsampled (default ss=3). A 1-sample-per-pixel GT has hard jagged
edges that NO radiance field can reproduce consistently across viewpoints —
it caps achievable test PSNR well below 30 dB regardless of model quality
(observed r2: train 35.8 dB vs test 28.3 dB). The reference's own quality
protocol uses photographic/renderered datasets, which are band-limited by
the camera/renderer; ss=3 restores that property here.
"""
from __future__ import annotations

import numpy as np

from hashnerf_torch.data.scene import Scene
from hashnerf_torch.data.pose_paths import pose_spherical, spherical_render_poses
from hashnerf_torch.ops.rays import get_rays_np

_LIGHT = np.asarray([0.5, 0.5, 0.7])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)

# (center, radius) of the "multi" scene spheres — all inside the ±1.6 bbox
_MULTI_SPHERES = (
    (np.array([0.0, 0.0, 0.35]), 0.75),
    (np.array([-0.85, 0.55, -0.55]), 0.45),
    (np.array([0.8, -0.35, -0.6]), 0.5),
    (np.array([0.15, 0.95, -0.75]), 0.3),
)


def _albedo(kind: int, p: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Procedural textures; p = hit point, n = unit normal. Returns (..., 3)."""
    if kind == 0:  # normal-coloured (the classic sphere scene look)
        return 0.5 + 0.5 * n
    if kind == 1:  # checker in surface angle
        u = np.floor(4 * np.arctan2(n[..., 1], n[..., 0]) / np.pi)
        v = np.floor(6 * np.arccos(np.clip(n[..., 2], -1, 1)) / np.pi)
        c = ((u + v) % 2)[..., None]
        return c * np.array([0.9, 0.25, 0.2]) + (1 - c) * np.array([0.95, 0.85, 0.3])
    if kind == 2:  # sinusoid stripes in world z
        s = 0.5 + 0.5 * np.sin(14.0 * p[..., 2])
        return np.stack([0.2 + 0.6 * s, 0.4 + 0.3 * (1 - s), 0.8 - 0.5 * s], -1)
    # rings in world x-y radius
    r = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    s = (np.floor(8 * r) % 2)[..., None]
    return s * np.array([0.2, 0.7, 0.4]) + (1 - s) * np.array([0.9, 0.9, 0.95])


def _trace(o, d, spheres, kinds, specular=False):
    """Nearest-hit Lambertian (+ optional Blinn highlight) over spheres.
    o, d: (..., 3) with d unit. Returns (..., 3) in [0, 1], white background."""
    sh = o.shape[:-1]
    best_t = np.full(sh, np.inf)
    img = np.ones(sh + (3,), np.float32)
    for (c, rad), kind in zip(spheres, kinds):
        oc = o - c
        b = np.sum(oc * d, -1)
        cc = np.sum(oc * oc, -1) - rad**2
        disc = b * b - cc
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 1e-3) & (t < best_t)
        if not hit.any():
            continue
        p = o + t[..., None] * d
        n = (p - c) / rad
        lam = np.clip(np.sum(n * _LIGHT, -1), 0, 1)
        shade = _albedo(kind, p, n) * (0.2 + 0.8 * lam[..., None])
        if specular:
            h = _LIGHT - d
            h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
            spec = np.clip(np.sum(n * h, -1), 0, 1) ** 40
            shade = shade + 0.35 * spec[..., None]
        img = np.where(hit[..., None], np.clip(shade, 0, 1), img)
        best_t = np.where(hit, t, best_t)
    return img.astype(np.float32)


def _render_view(H, W, K, c2w, scene_kind: str, ss: int):
    """Ray-trace one view at `ss`x supersampling, box-downsample to (H, W)."""
    Hs, Ws = H * ss, W * ss
    Ks = np.array(
        [[K[0][0] * ss, 0, K[0][2] * ss], [0, K[1][1] * ss, K[1][2] * ss], [0, 0, 1]]
    )
    o, d = get_rays_np(Hs, Ws, Ks, c2w)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    if scene_kind == "sphere":
        img = _trace(o, d, ((np.zeros(3), 1.0),), (0,), specular=False)
    else:
        img = _trace(o, d, _MULTI_SPHERES, (1, 2, 3, 0), specular=True)
    if ss > 1:
        img = img.reshape(H, ss, W, ss, 3).mean(axis=(1, 3))
    return img.astype(np.float32)


def make_synthetic_scene(
    H: int = 64,
    W: int = 64,
    n_train: int = 12,
    n_test: int = 4,
    scene: str = "sphere",
    ss: int = 3,
) -> Scene:
    focal = 0.5 * W / np.tan(0.5 * 0.6911)  # blender-lego-like fov
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])

    n_total = n_train + n_test + 1
    angles = np.linspace(-180, 180, n_total + 1)[:-1]
    poses = np.stack([pose_spherical(a, -30.0, 4.0) for a in angles], 0)
    images = np.stack(
        [_render_view(H, W, K, p[:3, :4], scene, ss) for p in poses], 0
    )

    idx = np.arange(n_total)
    bbox = (
        np.array([-1.6, -1.6, -1.6], np.float32),
        np.array([1.6, 1.6, 1.6], np.float32),
    )
    return Scene(
        images=images,
        poses=poses[:, :3, :4].astype(np.float32),
        render_poses=spherical_render_poses(8),
        hwf=(H, W, focal),
        K=K,
        i_train=idx[:n_train],
        i_val=idx[n_train : n_train + 1],
        i_test=idx[n_train : n_train + n_test],
        near=2.0,
        far=6.0,
        bounding_box=bbox,
    )

"""The "ring" scene kind (a configuration's default), made on the device.

The repository holds no nerf_synthetic data, so the scene is procedural: a
copy of the port's "multi" scene (hashnerf_torch/data/synthetic.py) in
torch, so that it is traced on the card in well under a second. Four
textured spheres (checker, sinusoid stripes, rings, normal colours) with a
Blinn highlight, on a white background, seen by cameras on the blender ring
(radius 4, elevation -30 degrees, looking at the origin, field of view
0.6911). Ground truth is traced at ss x ss samples a pixel and
box-averaged. The spiral of render poses is the blender loader's: n poses
on the same ring.

The scene is the same for every seed: the seed draws the weights and the
program's rays, not the images. It does not set "ndc".
"""
from __future__ import annotations

import math

import numpy as np
import torch

FOV = 0.6911
_LIGHT = (0.5, 0.5, 0.7)
# (centre, radius, texture) of the four spheres, all inside the +-1.6 box
_SPHERES = (
    ((0.0, 0.0, 0.35), 0.75, 1),
    ((-0.85, 0.55, -0.55), 0.45, 2),
    ((0.8, -0.35, -0.6), 0.5, 3),
    ((0.15, 0.95, -0.75), 0.3, 0),
)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """The blender loader's camera on a sphere looking at the origin (4, 4);
    angles in degrees."""
    t = np.eye(4, dtype=np.float32)
    t[2, 3] = radius
    p, th = phi / 180.0 * np.pi, theta / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0],
                        [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]], dtype=np.float32)
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]], dtype=np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
    return flip @ (rot_theta @ (rot_phi @ t))


def ring_poses(n: int, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """n poses evenly round the ring, from -180 degrees."""
    return np.stack([pose_spherical(a, phi, radius) for a in np.linspace(-180, 180, n + 1)[:-1]])


def _albedo(kind: int, p, n):
    if kind == 0:
        return 0.5 + 0.5 * n
    if kind == 1:
        u = torch.floor(4 * torch.atan2(n[..., 1], n[..., 0]) / math.pi)
        v = torch.floor(6 * torch.acos(torch.clamp(n[..., 2], -1, 1)) / math.pi)
        c = ((u + v) % 2)[..., None]
        return c * n.new_tensor([0.9, 0.25, 0.2]) + (1 - c) * n.new_tensor([0.95, 0.85, 0.3])
    if kind == 2:
        s = 0.5 + 0.5 * torch.sin(14.0 * p[..., 2])
        return torch.stack([0.2 + 0.6 * s, 0.4 + 0.3 * (1 - s), 0.8 - 0.5 * s], -1)
    r = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    s = (torch.floor(8 * r) % 2)[..., None]
    return s * n.new_tensor([0.2, 0.7, 0.4]) + (1 - s) * n.new_tensor([0.9, 0.9, 0.95])


def trace(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest hit over the spheres, Lambertian plus a Blinn highlight;
    o, d (..., 3), d unit. Returns rgb (..., 3) in [0, 1]."""
    light = d.new_tensor(_LIGHT)
    light = light / torch.linalg.norm(light)
    best = torch.full(d.shape[:-1], float("inf"), device=d.device)
    img = torch.ones(d.shape, device=d.device)
    for centre, rad, kind in _SPHERES:
        oc = o - d.new_tensor(centre)
        b = torch.sum(oc * d, -1)
        disc = b * b - (torch.sum(oc * oc, -1) - rad ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 1e-3) & (t < best)
        p = o + t[..., None] * d
        n = (p - d.new_tensor(centre)) / rad
        lam = torch.clamp(torch.sum(n * light, -1), 0, 1)
        shade = _albedo(kind, p, n) * (0.2 + 0.8 * lam[..., None])
        h = light - d
        h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-8)
        shade = shade + 0.35 * (torch.clamp(torch.sum(n * h, -1), 0, 1) ** 40)[..., None]
        img = torch.where(hit[..., None], torch.clamp(shade, 0, 1), img)
        best = torch.where(hit, t, best)
    return img


@torch.no_grad()
def make_scene(spec: dict, device) -> dict:
    """The training views and render poses of a configuration's "scene":
    {"H", "W", "n_train", "n_render_poses", "ss", "bbox", "near", "far"}.
    Returns tensors on the device: images (N, H, W, 3), poses (N, 3, 4),
    K (3, 3), bbox (2, 3); render_poses (M, 4, 4) numpy; near, far, H, W,
    focal."""
    H, W, ss = spec["H"], spec["W"], spec.get("ss", 3)
    focal = 0.5 * W / math.tan(0.5 * FOV)
    poses = torch.as_tensor(ring_poses(spec["n_train"])[:, :3, :4], device=device)
    Hs, Ws, fs = H * ss, W * ss, focal * ss
    j, i = torch.meshgrid(torch.arange(Hs, dtype=torch.float32, device=device),
                          torch.arange(Ws, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - 0.5 * Ws) / fs, -(j - 0.5 * Hs) / fs, -torch.ones_like(i)], -1)
    images = torch.empty((len(poses), H, W, 3), dtype=torch.float32, device=device)
    for v, c2w in enumerate(poses):
        d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        img = trace(c2w[:3, 3].expand(d.shape), d)
        images[v] = img.reshape(H, ss, W, ss, 3).mean(dim=(1, 3))
    box = float(spec.get("bbox", 1.6))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return {
        "images": images, "poses": poses, "K": torch.as_tensor(K, dtype=torch.float32, device=device),
        "K_np": K, "bbox": torch.tensor([[-box] * 3, [box] * 3], dtype=torch.float32, device=device),
        "render_poses": ring_poses(spec.get("n_render_poses", 40)),
        "near": float(spec.get("near", 2.0)), "far": float(spec.get("far", 6.0)),
        "H": H, "W": W, "focal": focal,
    }

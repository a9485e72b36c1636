"""Generate st3d / OmniNeRF training data from one equirect RGB-D panorama.

The port's copy of hashnerf_tpu/tools/generate_equirect_data.py, reading
and writing its PNGs with utils/png.py (the JAX tool uses PIL). It
back-projects each pixel of `<name>_rgb.png` to a world point (unit
direction x depth from the 16-bit `<name>_d.png`), then for each new camera
position re-projects every point into the new equirect view with a z-buffer:
a source pixel whose point loses the depth test there is masked out
(`rm_occluded/mask_<i>.png`); the test views are the point cloud splatted
from the test positions (`test/rgb_<i>.png`); `cam_pos.txt` and
`test/cam_pos.txt` hold the positions, drawn from U(-radius, radius) and
U(-radius / 2, radius / 2) with np.random.default_rng(seed). This is the
layout load_st3d_data reads.

    python -m hashnerf_torch.tools.generate_equirect_data SCENE_DIR \\
        [--n_train 100] [--n_test 10] [--radius 0.3] [--seed 0]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from hashnerf_torch.ops.rays import equirect_directions
from hashnerf_torch.utils.png import read_png, write_png


def backproject(rgb: np.ndarray, depth: np.ndarray):
    H, W = rgb.shape[:2]
    dirs = equirect_directions(H, W).astype(np.float64)
    pts = dirs * depth[..., None]
    return pts.reshape(-1, 3), rgb.reshape(-1, 3)


def project_equirect(pts: np.ndarray, H: int, W: int):
    """World points -> (row, col, distance) in an equirect camera at the
    origin: the inverse of equirect_directions."""
    d = np.linalg.norm(pts, axis=-1)
    dn = pts / np.maximum(d[..., None], 1e-12)
    theta = np.arcsin(np.clip(dn[:, 1], -1, 1))  # latitude
    phi = np.arctan2(-dn[:, 2], dn[:, 0])  # a0 = cos t cos p, a2 = -cos t sin p
    x = (1.0 - 2.0 * theta / np.pi) * H / 2.0
    y = (0.5 - phi / (2.0 * np.pi)) * W
    return x, y % W, d


def _pixels(pts: np.ndarray, cam_pos: np.ndarray, H: int, W: int):
    """(flat pixel index, distance) of each point seen from cam_pos."""
    x, y, d = project_equirect(pts - cam_pos[None, :], H, W)
    xi = np.clip(np.round(x).astype(np.int64), 0, H - 1)
    yi = np.clip(np.round(y).astype(np.int64), 0, W - 1)
    return xi * W + yi, d


def render_view(pts, cols, cam_pos, H, W):
    """Z-buffer splat of the point cloud into an equirect view at cam_pos:
    (rgb, depth, hit mask)."""
    flat, d = _pixels(pts, cam_pos, H, W)
    order = np.argsort(-d)  # far first; near overwrites
    zbuf = np.full(H * W, np.inf)
    img = np.zeros((H * W, 3))
    hit = np.zeros(H * W, bool)
    fo = flat[order]
    zbuf[fo] = d[order]
    img[fo] = cols[order]
    hit[fo] = True
    return img.reshape(H, W, 3), zbuf.reshape(H, W), hit.reshape(H, W)


def occlusion_mask(pts, cam_pos, H, W):
    """A source pixel survives if its point is the closest along its ray in
    the new view (within 1e-3 of it)."""
    flat, d = _pixels(pts, cam_pos, H, W)
    zbuf = np.full(H * W, np.inf)
    np.minimum.at(zbuf, flat, d)
    return (d <= zbuf[flat] * (1.0 + 1e-3)).reshape(H, W)


def generate(scene_dir: str, n_train: int = 100, n_test: int = 10, radius: float = 0.3,
             seed: int = 0) -> str:
    name = os.path.basename(scene_dir.rstrip("/"))
    rgb = read_png(os.path.join(scene_dir, name + "_rgb.png"))[..., :3] / 255.0
    d = read_png(os.path.join(scene_dir, name + "_d.png")).astype(np.float64)
    H, W = rgb.shape[:2]
    pts, cols = backproject(rgb, d / d.max())

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(scene_dir, "rm_occluded"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "test"), exist_ok=True)

    train_pos = rng.uniform(-radius, radius, (n_train, 3))
    with open(os.path.join(scene_dir, "cam_pos.txt"), "w") as f:
        for i, c in enumerate(train_pos):
            f.write("{} {} {}\n".format(*c))
            mask = occlusion_mask(pts, c, H, W)
            write_png(os.path.join(scene_dir, "rm_occluded", f"mask_{i}.png"),
                      (mask * 255).astype(np.uint8))

    test_pos = rng.uniform(-radius / 2, radius / 2, (n_test, 3))
    with open(os.path.join(scene_dir, "test", "cam_pos.txt"), "w") as f:
        for i, c in enumerate(test_pos):
            f.write("{} {} {}\n".format(*c))
            img, _, _ = render_view(pts, cols, c, H, W)
            write_png(os.path.join(scene_dir, "test", f"rgb_{i}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
    return scene_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="st3d training data from one RGB-D panorama")
    p.add_argument("scene_dir")
    p.add_argument("--n_train", type=int, default=100)
    p.add_argument("--n_test", type=int, default=10)
    p.add_argument("--radius", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    print(generate(a.scene_dir, a.n_train, a.n_test, a.radius, a.seed))


if __name__ == "__main__":
    main()

"""Write a nerf-synthetic-format dataset from the procedural ray tracer.

Counterpart of hashnerf_tpu/tools/make_blender_dataset.py, with the same
command line, JSON and frames; the PNGs are written by utils/png.py. The
layout is the one the blender loader reads:

    basedir/
      transforms_train.json   train/r_000.png ...
      transforms_val.json     val/r_000.png ...
      transforms_test.json    test/r_000.png ...

RGBA frames at --hw x --hw (800, the nerf-synthetic size, by default): the
tracer composites onto white, so the colour is stored with an opaque alpha
and white-background compositing leaves it as it is.

Usage:
  python -m hashnerf_torch.tools.make_blender_dataset OUTDIR \
      [--hw 800] [--n_train 100] [--n_val 8] [--n_test 25] [--scene multi] [--ss 2]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np

from hashnerf_torch.data.pose_paths import pose_spherical
from hashnerf_torch.data.synthetic import _render_view
from hashnerf_torch.utils.png import write_png

# the nerf-synthetic lego value
CAMERA_ANGLE_X = 0.6911112070083618


def _pose_for(rng: np.random.Generator):
    """A random upper-hemisphere viewpoint, blender-convention c2w."""
    theta = rng.uniform(-180.0, 180.0)
    phi = rng.uniform(-60.0, -5.0)
    return pose_spherical(theta, phi, 4.0)


def write_split(basedir, split, n, H, W, scene_kind, ss, camera_angle_x, seed) -> np.ndarray:
    """Render and write one split; returns its (n, H, W, 4) uint8 frames."""
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    os.makedirs(os.path.join(basedir, split), exist_ok=True)
    frames, written = [], []
    for i in range(n):
        c2w = _pose_for(rng)
        img = _render_view(H, W, K, np.asarray(c2w)[:3, :4], scene_kind, ss)
        rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        u8 = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
        path = f"{split}/r_{i:03d}"
        write_png(os.path.join(basedir, path + ".png"), u8)
        written.append(u8)
        frames.append(
            {
                "file_path": "./" + path,
                "rotation": 0.0,
                "transform_matrix": np.asarray(c2w, np.float64).tolist(),
            }
        )
        if (i + 1) % 10 == 0:
            print(f"  {split}: {i + 1}/{n}", flush=True)
    meta = {"camera_angle_x": camera_angle_x, "frames": frames}
    with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return np.stack(written) if written else np.zeros((0, H, W, 4), np.uint8)


def main(argv=None) -> Dict[str, np.ndarray]:
    """Write the dataset; returns each split's uint8 frames as written."""
    p = argparse.ArgumentParser(prog="hashnerf_torch.tools.make_blender_dataset")
    p.add_argument("outdir")
    p.add_argument("--hw", type=int, default=800)
    p.add_argument("--n_train", type=int, default=100)
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--n_test", type=int, default=25)
    p.add_argument("--scene", default="multi", choices=["sphere", "multi"])
    p.add_argument("--ss", type=int, default=2,
                   help="supersampling for the GT tracer (2 at 800x800 "
                   "traces 2.56M rays/frame)")
    a = p.parse_args(argv)

    os.makedirs(a.outdir, exist_ok=True)
    out = {}
    for split, n, seed in (("train", a.n_train, 0), ("val", a.n_val, 1),
                           ("test", a.n_test, 2)):
        print(f"rendering {split} ({n} frames at {a.hw}x{a.hw})...", flush=True)
        out[split] = write_split(a.outdir, split, n, a.hw, a.hw, a.scene, a.ss,
                                 CAMERA_ANGLE_X, seed)
    print(f"wrote {a.outdir}")
    return out


if __name__ == "__main__":
    main()

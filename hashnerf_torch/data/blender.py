"""Blender / nerf-synthetic loader.

Counterpart of hashnerf_tpu/data/blender.py (`load_blender_scene`):
transforms_{train,val,test}.json and their PNG frames, RGBA / 255,
`testskip` on val and test, the spherical demo path, `half_res`, the bbox of
the train cameras' frusta at near 2 / far 6 and white-background
compositing. Frames are decoded by utils/png.py (the JAX package uses
imageio), and `half_res` downsamples as cv2.INTER_AREA does (the JAX
package calls cv2.resize): each output pixel is the area-weighted mean of
the input pixels its footprint overlaps, applied as one (H', H) and one
(W', W) weight matrix, exact for any size, not only halves.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from hashnerf_torch.data.pose_paths import spherical_render_poses
from hashnerf_torch.data.scene import Scene
from hashnerf_torch.ops.bbox import get_bbox3d_for_blenderobj
from hashnerf_torch.utils.png import read_pngs


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 weights of cv2.INTER_AREA along one axis, for
    dst <= src: the overlap of each source pixel with the output pixel's
    footprint [d * s, (d + 1) * s), s = src / dst, over the footprint's
    length, dropping overlaps under 1e-3 as OpenCV's computeResizeAreaTab
    does."""
    if dst > src:
        raise ValueError(f"area_weights downsamples only ({src} -> {dst})")
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w.astype(np.float32)


def resize_area(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """img (h, w[, C]) float32 -> (H, W[, C]), as cv2.resize(img, (W, H),
    interpolation=cv2.INTER_AREA) computes it, to float32 rounding."""
    h, w = img.shape[:2]
    C = img.size // (h * w)
    rows = (area_weights(h, H) @ img.reshape(h, w * C)).reshape(H, w, C)
    cols = area_weights(w, W) @ rows.transpose(1, 0, 2).reshape(w, H * C)
    return np.ascontiguousarray(cols.reshape(W, H, C).transpose(1, 0, 2)).reshape(
        (H, W) + img.shape[2:])


def load_blender_scene(
    basedir: str, half_res: bool = False, testskip: int = 1, white_bkgd: bool = False
) -> Scene:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = meta["frames"][::skip]
        pngs = read_pngs([os.path.join(basedir, f["file_path"] + ".png") for f in frames])
        # image by image: uint8 / 255 in float64, then float32 (as the JAX
        # loader divides the stacked split)
        all_imgs += [(im / 255.0).astype(np.float32) for im in pngs]
        all_poses += [np.array(f["transform_matrix"]).astype(np.float32) for f in frames]
        counts.append(counts[-1] + len(frames))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    poses = np.stack(all_poses, 0)

    H, W = all_imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = spherical_render_poses()

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        all_imgs = [resize_area(im, W, H) for im in all_imgs]
    imgs = np.stack(all_imgs, 0)
    del all_imgs

    bounding_box = get_bbox3d_for_blenderobj(metas["train"], H, W, near=2.0, far=6.0)

    if imgs.shape[-1] == 4:
        if white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]

    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return Scene(
        images=imgs.astype(np.float32),
        poses=poses[:, :3, :4],
        render_poses=render_poses,
        hwf=(H, W, focal),
        K=K,
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=2.0,
        far=6.0,
        bounding_box=bounding_box,
    )

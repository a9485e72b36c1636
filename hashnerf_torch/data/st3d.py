"""st3d / OmniNeRF equirectangular-panorama loader.

Counterpart of hashnerf_tpu/data/st3d.py (`load_st3d_data`): one 512 x
1024 RGB-D panorama `<name>_rgb.png` / `<name>_d.png` (16-bit depth) ->
the rays of 100 translated train viewpoints, each through its occlusion
mask `rm_occluded/mask_<i>.png`, with depth and a Laplacian-of-RGB
gradient target; 10 test viewpoints (`test/rgb_<i>.png`) and the identity
(ground-truth) pose, whole panoramas. PNGs are read by utils/png.py (the
JAX package uses PIL); the Laplacian is numpy's (the JAX package calls
cv2.Laplacian): the 3 x 3 kernel [[0, 1, 0], [1, -4, 1], [0, 1, 0]] on each
channel in float64 over OpenCV's default border, BORDER_REFLECT_101, which
is np.pad's "reflect". Under an `mp3d` parent directory the depth is
`<name>_depth.exr`, which only cv2 reads (ROADMAP A6).

The rays are computed per view in float64, as the JAX loader computes
them, and written as float32 straight into arrays sized from the masks:
the host holds the float32 bundle and one view's float64 work, not the
float64 rays of every view.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from hashnerf_torch.data.scene import RayBundle, Scene
from hashnerf_torch.ops.rays import equirect_directions
from hashnerf_torch.utils.png import read_png, read_pngs

N_TRAIN_VIEWS, N_TEST_VIEWS = 100, 10  # the loader's fixed split, as upstream
PANO_H, PANO_W = 512, 1024


def laplacian(img: np.ndarray) -> np.ndarray:
    """cv2.Laplacian(img, cv2.CV_64F) with its defaults (ksize 1,
    BORDER_REFLECT_101) of an (H, W, C) image, in float64."""
    p = np.pad(np.asarray(img, np.float64), ((1, 1), (1, 1), (0, 0)), mode="reflect")
    return p[:-2, 1:-1] + p[1:-1, :-2] - 4.0 * p[1:-1, 1:-1] + p[1:-1, 2:] + p[2:, 1:-1]


def laplacian_gradient(rgb: np.ndarray) -> np.ndarray:
    """The gradient target: the Laplacian of rgb scaled to [-1, 1] by its
    min and range."""
    g = laplacian(rgb)
    return 2.0 * (g - np.min(g)) / np.ptp(g) - 1.0


def needs_exr(basedir: str) -> bool:
    """Whether the set keeps its depth as mp3d's EXR (an `mp3d` parent)."""
    parts = basedir.rstrip("/").split("/")
    return len(parts) > 1 and parts[-2] == "mp3d"


def cv2_or_none():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _read_depth(basedir: str, basename: str) -> np.ndarray:
    if not needs_exr(basedir):
        return read_png(os.path.join(basedir, basename + "d.png"))
    cv2 = cv2_or_none()
    if cv2 is None:
        raise NotImplementedError(
            "hashnerf_torch: an mp3d set's depth.exr is read through cv2, which is not "
            "installed (ROADMAP A6)")
    return cv2.imread(os.path.join(basedir, basename + "depth.exr"),
                      cv2.IMREAD_ANYDEPTH).astype(np.float64)


def _cam_positions(path: str):
    with open(path, "r") as fp:
        return [np.array(p.split()).astype(float) for p in fp.readlines()]


def load_st3d_data(basedir: str, stage: int = 0) -> Tuple[RayBundle, RayBundle, int, int]:
    """(train rays, test rays, H, W). Test rays are 10 whole panoramas from
    the test positions, then the ground-truth one from the origin."""
    if stage > 0:
        raise NotImplementedError(
            "st3d iterative-stage training is unimplemented upstream too "
            "(reference load_st3d.py:92-108 raises NotImplementedError)")
    basename = basedir.rstrip("/").split("/")[-1] + "_"
    d = _read_depth(basedir, basename)
    rgb = read_png(os.path.join(basedir, basename + "rgb.png")) / 255.0
    gradient = laplacian_gradient(rgb)
    d = d.reshape(rgb.shape[0], rgb.shape[1], 1) / np.max(d)

    H, W = PANO_H, PANO_W
    original_coord = equirect_directions(H, W).astype(np.float64)
    coord = original_coord * d  # the panorama's points: unit directions x depth

    cams = (_cam_positions(os.path.join(basedir, "cam_pos.txt"))
            + _cam_positions(os.path.join(basedir, "test", "cam_pos.txt")) + [np.zeros(3)])
    masks = read_pngs([os.path.join(basedir, "rm_occluded", f"mask_{i}.png")
                       for i in range(N_TRAIN_VIEWS)])
    sels = [m > 0 for m in masks]
    del masks
    n = sum(int(s.sum()) for s in sels)
    tr = RayBundle(o=np.empty((n, 3), np.float32), d=np.empty((n, 3), np.float32),
                   rgb=np.empty((n, 3), np.float32), depth=np.empty(n, np.float32),
                   g=np.empty((n, 3), np.float32))
    n_test = N_TEST_VIEWS + 1
    te = RayBundle(o=np.empty((n_test * H * W, 3), np.float32),
                   d=np.empty((n_test * H * W, 3), np.float32),
                   rgb=np.empty((n_test * H * W, 3), np.float32),
                   depth=np.empty(n_test * H * W, np.float32))
    test_rgbs = read_pngs([os.path.join(basedir, "test", f"rgb_{i}.png")
                           for i in range(N_TEST_VIEWS)])
    at = 0
    for idx, c in enumerate(cams):
        rel = coord - c
        dep = np.linalg.norm(rel, axis=-1)
        if idx < N_TRAIN_VIEWS:
            sel = sels[idx]
            e = at + int(sel.sum())
            tr.o[at:e] = c
            tr.d[at:e] = (rel / dep[..., None])[sel]
            tr.rgb[at:e] = rgb[sel]
            tr.depth[at:e] = dep[sel]
            tr.g[at:e] = gradient[sel]
            at = e
            continue
        v = slice((idx - N_TRAIN_VIEWS) * H * W, (idx - N_TRAIN_VIEWS + 1) * H * W)
        te.o[v] = c
        te.depth[v] = dep.reshape(-1)
        if idx < N_TRAIN_VIEWS + N_TEST_VIEWS:
            te.d[v] = original_coord.reshape(-1, 3)
            te.rgb[v] = test_rgbs[idx - N_TRAIN_VIEWS].reshape(-1, 3) / 255.0
        else:  # the identity (ground-truth) pose
            te.d[v] = coord.reshape(-1, 3)
            te.rgb[v] = rgb.reshape(-1, 3)
    return tr, te, H, W


def st3d_scene(H: int, W: int, near: float = 0.0, far: float = 2.0) -> Scene:
    """A Scene without images for the panorama loop's Trainer: its near and
    far, and the box [-far, far]^3 around the panorama's origin."""
    return Scene(
        images=np.zeros((0, H, W, 3), np.float32), poses=np.zeros((0, 3, 4), np.float32),
        render_poses=np.zeros((0, 4, 4), np.float32), hwf=(H, W, 0.0), K=np.eye(3),
        i_train=np.zeros(0, np.int64), i_val=np.zeros(0, np.int64), i_test=np.zeros(0, np.int64),
        near=near, far=far,
        bounding_box=(np.full(3, -far, np.float32), np.full(3, far, np.float32)),
    )

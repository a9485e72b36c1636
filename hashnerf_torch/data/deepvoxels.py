"""DeepVoxels loader: intrinsics.txt, pose directories and RGB frames.

Counterpart of hashnerf_tpu/data/deepvoxels.py (`load_deepvoxels_scene`):
512 x 512 frames of `{train,test,validation}/<scene>/rgb`, poses from
`pose/*.txt` with y and z flipped, `testskip` on test and validation, near
and far 1 inside and outside the cameras' mean distance from the origin,
the test poses as the demo path, and no bbox (a positional-encoding path;
Scene.bbox_array's fallback box). PNGs are read by utils/png.py.
"""
from __future__ import annotations

import os

import numpy as np

from hashnerf_torch.data.scene import Scene
from hashnerf_torch.utils.png import read_pngs


def _parse_intrinsics(filepath: str, trgt_sidelength: int):
    with open(filepath, "r") as file:
        f, cx, cy = list(map(float, file.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, file.readline().split())))
        near_plane = float(file.readline())
        scale = float(file.readline())
        height, width = map(float, file.readline().split())
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    f = trgt_sidelength / height * f
    return f, cx, cy, grid_barycenter, scale, near_plane


def _load_pose(filename: str) -> np.ndarray:
    with open(filename) as fp:
        nums = fp.read().split()
    return np.array([float(x) for x in nums]).reshape([4, 4]).astype(np.float32)


def _dir2poses(posedir: str) -> np.ndarray:
    poses = np.stack([_load_pose(os.path.join(posedir, f))
                      for f in sorted(os.listdir(posedir)) if f.endswith("txt")], 0)
    transf = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    return (poses @ transf)[:, :3, :4].astype(np.float32)


def _load_imgs(d: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(d)) if f.endswith("png")][::skip]
    return np.stack([im / 255.0 for im in read_pngs([os.path.join(d, f) for f in files])],
                    0).astype(np.float32)


def load_deepvoxels_scene(scene: str = "greek", basedir: str = "/data/deepvoxels",
                          testskip: int = 8) -> Scene:
    H = W = 512
    base = f"{basedir}/train/{scene}/"
    focal, _, _, _, _, _ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(f"{basedir}/test/{scene}/pose")[::testskip]
    valposes = _dir2poses(f"{basedir}/validation/{scene}/pose")[::testskip]

    all_imgs = [_load_imgs(os.path.join(base, "rgb")),
                _load_imgs(f"{basedir}/validation/{scene}/rgb", testskip),
                _load_imgs(f"{basedir}/test/{scene}/rgb", testskip)]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)

    hemi_R = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return Scene(
        images=imgs[..., :3],
        poses=poses,
        render_poses=testposes,
        hwf=(H, W, focal),
        K=K,
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=hemi_R - 1.0,
        far=hemi_R + 1.0,
        bounding_box=None,
    )

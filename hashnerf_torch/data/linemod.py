"""LINEMOD loader: blender-like json with the dataset's intrinsic matrix.

Counterpart of hashnerf_tpu/data/linemod.py (`load_linemod_scene`):
`transforms_{train,val,test}.json` whose frames carry the image's own path
and an `intrinsic_matrix` (K is the first train frame's), `testskip` on val
and test, the spherical demo path, `half_res` (K halved), near and far the
floor and ceiling of the train and test splits' bounds, white-background
compositing of RGBA frames, and no bbox (Scene.bbox_array's fallback
box). PNGs are read by utils/png.py and `half_res` downsamples as
cv2.INTER_AREA (data/blender.py's resize_area).
"""
from __future__ import annotations

import json
import os

import numpy as np

from hashnerf_torch.data.blender import resize_area
from hashnerf_torch.data.pose_paths import spherical_render_poses
from hashnerf_torch.data.scene import Scene
from hashnerf_torch.utils.png import read_pngs


def load_linemod_scene(basedir: str, half_res: bool = False, testskip: int = 1,
                       white_bkgd: bool = False) -> Scene:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = metas[s]["frames"][::skip]
        all_imgs += [(im / 255.0).astype(np.float32)
                     for im in read_pngs([f["file_path"] for f in frames])]
        all_poses += [np.array(f["transform_matrix"]).astype(np.float32) for f in frames]
        counts.append(counts[-1] + len(frames))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    poses = np.stack(all_poses, 0)
    H, W = all_imgs[0].shape[:2]
    K = np.array(metas["train"]["frames"][0]["intrinsic_matrix"], dtype=np.float64)
    focal = float(K[0][0])
    render_poses = spherical_render_poses()
    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        K = K.copy()
        K[:2] /= 2.0
        all_imgs = [resize_area(im, W, H) for im in all_imgs]
    imgs = np.stack(all_imgs, 0)
    del all_imgs

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    if imgs.shape[-1] == 4:
        if white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]
    return Scene(
        images=imgs.astype(np.float32),
        poses=poses[:, :3, :4],
        render_poses=render_poses,
        hwf=(H, W, focal),
        K=K[:3, :3],
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=near,
        far=far,
        bounding_box=None,
    )

"""ScanNet loader: nerf-style json with the OpenCV -> NeRF axis flip and the
bounds of the scene's mesh.

Counterpart of hashnerf_tpu/data/scannet.py (`load_scannet_scene`,
`ply_vertex_bounds`): `nerfstyle_<sceneID>/transforms_{train,val,test}.json`
and their PNG frames (`trainskip` on train, `testskip` on val and test),
camera y and z flipped, the spherical demo path, `half_res`, near 0.1 / far
10, and the bbox of `scans/<sceneID>/<sceneID>_vh_clean.ply`'s vertices
grown by 1 on each side. PNGs are read by utils/png.py and `half_res`
downsamples as cv2.INTER_AREA (data/blender.py's resize_area); the PLY
reader takes ascii and binary_little_endian vertices.
"""
from __future__ import annotations

import json
import os

import numpy as np

from hashnerf_torch.data.blender import resize_area
from hashnerf_torch.data.pose_paths import spherical_render_poses
from hashnerf_torch.data.scene import Scene
from hashnerf_torch.utils.png import read_pngs

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8", "uchar": "u1",
    "uint8": "u1", "char": "i1", "int8": "i1", "short": "i2", "ushort": "u2", "int": "i4",
    "int32": "i4", "uint": "u4", "uint32": "u4",
}


def ply_vertex_bounds(path: str):
    """(min (3,), max (3,)) float64 of the x, y, z of a PLY file's vertex
    element, ascii or binary_little_endian."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt, n_vertex, props, in_vertex = None, 0, [], False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b"end_header":
                break
        names = [p[0] for p in props]
        if fmt == "ascii":
            ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
            rows = [f.readline().split() for _ in range(n_vertex)]
            v = np.array([[float(r[ix]), float(r[iy]), float(r[iz])] for r in rows])
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + _PLY_TYPES[t]) for name, t in props])
            arr = np.frombuffer(f.read(n_vertex * dt.itemsize), dtype=dt, count=n_vertex)
            v = np.stack([arr[c].astype(np.float64) for c in ("x", "y", "z")], -1)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return v.min(0), v.max(0)


def load_scannet_scene(
    basedir: str,
    sceneID: str = "scene0000_00",
    half_res: bool = False,
    trainskip: int = 10,
    testskip: int = 1,
) -> Scene:
    scansdir = os.path.join(basedir, "scans")
    nerfdir = os.path.join(basedir, "nerfstyle_" + sceneID)
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(nerfdir, f"transforms_{s}.json"), "r") as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        frames = metas[s]["frames"][::trainskip if s == "train" else testskip]
        pngs = read_pngs([os.path.join(nerfdir, f["file_path"] + ".png") for f in frames])
        all_imgs += [(im / 255.0).astype(np.float32) for im in pngs]
        for frame in frames:
            pose = np.array(frame["transform_matrix"])
            pose[:3, 1] *= -1  # OpenCV -> NeRF
            pose[:3, 2] *= -1
            all_poses.append(pose.astype(np.float32))
        counts.append(counts[-1] + len(frames))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    poses = np.stack(all_poses, 0)
    H, W = all_imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    render_poses = spherical_render_poses()
    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        all_imgs = [resize_area(im, W, H) for im in all_imgs]
    imgs = np.stack(all_imgs, 0)
    del all_imgs

    vmin, vmax = ply_vertex_bounds(os.path.join(scansdir, sceneID, f"{sceneID}_vh_clean.ply"))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return Scene(
        images=imgs[..., :3].astype(np.float32),
        poses=poses[:, :3, :4],
        render_poses=render_poses,
        hwf=(H, W, focal),
        K=K,
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=0.1,
        far=10.0,
        bounding_box=((vmin - 1.0).astype(np.float32), (vmax + 1.0).astype(np.float32)),
    )

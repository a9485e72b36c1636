"""LLFF forward-facing loader: poses_bounds.npy, recentering or spherify, the
spiral demo path, NDC bounds.

Counterpart of hashnerf_tpu/data/llff.py (`load_llff_scene` and its
helpers), numpy on the host. The pose math (_viewmatrix, _poses_avg,
_render_path_spiral, _recenter_poses, _spherify_poses) is a copy of the JAX
package's, which follows the LLFF format's own conventions (its [.1, .2,
.3] focus jitter, percentile-90 spiral radii, zrate 0.5): a poses_bounds.npy
must load to the same poses in both.

Images: PNGs are decoded by utils/png.py. JPG sources and the
`images_{factor}` cache that the JAX package writes with PIL (LANCZOS) need
PIL, imported only when one of them is reached; without it they raise. The
released LLFF scenes ship `images_4` and `images_8` as PNGs, so the
configs' factors need nothing more.
"""
from __future__ import annotations

import os

import numpy as np

from hashnerf_torch.data.scene import Scene
from hashnerf_torch.ops.bbox import get_bbox3d_for_llff
from hashnerf_torch.utils.png import read_pngs

_IMG_EXT = ("JPG", "jpg", "png", "jpeg", "PNG")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "hashnerf_torch: reading JPG images and writing the images_{factor} "
            "cache need PIL (Pillow), which this host does not have; give the "
            "scene's images_{factor} folder as PNGs"
        ) from e
    return Image


def _read_images(paths):
    """uint8 (H, W, C) arrays: PNGs by utils/png.py, the rest by PIL."""
    pngs = [p for p in paths if p.lower().endswith(".png")]
    decoded = dict(zip(pngs, read_pngs(pngs)))
    for p in paths:
        if p not in decoded:
            decoded[p] = np.asarray(_pil_image().open(p))
    return [decoded[p] for p in paths]


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def _render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads,
        )
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return render_poses


def _recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses44 = np.linalg.inv(c2w) @ poses44
    poses_[:, :3, :4] = poses44[:, :3, :4]
    return poses_


def _spherify_poses(poses, bds):
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ (b_i).mean(0)
        )

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1,
    )
    return poses_reset, new_poses, bds


def _minify(basedir: str, factor: int) -> str:
    """The images_{factor} cache: each source image shrunk by `factor` with
    PIL's LANCZOS and written as PNG, as the JAX package writes it; an
    existing folder is used as it is."""
    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    Image = _pil_image()
    srcdir = os.path.join(basedir, "images")
    files = sorted(f for f in os.listdir(srcdir) if f.split(".")[-1] in _IMG_EXT)
    os.makedirs(imgdir)
    for f in files:
        img = Image.open(os.path.join(srcdir, f))
        w, h = img.size
        img = img.resize((int(w / factor), int(h / factor)), Image.LANCZOS)
        img.save(os.path.join(imgdir, os.path.splitext(f)[0] + ".png"))
    return imgdir


def _load_data(basedir: str, factor: int = 8):
    """poses (3, 5, N), bounds (2, N) and images (H, W, 3, N) in float64
    [0, 1], with each pose's hwf set to the images' size and focal / factor."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")

    imgfiles = [
        os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir)) if f.split(".")[-1] in _IMG_EXT
    ]
    if poses.shape[-1] != len(imgfiles):
        raise RuntimeError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    imgs = [im[..., :3] / 255.0 for im in _read_images(imgfiles)]
    poses[:2, 4, :] = np.array(imgs[0].shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    return poses, bds, np.stack(imgs, -1)


def load_llff_scene(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    llffhold: int = 8,
    no_ndc: bool = False,
    path_zflat: bool = False,
) -> Scene:
    """The scene of an LLFF folder (poses_bounds.npy and images[_factor]/):
    poses in NeRF's [right, up, back] axes, scaled so that the nearest bound
    is 1 / bd_factor, recentered on their average; the 120-pose spiral (60
    with path_zflat) or, under spherify, the 120-pose circle; every
    llffhold-th image a test and val view (llffhold 0: the one nearest the
    average pose); NDC bounds 0 / 1 unless no_ndc or spherify."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # LLFF [down right back] -> NeRF [right up back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = _render_path_spiral(c2w_path, up, rads, focal, zrate=0.5, rots=N_rots,
                                           N=N_views)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    hwf = poses[0, :3, -1]
    bounding_box = get_bbox3d_for_llff(poses[:, :3, :4], hwf, near=0.0, far=1.0)

    if llffhold > 0:
        i_test_arr = np.arange(images.shape[0])[::llffhold]
    else:
        i_test_arr = np.array([i_test])
    i_train = np.array([i for i in np.arange(images.shape[0]) if i not in i_test_arr])

    if no_ndc:
        near, far = float(bds.min()) * 0.9, float(bds.max()) * 1.0
        ndc = False
    else:
        near, far = 0.0, 1.0
        ndc = not spherify  # NDC only for forward-facing scenes

    H, W, focal = hwf
    H, W = int(H), int(W)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return Scene(
        images=images,
        poses=poses[:, :3, :4],
        render_poses=render_poses[:, :3, :4] if render_poses.shape[-1] == 5 else render_poses,
        hwf=(H, W, float(focal)),
        K=K,
        i_train=i_train,
        i_val=i_test_arr,
        i_test=i_test_arr,
        near=near,
        far=far,
        bounding_box=bounding_box,
        ndc=ndc,
    )

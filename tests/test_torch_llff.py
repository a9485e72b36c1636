"""The port's LLFF pieces against the JAX package on the CPU: get_ndc_rays
(and against the reference goldens), get_bbox3d_for_llff, and
load_llff_scene on small sets written with the port's write_png, field by
field, under the default settings, spherify, no_ndc, path_zflat and
llffhold 0; JPG sources and the images_{factor} cache through PIL, and the
error without it."""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch.utils.png import write_png

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "reference_golden.npz")


def _forward_rays(n, seed):
    """Rays of a forward-facing rig: origins near z = 0, directions along -z."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)), -rng.uniform(0.8, 1.2, (n, 1))], 1)
    return o, d.astype(np.float32)


def test_get_ndc_rays_matches_jax():
    from hashnerf_tpu.ops.rays import get_ndc_rays as jndc
    from hashnerf_torch.ops.rays import get_ndc_rays

    H, W, focal = 37, 53, 41.7
    o, d = _forward_rays(4096, 0)
    want_o, want_d = jndc(H, W, focal, 1.0, jnp.asarray(o), jnp.asarray(d))
    got_o, got_d = get_ndc_rays(H, W, focal, 1.0, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-6)
    # numpy in, numpy out, as the JAX function's np branch
    np_o, np_d = get_ndc_rays(H, W, focal, 1.0, o, d)
    want_o, want_d = jndc(H, W, focal, 1.0, o, d)
    assert isinstance(np_o, np.ndarray)
    np.testing.assert_array_equal(np_o, want_o)
    np.testing.assert_array_equal(np_d, want_d)


def test_get_ndc_rays_matches_reference():
    from hashnerf_torch.ops.rays import get_ndc_rays, get_rays

    g = np.load(GOLDEN)
    H, W, focal = (int(g["rays_hwf"][0]), int(g["rays_hwf"][1]), float(g["rays_hwf"][2]))
    ro, rd = get_rays(H, W, torch.from_numpy(g["rays_K"]), torch.from_numpy(g["rays_c2w"]))
    no, nd = get_ndc_rays(H, W, focal, 1.0, ro.reshape(-1, 3), rd.reshape(-1, 3))
    np.testing.assert_allclose(no.numpy(), g["ndc_o"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nd.numpy(), g["ndc_d"], rtol=1e-4, atol=1e-5)


def _llff_poses(n, seed):
    """(n, 3, 4) LLFF-convention [down, right, back] camera matrices of a
    forward-facing rig: rotations of a few degrees, small translations."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ax, ay = np.radians(rng.uniform(-8, 8, 2))
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
        r = rx @ ry  # NeRF axes [right, up, back]
        c2w = np.concatenate([r, rng.uniform(-0.4, 0.4, (3, 1))], 1)
        out.append(np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]], 1))
    return np.stack(out)


def write_llff_set(root, n=6, H=24, W=32, factor=None, ext="png", seed=1):
    """poses_bounds.npy (hwf at factor x the images' size) and random uint8
    frames under images_{factor} (images/ without a factor). Returns the
    frames."""
    rng = np.random.default_rng(seed)
    f = factor or 1
    poses = _llff_poses(n, seed)
    hwf = np.tile(np.array([H * f, W * f, 30.0 * f]).reshape(1, 3, 1), (n, 1, 1))
    bds = np.stack([rng.uniform(1.0, 2.0, n), rng.uniform(8.0, 12.0, n)], 1)
    arr = np.concatenate([np.concatenate([poses, hwf], 2).reshape(n, 15), bds], 1)
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), arr)
    imgdir = os.path.join(root, f"images_{factor}" if factor else "images")
    os.makedirs(imgdir)
    frames = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    for i, fr in enumerate(frames):
        path = os.path.join(imgdir, f"img{i:03d}.{ext}")
        if ext == "png":
            write_png(path, fr)
        else:
            from PIL import Image

            Image.fromarray(fr).save(path, quality=95)
    return frames


def _assert_scene_equal(got, want):
    for field in ("images", "poses", "render_poses", "K", "i_train", "i_val", "i_test"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
                                   rtol=0, atol=0, err_msg=field)
    assert tuple(got.hwf) == tuple(want.hwf)
    assert (got.near, got.far, got.ndc) == (want.near, want.far, want.ndc)
    for a, b in zip(got.bounding_box, want.bounding_box):
        np.testing.assert_array_equal(a, b)


SETTINGS = {
    "default": {},
    "spherify": {"spherify": True},
    "no_ndc": {"no_ndc": True},
    "path_zflat": {"path_zflat": True},
    "llffhold_0": {"llffhold": 0},
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_load_llff_scene_matches_jax(tmp_path, setting):
    from hashnerf_tpu.data.llff import load_llff_scene as jload
    from hashnerf_torch.data.llff import load_llff_scene

    frames = write_llff_set(str(tmp_path), n=9, factor=8)
    kw = {"factor": 8, "llffhold": 3, **SETTINGS[setting]}
    got, want = load_llff_scene(str(tmp_path), **kw), jload(str(tmp_path), **kw)
    _assert_scene_equal(got, want)
    np.testing.assert_array_equal(got.images, (frames / 255.0).astype(np.float32))
    assert got.H == 24 and got.W == 32 and got.focal == pytest.approx(30.0)
    if setting == "default":
        assert got.ndc and (got.near, got.far) == (0.0, 1.0)
        assert list(got.i_test) == [0, 3, 6] and got.render_poses.shape == (120, 3, 4)
    if setting in ("spherify", "no_ndc"):
        assert not got.ndc
    if setting == "path_zflat":
        assert got.render_poses.shape[0] == 60
    if setting == "llffhold_0":
        assert len(got.i_test) == 1 and len(got.i_train) == 8


def test_load_scene_dispatches_llff(tmp_path):
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.data.llff import load_llff_scene
    from hashnerf_torch.train.config import parse_args

    write_llff_set(str(tmp_path), factor=8)
    args = parse_args(["--dataset_type", "llff", "--llffhold", "2"])
    _assert_scene_equal(load_scene("llff", str(tmp_path), args),
                        load_llff_scene(str(tmp_path), factor=8, llffhold=2))


def test_get_bbox3d_for_llff_matches_jax():
    from hashnerf_tpu.ops.bbox import get_bbox3d_for_llff as jbbox
    from hashnerf_torch.ops.bbox import get_bbox3d_for_llff

    poses = _llff_poses(5, 4)
    poses = np.concatenate([poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], 2)
    poses[:, 2, 3] += 0.5
    hwf = (30, 40, 35.5)
    for a, b in zip(get_bbox3d_for_llff(poses, hwf), jbbox(poses, hwf)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_jpg_sources_and_the_minify_cache_match_jax(tmp_path):
    """factor 1 reads images/ (JPGs, through PIL in both packages); factor 2
    writes images_2 with PIL's LANCZOS, which the port then reads as PNGs."""
    from hashnerf_tpu.data.llff import load_llff_scene as jload
    from hashnerf_torch.data.llff import load_llff_scene

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_llff_set(a, n=4, ext="jpg")
    _assert_scene_equal(load_llff_scene(a, factor=1, llffhold=2), jload(a, factor=1, llffhold=2))
    write_llff_set(b, n=4, H=32, W=48, ext="jpg")
    got = load_llff_scene(b, factor=2, llffhold=2)  # writes images_2
    assert got.images.shape == (4, 16, 24, 3)
    _assert_scene_equal(got, jload(b, factor=2, llffhold=2))


def test_jpg_and_minify_without_pil_raise(tmp_path, monkeypatch):
    from hashnerf_torch.data.llff import load_llff_scene

    write_llff_set(str(tmp_path / "a"), n=2, factor=8)
    write_llff_set(str(tmp_path / "b"), n=2, ext="jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` raises
    load_llff_scene(str(tmp_path / "a"), factor=8)  # PNGs need no PIL
    with pytest.raises(ImportError, match="PIL"):
        load_llff_scene(str(tmp_path / "b"), factor=1)
    with pytest.raises(ImportError, match="PIL"):
        load_llff_scene(str(tmp_path / "b"), factor=2)
    assert not os.path.exists(tmp_path / "b" / "images_2")

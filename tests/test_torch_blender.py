"""The port's blender path against the JAX package on the CPU: the camera
direction field and the frustum bbox, `half_res` against cv2's INTER_AREA,
`load_blender_scene` on blender-format sets on disk, the dataset writer, and
the loader dispatch."""
import json
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_set(root, H, W, seed=0, counts=(("train", 3), ("val", 1), ("test", 2))):
    """A blender-format set of random RGBA frames written by imageio (the
    fixture of tests/test_data_loaders.py at any size)."""
    from hashnerf_tpu.data.pose_paths import pose_spherical

    rng = np.random.default_rng(seed)
    for split, n in counts:
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            img = rng.uniform(0, 255, (H, W, 4)).astype(np.uint8)
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"), img)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose_spherical(i * 40.0, -30.0, 4.0).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    return str(root)


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    return _write_set(tmp_path_factory.mktemp("blender_scene"), 32, 32)


@pytest.fixture(scope="module")
def odd_dir(tmp_path_factory):
    return _write_set(tmp_path_factory.mktemp("blender_odd"), 33, 47, seed=1,
                      counts=(("train", 2), ("val", 1), ("test", 3)))


@pytest.mark.parametrize("H,W,focal", [(32, 32, 44.4), (33, 47, 51.7), (400, 400, 555.5555)])
def test_direction_field_and_rays_equal_jax(H, W, focal):
    from hashnerf_tpu.data.pose_paths import pose_spherical
    from hashnerf_tpu.ops.rays import get_directions as jdirs, ray_from_directions as jrays
    from hashnerf_torch.ops.rays import get_directions, ray_from_directions

    d = get_directions(H, W, focal)
    np.testing.assert_array_equal(d, jdirs(H, W, focal))
    assert d.dtype == np.float32
    c2w = pose_spherical(33.0, -41.0, 4.0)
    for got, want in zip(ray_from_directions(d, c2w), jrays(d, c2w)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,W", [(32, 32), (400, 400), (33, 47)])
def test_bbox_equals_jax(H, W):
    from hashnerf_tpu.data.pose_paths import pose_spherical
    from hashnerf_tpu.ops.bbox import get_bbox3d_for_blenderobj as jbbox
    from hashnerf_torch.ops.bbox import get_bbox3d_for_blenderobj

    meta = {"camera_angle_x": 0.6911112070083618,
            "frames": [{"transform_matrix": pose_spherical(a, p, 4.0).tolist()}
                       for a, p in [(-170.0, -12.0), (15.0, -55.0), (99.0, -30.0)]]}
    for got, want in zip(get_bbox3d_for_blenderobj(meta, H, W), jbbox(meta, H, W)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,H,W,C", [(32, 32, 16, 16, 4), (33, 47, 16, 23, 4),
                                       (800, 800, 400, 400, 4), (40, 30, 13, 7, 4),
                                       (33, 47, 16, 23, 0)])
def test_resize_area_matches_cv2(h, w, H, W, C):
    """C = 0: a (h, w) gray image."""
    from hashnerf_torch.data.blender import resize_area

    shape = (h, w, C) if C else (h, w)
    img = np.random.default_rng(h + w).random(shape).astype(np.float32)
    got = resize_area(img, W, H)
    assert got.shape == (H, W) + shape[2:] and got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("half_res,white_bkgd,testskip", [
    (False, False, 1), (False, True, 1), (True, True, 1), (True, False, 2), (False, True, 0),
])
def test_loader_matches_jax(blender_dir, half_res, white_bkgd, testskip):
    from hashnerf_tpu.data.blender import load_blender_scene as jload
    from hashnerf_torch.data.blender import load_blender_scene

    got = load_blender_scene(blender_dir, half_res, testskip, white_bkgd)
    want = jload(blender_dir, half_res, testskip, white_bkgd)
    assert got.images.shape == want.images.shape and got.images.dtype == np.float32
    if half_res:  # cv2's INTER_AREA sums in its own order
        np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.images, want.images)
    for k in ("poses", "render_poses", "K", "i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.hwf == want.hwf and (got.near, got.far) == (want.near, want.far)
    for a, b in zip(got.bounding_box, want.bounding_box):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_half_res_of_an_odd_size_matches_jax(odd_dir):
    from hashnerf_tpu.data.blender import load_blender_scene as jload
    from hashnerf_torch.data.blender import load_blender_scene

    got, want = load_blender_scene(odd_dir, True, 1, True), jload(odd_dir, True, 1, True)
    assert got.images.shape == (6, 16, 23, 3) and got.hwf == want.hwf
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.K, want.K)
    for a, b in zip(got.bounding_box, want.bounding_box):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_dataset_writer_matches_jax(tmp_path):
    from hashnerf_tpu.tools.make_blender_dataset import main as jmain
    from hashnerf_torch.tools.make_blender_dataset import main
    from hashnerf_torch.data.blender import load_blender_scene

    argv = ["--hw", "32", "--n_train", "3", "--n_val", "1", "--n_test", "2", "--ss", "1"]
    frames = main([str(tmp_path / "port")] + argv)
    jmain([str(tmp_path / "jax")] + argv)
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        with open(tmp_path / "port" / f"transforms_{split}.json") as f:
            got = f.read()
        with open(tmp_path / "jax" / f"transforms_{split}.json") as f:
            assert got == f.read(), split
        assert frames[split].shape == (n, 32, 32, 4) and frames[split].dtype == np.uint8
        for i in range(n):
            a = imageio.imread(tmp_path / "port" / split / f"r_{i:03d}.png")
            np.testing.assert_array_equal(a, imageio.imread(tmp_path / "jax" / split / f"r_{i:03d}.png"))
            np.testing.assert_array_equal(a, frames[split][i])
    # the loader reads back exactly what was written
    sc = load_blender_scene(str(tmp_path / "port"), False, 1, False)
    np.testing.assert_array_equal(sc.images[:3], (frames["train"][..., :3] / 255.0).astype(np.float32))


@pytest.mark.parametrize("dataset_type,row", [("scannet", "A6"), ("LINEMOD", "A6"), ("deepvoxels", "A6")])
def test_load_scene_dispatch(blender_dir, dataset_type, row):
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.train.config import parse_args

    args = parse_args(["--dataset_type", "blender", "--half_res", "--white_bkgd", "--testskip", "1"])
    sc = load_scene("blender", blender_dir, args)
    assert sc.images.shape == (6, 16, 16, 3)
    with pytest.raises(NotImplementedError, match=row):
        load_scene(dataset_type, blender_dir, args)

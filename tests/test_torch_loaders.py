"""The scannet, deepvoxels and LINEMOD loaders of the port against the JAX
package's on the CPU, on the sets tests/test_data_loaders2.py writes (and a
binary PLY, a half_res and an RGBA variant), the PLY bounds of ascii and
binary files, load_scene's dispatch, and a short CLI run of each loader
that writes a checkpoint."""
import json
import os
import struct

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.data.pose_paths import pose_spherical


def _write_png(path, arr):
    import imageio.v2 as imageio

    imageio.imwrite(str(path), arr)


def scannet_set(root, H=24, W=24, channels=3, n_vertex=2):
    """tests/test_data_loaders2.py's ScanNet layout: 10 / 2 / 2 frames and a
    binary little-endian PLY (n_vertex > 2: more vertices inside the two
    corners, with an extra uchar property)."""
    rng = np.random.default_rng(0)
    sceneID = "scene0000_00"
    nerfdir = root / ("nerfstyle_" + sceneID)
    scandir = root / "scans" / sceneID
    os.makedirs(nerfdir / "frames")
    os.makedirs(scandir)
    for split, n in [("train", 10), ("val", 2), ("test", 2)]:
        frames = []
        for i in range(n):
            fname = f"frames/{split}_{i}"
            _write_png(nerfdir / (fname + ".png"),
                       rng.integers(0, 255, (H, W, channels)).astype(np.uint8))
            frames.append({"file_path": fname,
                           "transform_matrix": pose_spherical(i * 30.0, -20, 3.0).tolist()})
        with open(nerfdir / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    verts = [(-2.0, -1.0, 0.0), (3.0, 4.0, 2.5)]
    verts += [tuple(v) for v in rng.uniform(verts[0], verts[1], (n_vertex - 2, 3))]
    extra = n_vertex > 2
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {n_vertex}\n"
              "property float x\nproperty float y\nproperty float z\n"
              + ("property uchar red\n" if extra else "")
              + "element face 0\nproperty list uchar int vertex_indices\nend_header\n").encode()
    fmt = "<fffB" if extra else "<fff"
    with open(scandir / f"{sceneID}_vh_clean.ply", "wb") as f:
        f.write(header + b"".join(struct.pack(fmt, *v, *((7,) if extra else ())) for v in verts))
    return sceneID


def deepvoxels_set(root, n_train=4):
    rng = np.random.default_rng(1)
    scene = "greek"
    for split, n in [("train", n_train), ("test", 2), ("validation", 2)]:
        base = root / split / scene
        os.makedirs(base / "pose")
        os.makedirs(base / "rgb")
        for i in range(n):
            m = np.eye(4)
            m[:3, 3] = [0, 0, 2.0 + 0.1 * i]
            with open(base / "pose" / f"{i:03d}.txt", "w") as f:
                f.write(" ".join(str(v) for v in m.ravel()))
            _write_png(base / "rgb" / f"{i:03d}.png",
                       rng.integers(0, 255, (512, 512, 3)).astype(np.uint8))
        if split == "train":
            with open(base / "intrinsics.txt", "w") as f:
                f.write("400.0 256.0 256.0\n0 0 0\n1.0\n1.0\n512 512\n0\n")
    return scene


def linemod_set(root, H=16, W=16, channels=3):
    rng = np.random.default_rng(2)
    K = [[120.0, 0, 8.0], [0, 120.0, 8.0], [0, 0, 1.0]]
    for split, n in [("train", 3), ("val", 1), ("test", 2)]:
        frames = []
        os.makedirs(root / split, exist_ok=True)
        for i in range(n):
            fp = str(root / split / f"{i}.png")
            _write_png(fp, rng.integers(0, 255, (H, W, channels)).astype(np.uint8))
            frames.append({"file_path": fp,
                           "transform_matrix": pose_spherical(i * 50.0, -30, 2.5).tolist(),
                           "intrinsic_matrix": K})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"frames": frames, "near": 0.4, "far": 2.2}, f)


def assert_scenes_equal(got, want, atol=0.0):
    """Every field of two Scenes; images within atol (0: bit for bit)."""
    if atol:
        np.testing.assert_allclose(got.images, want.images, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got.images, want.images)
    assert got.images.dtype == np.float32
    for name in ("poses", "render_poses", "K", "i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert tuple(got.hwf) == tuple(want.hwf)
    assert (got.near, got.far, got.ndc, got.lindisp) == (want.near, want.far, want.ndc, want.lindisp)
    if want.bounding_box is None:
        assert got.bounding_box is None
    else:
        for a, b in zip(got.bounding_box, want.bounding_box):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.bbox_array(), want.bbox_array())


# --------------------------------------------------------------------------- #
# Each loader against JAX's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("half_res,n_vertex", [(False, 2), (True, 500)])
def test_scannet_matches_jax(tmp_path, half_res, n_vertex):
    """INTER_AREA as resize_area computes it: to float32 rounding of cv2's
    (tests/test_torch_blender.py), so half_res images at atol 1e-6."""
    from hashnerf_tpu.data.scannet import load_scannet_scene as jload
    from hashnerf_torch.data.scannet import load_scannet_scene

    sceneID = scannet_set(tmp_path, n_vertex=n_vertex)
    got = load_scannet_scene(str(tmp_path), sceneID, half_res=half_res, trainskip=2)
    want = jload(str(tmp_path), sceneID, half_res=half_res, trainskip=2)
    assert_scenes_equal(got, want, atol=1e-6 if half_res else 0.0)
    assert len(got.i_train) == 5 and got.images.shape[1:3] == ((12, 12) if half_res else (24, 24))
    np.testing.assert_allclose(got.bounding_box[0], [-3.0, -2.0, -1.0])
    np.testing.assert_allclose(got.bounding_box[1], [4.0, 5.0, 3.5])


def test_deepvoxels_matches_jax(tmp_path):
    from hashnerf_tpu.data.deepvoxels import load_deepvoxels_scene as jload
    from hashnerf_torch.data.deepvoxels import load_deepvoxels_scene

    scene = deepvoxels_set(tmp_path)
    for testskip in (1, 2):
        got = load_deepvoxels_scene(scene, str(tmp_path), testskip=testskip)
        want = jload(scene, str(tmp_path), testskip=testskip)
        assert_scenes_equal(got, want)
        assert got.near == pytest.approx(got.far - 2.0) and got.bounding_box is None
        np.testing.assert_array_equal(got.bbox_array(), [[-10.0] * 3, [10.0] * 3])


@pytest.mark.parametrize("channels,half_res,white_bkgd", [(3, False, False), (4, True, True),
                                                        (4, False, False)])
def test_linemod_matches_jax(tmp_path, channels, half_res, white_bkgd):
    from hashnerf_tpu.data.linemod import load_linemod_scene as jload
    from hashnerf_torch.data.linemod import load_linemod_scene

    linemod_set(tmp_path, channels=channels)
    got = load_linemod_scene(str(tmp_path), half_res=half_res, testskip=1, white_bkgd=white_bkgd)
    want = jload(str(tmp_path), half_res=half_res, testskip=1, white_bkgd=white_bkgd)
    assert_scenes_equal(got, want, atol=1e-6 if half_res else 0.0)
    assert got.K[0, 0] == (60.0 if half_res else 120.0)
    assert (got.near, got.far) == (0.0, 3.0)


# --------------------------------------------------------------------------- #
# PLY bounds
# --------------------------------------------------------------------------- #

def _ply(path, fmt, verts, extra_props=()):
    head = [f"ply", f"format {fmt} 1.0", "comment made by a test",
            f"element vertex {len(verts)}"]
    head += [f"property {t} {n}" for n, t in (("x", "float"), ("y", "float"), ("z", "float"))
             + tuple(extra_props)]
    head += ["element face 1", "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if fmt == "ascii":
            for v in verts:
                f.write((" ".join(str(x) for x in v) + " " * bool(extra_props)
                         + " ".join("3" for _ in extra_props) + "\n").encode())
            f.write(b"3 0 1 2\n")
        else:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
                          + [(n, {"uchar": "u1", "double": "<f8"}[t]) for n, t in extra_props])
            arr = np.zeros(len(verts), dt)
            for i, c in enumerate("xyz"):
                arr[c] = [v[i] for v in verts]
            f.write(arr.tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("extra", [(), (("red", "uchar"), ("quality", "double"))], ids=["xyz", "extra"])
def test_ply_vertex_bounds_match_jax(tmp_path, fmt, extra):
    from hashnerf_tpu.data.scannet import ply_vertex_bounds as jbounds
    from hashnerf_torch.data.scannet import ply_vertex_bounds

    verts = [tuple(v) for v in np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)]
    path = tmp_path / "m.ply"
    _ply(path, fmt, verts, extra)
    got, want = ply_vertex_bounds(str(path)), jbounds(str(path))
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], np.min(np.asarray(verts, np.float64), 0))


def test_ply_refusals(tmp_path):
    from hashnerf_torch.data.scannet import ply_vertex_bounds

    (tmp_path / "no.ply").write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        ply_vertex_bounds(str(tmp_path / "no.ply"))
    _ply(tmp_path / "be.ply", "binary_big_endian", [(0.0, 1.0, 2.0)])
    with pytest.raises(ValueError, match="unsupported PLY format"):
        ply_vertex_bounds(str(tmp_path / "be.ply"))


# --------------------------------------------------------------------------- #
# Dispatch and the CLI
# --------------------------------------------------------------------------- #

def _cli(root, dataset_type, tmp_path, *flags):
    from hashnerf_torch.run_nerf import main

    return main(["--dataset_type", dataset_type, "--datadir", str(root), "--basedir",
                 str(tmp_path / "logs"), "--device", "cpu", "--N_rand", "64", "--N_samples", "8",
                 "--N_importance", "8", "--N_iters", "6", "--i_weights", "6", "--i_print", "3",
                 "--i_testset", "6", "--i_video", "0", "--testskip", "1", "--no_reload", *flags])


def _check_run(trainer, tmp_path, n_test):
    (exp,) = os.listdir(tmp_path / "logs")
    files = os.listdir(tmp_path / "logs" / exp)
    assert trainer.global_step == 6 and "000006.ckpt" in files
    assert all(np.isfinite(h[1]) for h in trainer.history) and len(trainer.history) == 2
    figs = os.listdir(tmp_path / "logs" / exp / "testset_000006")
    assert sum(f.endswith(".png") for f in figs) == n_test


def test_scannet_cli(tmp_path):
    """configs/scannet_scene0000.txt's flags (hash grid, ray pool, lrate
    0.01) at small widths: trainskip 10 keeps one train frame of ten."""
    root = tmp_path / "ScanNet"
    scannet_set(root)
    t = _cli(root, "scannet", tmp_path, "--config", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
        "scannet_scene0000.txt"), "--log2_hashmap_size", "10", "--finest_res", "64",
        "--N_rand", "64", "--N_samples", "8", "--N_importance", "8")
    assert t.args.lrate == 0.01 and not t.args.no_batching and t.state.hash_table is not None
    assert len(t.scene.i_train) == 1 and t.bbox.tolist() == [[-3.0, -2.0, -1.0], [4.0, 5.0, 3.5]]
    _check_run(t, tmp_path, 2)


def test_deepvoxels_cli(tmp_path):
    """The positional NeRF (6 x 16 here) with Adam on a deepvoxels set; one
    512 x 512 test view (testskip 2)."""
    from hashnerf_torch.models.nerf import NeRF
    from hashnerf_torch.train.adam import Adam

    deepvoxels_set(tmp_path / "dv", n_train=2)
    t = _cli(tmp_path / "dv", "deepvoxels", tmp_path, "--i_embed", "0", "--i_embed_views", "0",
             "--use_viewdirs", "--netdepth", "6", "--netwidth", "16", "--netdepth_fine", "6",
             "--netwidth_fine", "16", "--chunk", "65536", "--testskip", "2")
    assert isinstance(t.state.coarse, NeRF) and isinstance(t.optimizer, Adam)
    assert t.state.hash_table is None and t.bbox.tolist() == [[-10.0] * 3, [10.0] * 3]
    _check_run(t, tmp_path, 1)


def test_linemod_cli(tmp_path):
    """The hash-grid defaults with LINEMOD's K and the +-10 fallback box."""
    linemod_set(tmp_path / "lm")
    t = _cli(tmp_path / "lm", "LINEMOD", tmp_path, "--log2_hashmap_size", "10", "--finest_res", "64",
             "--use_viewdirs")
    assert t.scene.K[0, 0] == 120.0 and t.bbox.tolist() == [[-10.0] * 3, [10.0] * 3]
    _check_run(t, tmp_path, 2)

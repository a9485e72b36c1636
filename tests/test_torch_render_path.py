"""Renders to disk: `render_path` with render_factor 0 and 2 against the JAX
package, the figures and the PSNR pickle, the plasma table against
matplotlib's, the videos (GIF, and the ffmpeg pipe), and the blender CLI on
the CPU: train, checkpoint, test-set figures, video, then --render_only."""
import glob
import os
import pickle
import stat

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def states():
    """(JAX state and query_fn, port state) from one JAX init, its table
    scaled to U(-1, 1) so that the views have structure."""
    from hashnerf_tpu.models.factory import ModelConfig as JModel, create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JHash
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    hg = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=10, finest_resolution=32)
    jstate, jquery = create_model(jax.random.PRNGKey(3), JModel(N_importance=8, hash_grid=JHash(**hg)))
    jstate = jstate._replace(hash_table=jstate.hash_table * 1e4)
    state = NGPState(ModelConfig(N_importance=8, hash_grid=HashGridConfig(**hg)), device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(state, np.asarray(jstate.hash_table), to_np(jstate.coarse), to_np(jstate.fine))
    return jstate, jquery, state


@pytest.mark.parametrize("render_factor", [0, 2])
def test_render_path_matches_jax(tmp_path, states, render_factor):
    from hashnerf_tpu.data.pose_paths import pose_spherical
    from hashnerf_tpu.render.renderer import RenderConfig as JRC, render_path as jrender_path
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import RenderConfig, render_path
    from hashnerf_torch.utils.metrics import to8b
    from hashnerf_torch.utils.png import read_png

    jstate, jquery, state = states
    H, W = 12, 16
    focal = 0.5 * W / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    poses = np.stack([pose_spherical(a, -30.0, 4.0) for a in (10.0, 130.0)])
    gt = np.random.default_rng(0).random((2, H, W, 3)).astype(np.float32)
    bbox = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    common = dict(N_samples=8, N_importance=8, perturb=False, white_bkgd=True)
    want = jrender_path(jstate, jquery, poses, (H, W, focal), K, jnp.asarray(bbox), JRC(**common),
                        chunk=64, near=2.0, far=6.0, gt_imgs=gt, render_factor=render_factor)
    savedir = str(tmp_path / "figs")
    got = render_path(state, query_fn, poses, (H, W, focal), K, torch.as_tensor(bbox),
                      RenderConfig(**common), chunk=64, near=2.0, far=6.0, gt_imgs=gt,
                      savedir=savedir, render_factor=render_factor)
    h, w = (H, W) if render_factor == 0 else (H // render_factor, W // render_factor)
    assert got[0].shape == (2, h, w, 3) and got[1].shape == (2, h, w)
    # the fine pass's render tolerance (ROADMAP C)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=3e-4)
    assert float(got[0].std()) > 0.01  # the view has structure
    figs = sorted(glob.glob(os.path.join(savedir, "*.png")))
    assert [os.path.basename(f) for f in figs] == ["000.png", "001.png"]
    for i, f in enumerate(figs):
        fig = read_png(f)
        assert fig.shape == (h, 2 * w, 3)
        np.testing.assert_array_equal(fig[:, :w], to8b(got[0][i]))
    if render_factor == 0:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
        (pkl,) = glob.glob(os.path.join(savedir, "test_psnrs_avg*.pkl"))
        with open(pkl, "rb") as f:
            assert pickle.load(f) == got[2]
    else:
        assert got[2] == want[2] == []
        assert not glob.glob(os.path.join(savedir, "*.pkl"))


def test_plasma_table_matches_matplotlib():
    from hashnerf_torch.utils.io import PLASMA, colorize_depth

    cmap = matplotlib.colormaps["plasma"]
    want = cmap(np.arange(256) / 255.0, bytes=True)[:, :3]
    assert np.abs(PLASMA.astype(int) - want.astype(int)).max() <= 1
    d = np.concatenate([np.linspace(-0.2, 1.2, 997), [0.0, 1.0, 0.5, 255.5 / 256]]).astype(np.float32)
    got = colorize_depth(d.reshape(1, -1))[0]
    want = cmap(matplotlib.colors.Normalize(0, 1)(d), bytes=True)[:, :3]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_gif_video_has_every_frame(tmp_path, monkeypatch):
    """With no ffmpeg on PATH the video is an animated GIF beside the mp4's
    name, every frame there in the GIF palette's nearest colours."""
    from hashnerf_torch.utils.io import GIF_PALETTE, gif_indices, save_video
    from hashnerf_torch.utils.metrics import to8b

    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    frames = np.random.default_rng(1).random((7, 21, 34, 3)).astype(np.float32)
    path = save_video(str(tmp_path / "v.mp4"), frames)
    assert path == str(tmp_path / "v.gif")
    got = imageio.mimread(path)
    assert len(got) == 7
    for a, f in zip(got, frames):
        assert a.shape[:2] == (21, 34)
        np.testing.assert_array_equal(a[..., :3], GIF_PALETTE[gif_indices(to8b(f))])
    # gray frames (the disparity video) are written as RGB
    save_video(str(tmp_path / "d.mp4"), frames[..., 0])
    assert len(imageio.mimread(str(tmp_path / "d.gif"))) == 7


def test_video_pipes_frames_to_ffmpeg(tmp_path, monkeypatch):
    """With an `ffmpeg` on PATH the frames go to it as rgb24 on stdin, and
    its failure raises."""
    from hashnerf_torch.utils.io import save_video

    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "ffmpeg"
    fake.write_text("#!/bin/sh\n"
                    "for a in \"$@\"; do last=$a; done\n"
                    "case \"$last\" in *fail*) exit 3;; esac\n"
                    "cat > \"$last\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ.get("PATH", ""))
    frames = np.random.default_rng(2).random((5, 9, 11, 3)).astype(np.float32)
    out = save_video(str(tmp_path / "v.mp4"), frames)
    assert out == str(tmp_path / "v.mp4")
    data = np.fromfile(out, np.uint8)
    np.testing.assert_array_equal(data, (255 * np.clip(frames, 0, 1)).astype(np.uint8).ravel())
    with pytest.raises(RuntimeError, match="ffmpeg failed"):
        save_video(str(tmp_path / "fail.mp4"), frames)


# --------------------------------------------------------------------------- #
# The blender CLI on the CPU
# --------------------------------------------------------------------------- #

TINY = ["--device", "cpu", "--log2_hashmap_size", "10", "--finest_res", "32", "--N_samples", "8",
        "--N_importance", "8", "--N_rand", "64", "--precrop_iters", "0", "--testskip", "1",
        "--chunk", "4096"]


def _psnrs(d):
    (pkl,) = glob.glob(os.path.join(d, "test_psnrs_avg*.pkl"))
    with open(pkl, "rb") as f:
        return pickle.load(f)


def test_blender_cli_trains_renders_and_renders_only(tmp_path):
    from hashnerf_torch.run_nerf import main
    from hashnerf_torch.tools.make_blender_dataset import main as make_set
    from hashnerf_torch.utils.png import read_png

    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    make_set([data, "--hw", "24", "--n_train", "3", "--n_val", "1", "--n_test", "2", "--ss", "1"])
    base = ["--config", os.path.join(ROOT, "configs", "chair.txt"), "--datadir", data,
            "--basedir", logs, *TINY]
    trainer = main(base + ["--N_iters", "10", "--i_weights", "10", "--i_testset", "10",
                           "--i_video", "10", "--i_print", "5"])
    assert trainer.scene.H == trainer.scene.W == 12  # half_res
    (exp,) = glob.glob(os.path.join(logs, "*"))
    name = os.path.basename(exp)
    assert os.path.exists(os.path.join(exp, "000010.ckpt"))
    testdir = os.path.join(exp, "testset_000010")
    for i in range(2):
        assert read_png(os.path.join(testdir, f"{i:03d}.png")).shape == (12, 24, 3)
    psnrs = _psnrs(testdir)
    assert len(psnrs) == 2 and all(np.isfinite(psnrs))
    for kind in ("rgb", "disp"):
        frames = imageio.mimread(os.path.join(exp, f"{name}_spiral_000010_{kind}.gif"))
        assert len(frames) == 40 and frames[0].shape[:2] == (12, 12)

    # render only: the same weights, the same PSNRs
    r = main(base + ["--N_iters", "10", "--render_only", "--render_test"])
    assert r.global_step == 10
    onlydir = os.path.join(exp, "renderonly_test_000010")
    assert _psnrs(onlydir) == psnrs
    assert len(imageio.mimread(os.path.join(onlydir, "video.gif"))) == 2
    main(base + ["--N_iters", "10", "--render_only", "--render_factor", "2"])
    pathdir = os.path.join(exp, "renderonly_path_000010")
    figs = sorted(glob.glob(os.path.join(pathdir, "*.png")))
    assert len(figs) == 40 and read_png(figs[0]).shape == (6, 12, 3)
    assert not glob.glob(os.path.join(pathdir, "*.pkl"))

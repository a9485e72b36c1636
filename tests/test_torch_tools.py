"""The port's user tools (hashnerf_torch/tools/, graft_entry.py) against the
JAX package's on the CPU: collect_frames and the stamped GIF, the frustum
geometry and the host plots, the quality curves' milestones over the
repo's BENCH_QUALITY_*.json, the parity merge over the recorded curves,
the two-host projection over SCALING_r05.json, the graft entry's render,
the checkpoint re-renders; and the entry points that run on the card
unless told otherwise: with no card and no device named they raise before
they start anything.

Render tolerance (ROADMAP §C): the fine pass's rtol 1e-4 / atol 5e-5."""
import glob
import json
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINE_RTOL, FINE_ATOL = 1e-4, 5e-5


def _frame_tree(root, shapes=(12, 20)):
    """A log directory of render dirs (and others collect_frames skips);
    each dir's first frame filled with its iteration's value."""
    from hashnerf_torch.utils.png import write_png

    H, W = shapes
    rng = np.random.default_rng(0)
    made = {}
    for d, it in (("renderonly_test_000064", 64), ("renderonly_path_000032", 32),
                  ("testset_000128", 128), ("renderonly_test_000016", 16)):
        os.makedirs(os.path.join(root, d))
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        write_png(os.path.join(root, d, "000.png"), img)
        write_png(os.path.join(root, d, "001.png"), 255 - img)
        made[it] = img
    os.makedirs(os.path.join(root, "testset_000256"))  # no frame
    os.makedirs(os.path.join(root, "renders_000512"))  # not a render dir
    write_png(os.path.join(root, "renders_000512", "000.png"), made[16])
    return made


def test_collect_frames_matches_jax(tmp_path):
    from hashnerf_tpu.tools.make_gif import collect_frames as jcollect
    from hashnerf_torch.tools.make_gif import collect_frames

    _frame_tree(str(tmp_path))
    got = collect_frames(str(tmp_path))
    assert got == jcollect(str(tmp_path))
    assert [it for it, _ in got] == [16, 32, 64, 128]


def test_make_gif_frames_in_order_and_unstamped_pixels_kept(tmp_path):
    """Every pixel outside the stamp's box is the frame's, as the GIF's
    palette maps it (utils/io.py::gif_indices); inside it, the glyphs'
    pixels are the stamp's colour; the frames are in iteration order."""
    from hashnerf_torch.tools.make_gif import STAMP_RGB, make_gif, stamp, stamp_box
    from hashnerf_torch.utils.io import GIF_PALETTE, gif_indices

    made = _frame_tree(str(tmp_path / "logs"), shapes=(24, 80))
    out = make_gif(str(tmp_path / "logs"), str(tmp_path / "conv.gif"))
    frames = [np.asarray(f)[..., :3] for f in imageio.mimread(out)]
    assert len(frames) == 4
    for f, it in zip(frames, sorted(made)):
        text = f"iter {it}"
        y0, x0, y1, x1 = stamp_box(text)
        outside = np.ones(f.shape[:2], bool)
        outside[y0:y1, x0:x1] = False
        want = GIF_PALETTE[gif_indices(made[it])]
        np.testing.assert_array_equal(f[outside], want[outside], err_msg=text)
        drawn = np.any(stamp(made[it], text) != made[it], -1)
        assert drawn.sum() > 10 * len(text.replace(" ", ""))
        assert not drawn[outside].any()
        np.testing.assert_array_equal(f[drawn], GIF_PALETTE[gif_indices(
            np.broadcast_to(np.array(STAMP_RGB, np.uint8), (int(drawn.sum()), 3)))])
    with pytest.raises(FileNotFoundError):
        make_gif(str(tmp_path / "logs" / "renders_000512"), str(tmp_path / "none.gif"))


def test_frustum_faces_match_jax_collections(monkeypatch):
    """The vertices of the Poly3DCollection JAX's add_pose draws, for poses
    of pose_spherical (and a focal scale and aspect of their own)."""
    import matplotlib

    matplotlib.use("Agg")
    from mpl_toolkits.mplot3d import art3d

    from hashnerf_tpu.data.pose_paths import pose_spherical
    from hashnerf_tpu.tools.pose_visualizer import CameraPoseVisualizer
    from hashnerf_torch.tools.pose_visualizer import frustum_faces

    drawn = []

    class Recording(art3d.Poly3DCollection):
        def __init__(self, verts, *a, **k):
            drawn.append([np.asarray(v) for v in verts])
            super().__init__(verts, *a, **k)

    monkeypatch.setattr(art3d, "Poly3DCollection", Recording)
    viz = CameraPoseVisualizer()
    cases = [(pose_spherical(th, ph, r), {}) for th, ph, r in
             ((-180.0, -30.0, 4.0), (35.0, -10.0, 3.0), (90.0, 60.0, 2.5))]
    cases.append((pose_spherical(10.0, -45.0, 4.0), {"focal_scale": 0.7, "aspect": 0.4}))
    for c2w, kw in cases:
        viz.add_pose(c2w, **kw)
    viz.plt.close(viz.fig)
    assert len(drawn) == len(cases)
    for (c2w, kw), want in zip(cases, drawn):
        got = frustum_faces(c2w, **kw)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_host_plots_write_their_pngs(tmp_path):
    from hashnerf_torch.tools.blender_render_poses import plot_render_path
    from hashnerf_torch.tools.plot_losses import plot_losses
    from hashnerf_torch.tools.pose_visualizer import visualize_transforms
    from hashnerf_torch.utils.io import save_loss_history
    from hashnerf_torch.utils.png import read_png

    save_loss_history(str(tmp_path), [1.0, 0.5, 0.2], [10.0, 14.0, 18.0], [0.1, 0.2, 0.3])
    frames = [{"transform_matrix": np.eye(4).tolist()} for _ in range(3)]
    (tmp_path / "transforms.json").write_text(json.dumps({"frames": frames}))
    outs = [plot_losses(str(tmp_path), str(tmp_path / "losses.png")),
            plot_render_path(str(tmp_path / "path.png"), n=8),
            visualize_transforms(str(tmp_path / "transforms.json"), str(tmp_path / "poses.png"))]
    for out in outs:
        img = read_png(out)
        assert img.ndim == 3 and img.shape[0] > 100 and img.shape[1] > 100, out
    assert sorted(os.listdir(tmp_path)) == ["loss_vs_time.pkl", "losses.png", "path.png",
                                            "poses.png", "transforms.json"]


def test_quality_milestones_match_jax_on_the_recorded_curves():
    """iters_to_db and train_s_to_db of every BENCH_QUALITY_*.json in the
    repo (read, never written) equal JAX's, at its milestones and between."""
    from hashnerf_tpu.tools import quality_summary as jqs
    from hashnerf_torch.tools.quality_summary import MILESTONES, iters_to_db, train_s_to_db

    paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_QUALITY_*.json")))
    assert len(paths) > 40
    n_reached = 0
    for path in paths:
        with open(path) as f:
            curve = json.load(f)["curve"]
        for db in MILESTONES + (15.0, 22.5, 29.0, 31.5):
            got, want = iters_to_db(curve, db), jqs.iters_to_db(curve, db)
            assert got == want, (path, db)
            assert train_s_to_db(curve, db) == jqs.train_s_to_db(curve, db), (path, db)
            n_reached += got is not None
    assert n_reached > 100


def test_quality_summary_tables(tmp_path):
    """The port's summary over curves of its own (the tables' rows and
    milestone cells), with the parity section from a merged file."""
    from hashnerf_torch.tools.parity_curve import merge
    from hashnerf_torch.tools.quality_summary import main

    curve = [{"iter": 128 * (i + 1), "test_psnr": p, "train_psnr": p, "wall_s": 3.0 * i,
              "train_s": 1.5 * (i + 1)} for i, p in enumerate((18.0, 23.0, 27.0, 31.0))]
    rec = {"mode": "tpu-fast", "device": "cpu", "scene": "sphere", "N_rand": 1024,
           "packed": False, "steady_step_ms": 2.5, "curve": curve}
    (tmp_path / "q_a.json").write_text(json.dumps(rec))
    (tmp_path / "q_b.json").write_text(json.dumps({**rec, "mode": "parity"}))
    (tmp_path / "other.json").write_text(json.dumps({"no": "curve"}))
    pc = str(tmp_path / "pc.json")
    merge(pc, sorted(glob.glob(os.path.join(ROOT, "PARITY_CURVE_ref*.json"))),
          sorted(glob.glob(os.path.join(ROOT, "PARITY_CURVE_ours*.json"))))
    out = tmp_path / "summary.md"
    text = main(["--json-glob", str(tmp_path / "q_*.json"), "--out", str(out), "--parity", pc])
    assert out.read_text() == text
    assert "| tpu-fast | cpu | sphere | 1024 | False | 512 | 31.00 | 31.00 | 2.5 |" in text
    # 20 dB at 128 + (2 / 5) * 128 = 179.2 -> 179 iterations: 0.4475 s at 2.5 ms
    assert "| tpu-fast | 2.5 | 0.4s @179 |" in text
    assert "**PASS**" in text and text.count("| parity |") == 3


def test_parity_merge_reproduces_the_recorded_anchor(tmp_path):
    """merge over the repo's PARITY_CURVE_ref*.json and
    PARITY_CURVE_ours*.json (read only) gives PARITY_CURVE.json's
    milestones, deltas and gate, written where the caller says."""
    from hashnerf_torch.tools.parity_curve import GATE, merge

    with open(os.path.join(ROOT, "PARITY_CURVE.json")) as f:
        want = json.load(f)
    out = tmp_path / "merged.json"
    got = merge(str(out), glob.glob(os.path.join(ROOT, "PARITY_CURVE_ref*.json")),
                glob.glob(os.path.join(ROOT, "PARITY_CURVE_ours*.json")))
    assert json.loads(out.read_text()) == got
    for k in ("milestones", "min_delta_db", "mean_delta_db", "final", "gate", "gate_pass",
              "reference_wall_s", "ours_wall_s"):
        assert got[k] == want[k], k
    assert got["gate"] == GATE and got["gate_pass"] is True
    assert got["protocol"]["n_seeds"] == want["protocol"]["n_seeds"]


def test_parity_reference_stage_raises():
    from hashnerf_torch.tools.parity_curve import main

    with pytest.raises(RuntimeError, match="recorded curves"):
        main(["reference"])


def test_projection_reproduces_the_recorded_table():
    """projection() over SCALING_r05.json's own wire (its ZeRO-1
    collectives through wire_mb) and step times gives its rows and its
    bandwidths for 85%."""
    from hashnerf_torch.tools.bench_scaling import projection, wire_mb

    with open(os.path.join(ROOT, "SCALING_r05.json")) as f:
        rec = json.load(f)["projected_2host"]
    wire = wire_mb(rec["zero1_collectives_2dev"], 2)
    assert round(wire, 2) == rec["zero1_wire_mb_per_host"]
    steps = {}
    for row in rec["projection"]:
        steps.setdefault(row["step"], row["step_ms"])
    grid = tuple(dict.fromkeys(r["dcn_gbps_per_host"] for r in rec["projection"]))
    rows, need = projection(wire, steps, grid)
    assert rows == rec["projection"]
    assert need == rec["dcn_gbps_needed_for_85pct"]


# a ray that absorbs less than this keeps no significant bit in its
# normalized depth: 1 - exp(-sigma * delta) of a sigma * delta near 1e-7
# rounds to a few float32 steps, so sum(w z) / sum(w) is a ratio of rounding
# noise there (the JAX entry's drawn table leaves acc at 2e-6 on some rays)
DEPTH_ACC_FLOOR = 1e-4


@pytest.mark.parametrize("table_scale", [1.0, 1e4, 1e5])
def test_graft_entry_forward_matches_jax(table_scale):
    """entry()'s forward on JAX entry()'s state (its table as drawn, and
    scaled so that the rays absorb more) and rays gives JAX's rgb, acc and
    depth within the fine pass's render tolerance: depth where a ray
    absorbs DEPTH_ACC_FLOOR or more, its unnormalized sum(w z) elsewhere."""
    import __graft_entry__ as jentry
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.graft_entry import N_RAYS, entry

    jfwd, (jstate, jo, jd, jkey) = jentry.entry()
    jstate = jstate._replace(hash_table=jstate.hash_table * table_scale)
    want = [np.asarray(x) for x in jax.jit(jfwd)(jstate, jo, jd, jkey)]
    fwd, (state, rays_o, rays_d) = entry("cpu")
    assert rays_o.shape == rays_d.shape == (N_RAYS, 3)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(state, np.asarray(jstate.hash_table), to_np(jstate.coarse), to_np(jstate.fine))
    with torch.no_grad():
        got = [g.numpy() for g in fwd(state, torch.tensor(np.asarray(jo)),
                                      torch.tensor(np.asarray(jd)))]
    assert all(np.isfinite(g).all() for g in got)
    (rgb, depth, acc), (jrgb, jdepth, jacc) = got, want
    np.testing.assert_allclose(rgb, jrgb, rtol=FINE_RTOL, atol=FINE_ATOL, err_msg="rgb")
    np.testing.assert_allclose(acc, jacc, rtol=FINE_RTOL, atol=FINE_ATOL, err_msg="acc")
    lit = jacc >= DEPTH_ACC_FLOOR
    np.testing.assert_allclose(depth[lit], jdepth[lit], rtol=FINE_RTOL, atol=FINE_ATOL,
                               err_msg="depth")
    np.testing.assert_allclose(depth[~lit] * acc[~lit], jdepth[~lit] * jacc[~lit],
                               rtol=FINE_RTOL, atol=FINE_ATOL, err_msg="sum(w z)")
    if table_scale > 1:  # the depth comparison holds rays (20 of the 256 here)
        assert lit.sum() >= 16, int(lit.sum())


# a table that absorbs and stays well conditioned: each level's features are
# a constant vector c * v (v drawn from a seed, the first of LIT_SEEDS that
# lights LIT_MIN rays) times 1 + LIT_NOISE * U(-1, 1) per entry, so the
# hashing still matters (a wrong row moves a feature by up to 30%) while a
# rounding-level change of the rays moves rgb by 1.3e-6 relatively at most.
# The drawn table scaled until the rays absorb (x 1e6) is ill conditioned:
# there a 1e-7 relative change of the rays moves rgb by 7.6e-4.
LIT_SCALE, LIT_NOISE, LIT_SEEDS = 10.0, 0.3, 64
LIT_ACC, LIT_MIN = 0.5, 192


def lit_table(fwd, state, rays_o, rays_d):
    """The first LIT_SEEDS table that lights LIT_MIN of the rays (acc >=
    LIT_ACC) through fwd on state (its MLPs as given), as a CPU tensor."""
    L, T, F = state.hash_table.shape
    noise = torch.rand((L, T, F), generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        for seed in range(LIT_SEEDS):
            v = torch.rand((L, 1, F), generator=torch.Generator().manual_seed(100 + seed)) * 2 - 1
            table = LIT_SCALE * v * (1 + LIT_NOISE * noise)
            state.hash_table.copy_(table)
            if int((fwd(state, rays_o, rays_d)[2] >= LIT_ACC).sum()) >= LIT_MIN:
                return table
    raise AssertionError(f"no table of {LIT_SEEDS} lights {LIT_MIN} rays")


def test_graft_entry_forward_matches_jax_on_lit_rays():
    """entry()'s forward on JAX entry()'s MLPs, a lit_table and rays from
    its origin aimed at points drawn in [-1, 1]^3: on the rays that absorb
    LIT_ACC or more (LIT_MIN at least), rgb, depth and acc are JAX's within
    the fine render tolerance, relatively."""
    import __graft_entry__ as jentry
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.graft_entry import N_RAYS, entry

    jfwd, (jstate, jo, _, jkey) = jentry.entry()
    aim = np.random.default_rng(2).uniform(-1, 1, (N_RAYS, 3)) - np.asarray(jo)
    aim = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    fwd, (state, _, _) = entry("cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(state, np.asarray(jstate.hash_table), to_np(jstate.coarse), to_np(jstate.fine))
    rays_o = torch.tensor(np.asarray(jo))
    table = lit_table(fwd, state, rays_o, torch.tensor(aim))
    jstate = jstate._replace(hash_table=jax.numpy.asarray(table.numpy()))
    want = [np.asarray(x) for x in jax.jit(jfwd)(jstate, jo, jax.numpy.asarray(aim), jkey)]
    with torch.no_grad():
        got = [g.numpy() for g in fwd(state, rays_o, torch.tensor(aim))]
    assert all(np.isfinite(g).all() for g in got)
    lit = want[2] >= LIT_ACC
    assert lit.sum() >= LIT_MIN, int(lit.sum())
    for name, g, w in zip(("rgb", "depth", "acc"), got, want):
        np.testing.assert_allclose(g[lit], w[lit], rtol=FINE_RTOL, atol=0, err_msg=name)


def test_graft_entry_reexports_the_dry_run():
    from hashnerf_torch import graft_entry
    from hashnerf_torch.parallel import dryrun

    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip


def test_run_all_checkpoints_renders_each(tmp_path):
    """A 4-step CPU run with a checkpoint every 2 steps: each checkpoint is
    rendered into its renderonly_test_ dir, whose first frames make_gif
    stitches in order; an experiment with no checkpoint raises."""
    from hashnerf_torch import run_nerf
    from hashnerf_torch.tools import make_gif, run_all_checkpoints

    base = ["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"), "--device", "cpu",
            "--basedir", str(tmp_path), "--N_rand", "32", "--N_samples", "8",
            "--N_importance", "8", "--log2_hashmap_size", "10", "--finest_res", "32",
            "--render_test"]
    trainer = run_nerf.main(base + ["--N_iters", "4", "--i_weights", "2", "--i_testset", "0",
                                    "--i_video", "0", "--i_print", "2"])
    from hashnerf_torch.train.config import create_expname, parse_args

    assert trainer.global_step == 4
    expdir = os.path.join(str(tmp_path), create_expname(parse_args(base)))
    assert sorted(f for f in os.listdir(expdir) if f.endswith(".ckpt")) == [
        "000002.ckpt", "000004.ckpt"]
    done = run_all_checkpoints.main(base)
    assert [os.path.basename(p) for p in done] == ["000002.ckpt", "000004.ckpt"]
    dirs = sorted(d for d in os.listdir(expdir) if d.startswith("renderonly_"))
    assert dirs == ["renderonly_test_000002", "renderonly_test_000004"]
    frames = make_gif.collect_frames(expdir)
    assert [it for it, _ in frames] == [2, 4]
    gif = make_gif.make_gif(expdir, str(tmp_path / "conv.gif"))
    assert len(imageio.mimread(gif)) == 2
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        run_all_checkpoints.main(base + ["--expname", "none"])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import hashnerf_torch.parallel.mesh as mesh

    def launched(*a, **k):
        raise AssertionError("ranks were launched")

    monkeypatch.setattr(mesh, "launch", launched)


ENTRY_POINTS = {
    "bench_scaling.measure": lambda: __import__(
        "hashnerf_torch.tools.bench_scaling", fromlist=["x"]).measure([1]),
    "dryrun_multichip": lambda: __import__(
        "hashnerf_torch.parallel.dryrun", fromlist=["x"]).dryrun_multichip(2),
    "multihost_smoke": lambda: __import__(
        "hashnerf_torch.tools.multihost_smoke", fromlist=["x"]).main([]),
    "collective_volumes": lambda: __import__(
        "hashnerf_torch.tools.bench_scaling", fromlist=["x"]).collective_volumes(2),
    "project_two_host": lambda: __import__(
        "hashnerf_torch.tools.bench_scaling", fromlist=["x"]).project_two_host({"s": 1.0}),
    "graft_entry": lambda: __import__("hashnerf_torch.graft_entry", fromlist=["x"]).entry(),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(monkeypatch, name):
    """With no CUDA device and no device named, each entry point raises
    (hashnerf_torch.resolve_device) before it launches a rank: none falls
    back to the CPU."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()

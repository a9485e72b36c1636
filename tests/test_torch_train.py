"""The port's training pieces against the JAX package: RAdam, the LR
schedule, the TV loss, 8 Trainer steps from one converted state with the
same batches and JAX's draws, the flag checks, and a CPU run of the CLI that
writes and restores a checkpoint."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch.train.radam import RAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# RAdam and the schedule
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b2,wd,eps,sgd", [
    (0.99, 1e-6, 1e-8, False),   # the net group
    (0.99, 0.0, 1e-15, False),   # the embedding group
    (0.99, 1e-2, 1e-8, False),
    (0.999, 1e-2, 1e-8, True),
])
def test_radam_matches_jax(b2, wd, eps, sgd):
    from hashnerf_tpu.train.driver import make_lr_schedule as jsched
    from hashnerf_tpu.train.radam import radam
    from hashnerf_torch.train.driver import make_lr_schedule

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = rng.normal(size=(12, 5, 3)).astype(np.float32)

    opt_j = radam(jsched(0.01, 1), b1=0.9, b2=b2, eps=eps, weight_decay=wd, degenerated_to_sgd=sgd)
    pj = {"p": jnp.asarray(p0)}
    sj = opt_j.init(pj)
    p = torch.nn.Parameter(_t(p0))
    opt_t = RAdam([p], lr=make_lr_schedule(0.01, 1), betas=(0.9, b2), eps=eps,
                  weight_decay=wd, degenerated_to_sgd=sgd)
    for i, gr in enumerate(grads):
        upd, sj = opt_j.update({"p": jnp.asarray(gr)}, sj, pj)
        pj = {"p": pj["p"] + upd["p"]}
        p.grad = _t(gr)
        opt_t.step()
        if b2 == 0.99 and not sgd and i < 5:
            # N_sma < 5 for steps 1-5 at beta2 = 0.99: no update at all
            np.testing.assert_array_equal(p.detach().numpy(), p0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj["p"]), rtol=1e-5, atol=1e-7,
                                   err_msg=f"step {i + 1}")
    assert not np.allclose(p.detach().numpy(), p0)


def test_lr_schedule_matches_jax():
    from hashnerf_tpu.train.driver import make_lr_schedule as jsched
    from hashnerf_torch.train.driver import make_lr_schedule

    js, ts = jsched(0.01, 10), make_lr_schedule(0.01, 10)
    for step in (0, 1, 7, 1000, 9999, 50000):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))), rtol=1e-6)


# --------------------------------------------------------------------------- #
# TV loss
# --------------------------------------------------------------------------- #

def test_tv_loss_matches_jax():
    from hashnerf_tpu.train.losses import total_variation_loss_all_levels as jtv
    from hashnerf_torch.train.losses import total_variation_loss_all_levels, tv_level_geometry

    L, log2_T, base, finest = 16, 10, 16, 64
    table = np.random.default_rng(1).normal(size=(L, 1 << log2_T, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    val_j, grad_j = jax.value_and_grad(lambda t: jtv(key, t, base, finest, log2_T))(jnp.asarray(table))
    keys = jax.random.split(key, L)
    mv = np.stack([
        np.asarray(jax.random.randint(keys[l], (3,), 0, r - c))
        for l, (r, c) in enumerate(tv_level_geometry(base, finest, l, L) for l in range(L))
    ])
    tt = _t(table).requires_grad_(True)
    val = total_variation_loss_all_levels(tt, base, finest, log2_T, min_vertices=_t(mv))
    val.backward()
    # sums of ~1e5 squared differences in another order
    np.testing.assert_allclose(float(val), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# 8 Trainer steps against the JAX Trainer
# --------------------------------------------------------------------------- #

SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                use_viewdirs=True, finest_res=64, log2_hashmap_size=10, white_bkgd=True,
                no_batching=True, perturb=1.0)


def _args(parser):
    args = parser.parse_args([])
    for k, v in SETTINGS.items():
        setattr(args, k, v)
    return args


def test_trainer_steps_match_jax():
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import TrainDraws, Trainer
    from hashnerf_torch.train.losses import tv_level_geometry

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    st = make_synthetic_scene(H=24, W=24, n_train=3, n_test=1)
    np.testing.assert_array_equal(sj.images, st.images)
    np.testing.assert_array_equal(sj.poses, st.poses)

    jt = JTrainer(_args(jparser()), sj)
    # A table of U(-1, 1) instead of U(-1e-4, 1e-4) (as after some training):
    # at the init scale sigma is ~1e-5, alpha = 1 - exp(-sigma * dist) cancels,
    # a few ulps between the two frameworks' exp() become percents of the
    # gradients, and RAdam's normalized updates (eps 1e-15 on the table) make
    # each of them a step of full size: from the init table, 55% of the
    # entries part by up to 2.5e-3 after 8 steps, even from the eager JAX step.
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    tt = Trainer(_args(config_parser()), st, device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(tt.state, np.asarray(jt.state.hash_table), to_np(jt.state.coarse),
                   to_np(jt.state.fine))

    L, R = 16, SETTINGS["N_rand"]
    rng = np.random.default_rng(0)
    for step in range(8):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, sj.K, sj.poses[img])
        b = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
             "target": sj.images[img][ys, xs], "near": np.full(R, 2.0, np.float32),
             "far": np.full(R, 6.0, np.float32)}

        # the draws the JAX step will take from its key
        _, k = jax.random.split(jt.key)
        k_render, k_tv = jax.random.split(k)
        k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
        tv_keys = jax.random.split(k_tv, L)
        mv = np.stack([
            np.asarray(jax.random.randint(tv_keys[l], (3,), 0, r - c))
            for l, (r, c) in enumerate(tv_level_geometry(16, 64, l, L) for l in range(L))
        ])
        draws = TrainDraws(
            render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, 8))),
                               u_pdf=_t(jax.random.uniform(k_pdf, (R, 8)))),
            tv_min_vertices=_t(mv),
        )
        # The JAX step runs op by op, as the port does. Jitted, XLA fuses and
        # reassociates its sums, and once RAdam starts to move (step 6) the
        # jitted JAX step leaves 44 of the 32768 table entries up to 7e-4
        # away from the eager JAX step: as far as it leaves the port.
        with jax.disable_jit():
            mj = jt.step({k_: jnp.asarray(v) for k_, v in b.items()})
        mt = tt.step({k_: _t(v) for k_, v in b.items()}, draws=draws)
        # float32 sums in other orders: 1e-4
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {step + 1}")
        np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]), rtol=1e-4,
                                   err_msg=f"psnr, step {step + 1}")
    assert tt.global_step == jt.global_step == 8

    np.testing.assert_allclose(tt.state.hash_table.detach().numpy(), np.asarray(jt.state.hash_table),
                               rtol=1e-4, atol=1e-6)
    for which in ("coarse", "fine"):
        net, jnet = getattr(tt.state, which), getattr(jt.state, which)
        for name in ("sigma_net", "color_net"):
            for layer, jl in zip(getattr(net, name), jnet[name]):
                np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                           rtol=1e-4, atol=1e-6, err_msg=f"{which}.{name}")


# --------------------------------------------------------------------------- #
# Flags, device, checkpoint and the CLI
# --------------------------------------------------------------------------- #

# rows check_supported refused until they were ported (A8.4 and A7.4 in
# slice 11)
PORTED_ROWS = ("A8.4", "A7.4")


@pytest.mark.parametrize("flags,row", [
    (["--num_devices", "2", "--use_occupancy"], "A8.4"),
    (["--num_devices", "4", "--preset", "tpu-fast"], "A8.4"),
    (["--compute_dtype", "float64"], "A7.4"),
    (["--dataset_type", "st3d", "--datadir", "data/mp3d/scene01", "--no_cv2"], "A6"),
])
def test_unported_flags_raise_naming_their_row(flags, row, monkeypatch):
    """What check_supported refused, by the ROADMAP row that was to port
    it: rows since ported (PORTED_ROWS) are taken now, several devices with
    global occupancy culling (A8.4, the tpu-fast preset's too) and an MLP
    type of float64 (A7.4, run in float32 as JAX runs it without x64);
    an mp3d st3d set's EXR depth where cv2 is not installed still raises
    (A6; "--no_cv2" stands for that here)."""
    from hashnerf_torch.data import st3d
    from hashnerf_torch.train.config import check_supported, parse_args

    base = ["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt")]
    check_supported(parse_args(base))
    if "--no_cv2" in flags:
        flags = [f for f in flags if f != "--no_cv2"]
        monkeypatch.setattr(st3d, "cv2_or_none", lambda: None)
    args = parse_args(base + flags)
    if row in PORTED_ROWS:
        check_supported(args)
        return
    with pytest.raises(NotImplementedError, match=row):
        check_supported(args)


@pytest.mark.parametrize("flags", [
    ["--dataset_type", "deepvoxels"],
    ["--i_embed", "0"],
    ["--dataset_type", "st3d"],
    ["--use_depth"],
    ["--i_embed_views", "0"],
    ["--dataset_type", "scannet"],
    ["--dataset_type", "LINEMOD"],
    ["--i_embed", "-1", "--i_embed_views", "-1", "--use_gradient"],
])
def test_slice9_flags_are_accepted(flags):
    """The NeRF family (A1/A2), the scannet, deepvoxels, LINEMOD and st3d
    loaders and st3d's depth and gradient supervision (A6) are ported:
    check_supported takes them."""
    from hashnerf_torch.train.config import check_supported, parse_args

    check_supported(parse_args(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt")]
                               + flags))


@pytest.mark.parametrize("flags", [
    ["--dataset_type", "blender"],
    ["--compute_dtype", "float16"],
    ["--fast_merge", "--compute_dtype", "float16"],
    ["--render_only"],
    ["--i_video", "20"],
])
def test_lifted_flags_are_accepted(flags):
    """The blender loader (A5), float16 MLPs (A7.4), --render_only and the
    i_video video (A3) are ported: check_supported takes them."""
    from hashnerf_torch.train.config import check_supported, parse_args

    check_supported(parse_args(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt")]
                               + flags))


@pytest.mark.parametrize("flags", [
    ["--preset", "tpu-fast"],
    ["--packed_layout", "--use_occupancy", "--steps_per_dispatch", "16"],
    ["--use_occupancy", "--preset", "tpu-fast"],
    ["--preset", "tpu-quality"],
    ["--steps_per_dispatch", "16"],
])
def test_steps_per_dispatch_and_presets_are_accepted(flags):
    """Flags the port refused before many steps a launch (ROADMAP A4) and
    the presets (A7.3) were ported: check_supported takes them, and
    parse_args splices a preset's flags before the config file's."""
    from hashnerf_torch.train.config import PRESETS, check_supported, parse_args

    args = parse_args(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt")] + flags)
    check_supported(args)
    assert args.steps_per_dispatch == 16
    if "--preset" in flags:
        preset = PRESETS[flags[flags.index("--preset") + 1]]
        assert args.n_levels == int(preset[preset.index("--n_levels") + 1])
        assert args.packed_layout and args.use_occupancy and args.compute_dtype == "bfloat16"
        assert args.N_rand == 256  # the config file's, over the parser default


def test_ray_batching_raises():
    """Ray batching is ported (A6): check_supported takes it, and st3d's
    pool with depth and gradient supervision (A6, slice 9) too, on several
    devices as well (A8, slice 10), with global occupancy culling too
    (A8.4, slice 11)."""
    from hashnerf_torch.train.config import check_supported, parse_args

    args = parse_args(["--dataset_type", "synthetic", "--i_video", "0"])
    assert not args.no_batching
    check_supported(args)
    check_supported(parse_args(["--dataset_type", "st3d", "--use_depth", "--use_gradient"]))
    check_supported(parse_args(["--dataset_type", "st3d", "--num_devices", "2"]))
    check_supported(parse_args(["--dataset_type", "st3d", "--num_devices", "2",
                                "--use_occupancy"]))


@pytest.mark.parametrize("flags", [
    [],
    ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout", "--share_fine",
     "--compute_dtype", "bfloat16", "--aabb_clip"],
    ["--preset", "tpu-fast", "--occ_per_ray"],
    ["--dataset_type", "st3d", "--use_depth", "--use_gradient"],
    ["--config", os.path.join(ROOT, "configs", "fern.txt")],
])
def test_num_devices_is_accepted(flags):
    """Several devices (A8, slice 10) on the chair step, the packed layout,
    the per-ray culled flagship and st3d's and llff's ray pools."""
    from hashnerf_torch.train.config import check_supported, parse_args

    check_supported(parse_args(["--config", os.path.join(ROOT, "configs", "chair.txt"),
                                "--num_devices", "2"] + flags))


def test_entry_points_need_a_gpu_unless_told_cpu():
    from hashnerf_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


def test_checkpoint_round_trip(tmp_path):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    scene = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    a = Trainer(_args(config_parser()), scene, device="cpu", seed=0)
    for step in range(7):  # past RAdam's warm-up, so the moments are live
        a.step(a.sample_image(0, 32, precrop=False))
    a.save(str(tmp_path / "000007.ckpt"))
    b = Trainer(_args(config_parser()), scene, device="cpu", seed=1)
    assert not torch.equal(a.state.hash_table, b.state.hash_table)
    assert b.try_restore(str(tmp_path))
    assert b.global_step == 7
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k
    # one more identical step from both: the optimizer state came back too
    sel = torch.arange(32)
    batch = a.sample_image(1, 32, precrop=False, sel=sel)
    assert all(torch.equal(batch[k], v) for k, v in b.sample_image(1, 32, False, sel=sel).items())
    a.generator.manual_seed(5)
    b.generator.manual_seed(5)
    a.step(batch)
    b.step(batch)
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k


def test_cli_trains_writes_and_restores_a_checkpoint(tmp_path):
    def run(n_iters):
        cmd = [sys.executable, "-m", "hashnerf_torch.run_nerf",
               "--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"),
               "--device", "cpu", "--N_iters", str(n_iters), "--i_weights", "10",
               "--i_print", "5", "--basedir", str(tmp_path)]
        env = dict(os.environ, OMP_NUM_THREADS="2")
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    out = run(10)
    (expdir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (expdir / "000010.ckpt").exists()
    assert (expdir / "args.txt").exists() and (expdir / "loss_vs_time.pkl").exists()
    assert "[TRAIN] Iter: 10 " in out
    out = run(15)
    assert f"Reloading from {expdir / '000010.ckpt'}" in out
    assert "[TRAIN] Iter: 15 " in out and "[TRAIN] Iter: 5 " not in out

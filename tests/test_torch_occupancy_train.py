"""The port's culled training against the JAX Trainer on the CPU: 8 steps of
the flagship flags (packed, shared fine net, aabb clip, global block-8
culling with a coarse budget, an annealed fine budget and adaptive grid
updates; float32, at a small size) from one converted state, with the same
batches, JAX's draws for each step and for each grid update. The losses,
the tables and the occupancy grids must agree. Also the flag handling, the
eval budgets, and a CPU run of the CLI with the flagship flags.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_torch_occupancy import jax_update_draws
from test_torch_packed import jax_packed_tv_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = ["--n_levels", "4", "--n_features_per_level", "8", "--compute_dtype", "bfloat16",
            "--packed_layout", "--share_fine", "--aabb_clip", "--use_occupancy",
            "--occ_keep_fraction", "0.125", "--occ_keep_coarse", "0.375",
            "--occ_keep_schedule", "0:0.5,512:0.25,1024:0.125", "--occ_block", "8",
            "--occ_adaptive_update"]

# tests/test_packed_train.py's geometry (level 0 dense, 1-3 block-hashed),
# the flagship's culling at a 32^3 grid: warmup 2 steps, an update every 2,
# the schedule cut to 8 steps; float32 so that 8 steps can be compared
SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                use_viewdirs=True, finest_res=32, n_levels=4, n_features_per_level=2,
                log2_hashmap_size=13, log2_blocks=10, packed_layout=True, share_fine=True,
                aabb_clip=True, white_bkgd=True, no_batching=True, perturb=1.0,
                use_occupancy=True, occ_resolution=32, occ_warmup=2, occ_update_every=2,
                occ_keep_fraction=0.125, occ_keep_coarse=0.375,
                occ_keep_schedule="0:0.5,4:0.25,6:0.125", occ_block=8, occ_adaptive_update=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _args(parser, **kw):
    args = parser.parse_args([])
    for k, v in {**SETTINGS, **kw}.items():
        setattr(args, k, v)
    return args


def test_culled_trainer_steps_match_jax():
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import TrainDraws, Trainer

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    jt = JTrainer(_args(jparser()), sj)
    # tables of U(-1, 1), not the 1e-4 init (see test_torch_train.py)
    jt.state = jt.state._replace(hash_table={k: v * 1e4 for k, v in jt.state.hash_table.items()})
    tt = Trainer(_args(config_parser()), make_synthetic_scene(H=24, W=24, n_train=3, n_test=1),
                 device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(tt.state, to_np(jt.state.hash_table), to_np(jt.state.coarse), None)
    assert tt.keep_schedule == jt.keep_schedule
    for s in (0, 3, 4, 5, 6, 100):
        assert tt._keep_at(s) == jt._keep_at(s)

    occ = jt.render_cfg.occupancy
    R, S, Si = SETTINGS["N_rand"], SETTINGS["N_samples"], SETTINGS["N_importance"]
    rng = np.random.default_rng(1)  # the batches of test_torch_packed_train.py
    keeps = []
    for step in range(8):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, sj.K, sj.poses[img])
        b = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
             "target": sj.images[img][ys, xs], "near": np.full(R, 2.0, np.float32),
             "far": np.full(R, 6.0, np.float32)}
        # the draws the JAX step and the grid update after it take
        key, k = jax.random.split(jt.key)
        k_render, k_tv = jax.random.split(k)
        k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
        corners, rows = jax_packed_tv_draws(k_tv, jt.model_cfg.packed_grid)
        draws = TrainDraws(
            render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, S))),
                               u_pdf=_t(jax.random.uniform(k_pdf, (R, Si)))),
            tv_min_vertices=_t(corners), tv_fine_rows=_t(rows),
        )
        occ_draws = None
        if (jt.global_step + 1) % occ.update_every == 0:
            occ_draws = jax_update_draws(np.asarray(jt.occ_grid), jax.random.split(key)[1], occ)
        culled = jt.global_step >= occ.warmup_steps and jt._occ_ready
        with jax.disable_jit():  # op by op, as the port runs
            mj = jt.step({k_: jnp.asarray(v) for k_, v in b.items()})
        mt = tt.step({k_: _t(v) for k_, v in b.items()}, draws=draws, occ_draws=occ_draws)
        keeps.append(tt.last_occ_keep)
        assert (tt.last_occ_keep is not None) == culled, step
        # float32 sums in other orders: 1e-4, as test_torch_packed_train.py
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {step + 1}")
        np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]), rtol=1e-4,
                                   err_msg=f"psnr, step {step + 1}")
        np.testing.assert_allclose(tt.occ_grid.numpy(), np.asarray(jt.occ_grid), rtol=1e-4, atol=1e-6,
                                   err_msg=f"grid, step {step + 1}")
    # steps 1-2 warm up; 3-8 culled at the annealed fine budget, coarse 0.375
    assert keeps == [None, None, (0.5, 0.375), (0.5, 0.375), (0.25, 0.375), (0.25, 0.375),
                     (0.125, 0.375), (0.125, 0.375)]
    assert tt._occ_ready and jt._occ_ready and tt.global_step == jt.global_step == 8
    assert float(tt.occ_grid.max()) > 0 and int((tt.occ_grid > 0).sum()) > 1000
    for k in ("dense", "fine"):
        np.testing.assert_allclose(tt.state.hash_table[k].detach().numpy(),
                                   np.asarray(jt.state.hash_table[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for name in ("sigma_net", "color_net"):
        for layer, jl in zip(getattr(tt.state.coarse, name), jt.state.coarse[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------- #
# Flags
# --------------------------------------------------------------------------- #

def _parse(*flags):
    from hashnerf_torch.train.config import parse_args

    return parse_args(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"), *flags])


def test_flagship_flags_are_accepted():
    from hashnerf_torch.train.config import check_supported
    from hashnerf_torch.train.driver import render_config_from_args

    args = _parse(*FLAGSHIP, "--fast_merge", "--occ_per_ray")
    check_supported(args)
    occ = render_config_from_args(args).occupancy
    assert (occ.keep_fraction, occ.keep_fraction_coarse, occ.block, occ.adaptive_update) == (
        0.125, 0.375, 8, True)


@pytest.mark.parametrize("flags", [["--preset", "tpu-fast"], ["--steps_per_dispatch", "16"]])
def test_flagship_with_preset_or_blocks_is_accepted(flags):
    """The preset and --steps_per_dispatch (ROADMAP A7.3, A4) on top of the
    flagship flags: accepted, the same culling, 16 steps a launch."""
    from hashnerf_torch.train.config import check_supported
    from hashnerf_torch.train.driver import render_config_from_args

    args = _parse(*FLAGSHIP, *flags)
    check_supported(args)
    assert args.steps_per_dispatch == 16
    occ = render_config_from_args(args).occupancy
    assert (occ.keep_fraction, occ.keep_fraction_coarse, occ.block, occ.adaptive_update) == (
        0.125, 0.375, 8, True)


@pytest.mark.parametrize("flags,match", [
    (["--occ_block", "16"], "must divide"),  # 24 samples in the fine pass
    (["--occ_score_stride", "3"], "two cells apart"),
])
def test_bad_occupancy_flags_raise(flags, match):
    from hashnerf_torch.train.driver import render_config_from_args

    with pytest.raises(ValueError, match=match):
        render_config_from_args(_parse("--use_occupancy", *flags))


def test_fast_merge_note_says_where_it_applies(capsys):
    from hashnerf_torch.train.driver import render_config_from_args

    cfg = render_config_from_args(_parse("--use_occupancy", "--fast_merge"))
    assert cfg.fast_merge  # still on for the passes without a grid
    out = capsys.readouterr().out
    assert "applies only to renders without an active occupancy grid" in out
    assert "ignoring" not in out


def _trainer(*flags):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.driver import Trainer

    return Trainer(_parse(*flags), make_synthetic_scene(H=16, W=16, n_train=2, n_test=1), device="cpu")


def test_eval_is_exact_unless_asked():
    """The eval grid: none before the grid is ready; none after unless
    --occ_keep_eval or eval_cull; the eval budgets replace the training
    ones and turn the transmittance cull on."""
    t = _trainer("--use_occupancy")
    assert t.eval_occ_grid is None
    t._occ_ready = True
    assert t.eval_occ_grid is None
    t.eval_cull = True
    assert t.eval_occ_grid is t.occ_grid
    t = _trainer("--use_occupancy", "--occ_keep_eval", "0.75", "--occ_eval_transmittance")
    t._occ_ready = True
    assert t.eval_occ_grid is t.occ_grid
    occ = t.render_cfg.eval_mode().occupancy
    assert (occ.keep_fraction, occ.keep_fraction_coarse, occ.transmittance_cull) == (0.75, None, True)
    assert not t.render_cfg.eval_mode().perturb


def test_warmup_renders_take_fast_merge():
    """No grid is passed before warmup and readiness, so a fast_merge run
    merges by rank then, as the JAX Trainer does; its draw is the sorted
    uniform."""
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws

    t = _trainer("--use_occupancy", "--fast_merge", "--occ_warmup", "4", "--occ_update_every", "2",
                 "--N_rand", "16")
    batch = t.sample_image(0, 16, precrop=False)
    # unsorted u_pdf would break the rank merge: the sorted draw is used
    u_bad = torch.rand(16, 8).flip(-1)
    t.step(batch, draws=TrainDraws(render=RenderDraws(u_pdf=u_bad)))
    assert t.last_occ_keep is None
    for _ in range(3):
        t.step(batch)
    assert t._occ_ready and t.last_occ_keep is None  # steps 1-4 warm up
    t.step(batch)
    assert t.last_occ_keep == (0.5, 0.5)


def test_flagship_cli_trains_culls_and_writes_a_checkpoint(tmp_path, capsys):
    from hashnerf_torch.run_nerf import main

    trainer = main(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"), *FLAGSHIP,
                    "--occ_warmup", "4", "--occ_update_every", "2", "--device", "cpu", "--no_reload",
                    "--N_iters", "12", "--i_weights", "12", "--i_print", "6", "--basedir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[TRAIN] Iter: 12 " in out
    (expdir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (expdir / "000012.ckpt").exists()
    assert trainer._occ_ready and float(trainer.occ_grid.max()) > 0
    assert trainer.last_occ_keep == (0.5, 0.375)  # step 12 culled: schedule 0:0.5, coarse 0.375

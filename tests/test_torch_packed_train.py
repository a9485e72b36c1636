"""The port's packed training step against the JAX Trainer on the CPU: 8
steps with --packed_layout --share_fine --aabb_clip in float32 from one
converted state with the same batches and JAX's draws, one bf16 step, the
packed checkpoint, load_jax_state of a packed JAX state, and a CPU run of
the CLI with the packed flags."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_torch_packed import jax_packed_tv_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_packed_train.py's geometry: level 0 dense, levels 1-3 block-hashed
SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                use_viewdirs=True, finest_res=32, n_levels=4, n_features_per_level=2,
                log2_hashmap_size=13, log2_blocks=10, packed_layout=True, share_fine=True,
                aabb_clip=True, white_bkgd=True, no_batching=True, perturb=1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _args(parser, **kw):
    args = parser.parse_args([])
    for k, v in {**SETTINGS, **kw}.items():
        setattr(args, k, v)
    return args


def _pair(**kw):
    """(JAX Trainer, port Trainer) from one state: the JAX init with both
    tables scaled by 1e4 to U(-1, 1) (see test_torch_train.py on why)."""
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    st = make_synthetic_scene(H=24, W=24, n_train=3, n_test=1)
    jt = JTrainer(_args(jparser(), **kw), sj)
    assert jt.state.fine is None and set(jt.state.hash_table) == {"dense", "fine"}
    jt.state = jt.state._replace(
        hash_table={k: v * 1e4 for k, v in jt.state.hash_table.items()})
    tt = Trainer(_args(config_parser(), **kw), st, device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(tt.state, to_np(jt.state.hash_table), to_np(jt.state.coarse), None)
    return sj, jt, tt


def _steps(sj, jt, tt, n):
    """n steps of both trainers on the same batches, the port given the
    draws the JAX step takes from its key; yields (JAX metrics, port metrics)."""
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws

    R, S, Si = SETTINGS["N_rand"], SETTINGS["N_samples"], SETTINGS["N_importance"]
    # Batches of seed 1. Those of seed 0 give a few table entries whose
    # render and TV gradients nearly cancel: the MLPs' float32 summation
    # order is then a large part of what remains, RAdam (eps 1e-15) makes
    # it a step of full size, and after 8 steps those entries lie outside
    # rtol 1e-4 / atol 1e-6. The jitted JAX step parts from the eager one
    # on such entries too (ROADMAP C).
    rng = np.random.default_rng(1)
    for _ in range(n):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, sj.K, sj.poses[img])
        b = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
             "target": sj.images[img][ys, xs], "near": np.full(R, 2.0, np.float32),
             "far": np.full(R, 6.0, np.float32)}
        _, k = jax.random.split(jt.key)
        k_render, k_tv = jax.random.split(k)
        k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
        corners, rows = jax_packed_tv_draws(k_tv, jt.model_cfg.packed_grid)
        draws = TrainDraws(
            render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, S))),
                               u_pdf=_t(jax.random.uniform(k_pdf, (R, Si)))),
            tv_min_vertices=_t(corners), tv_fine_rows=_t(rows),
        )
        # op by op, as the port runs (see test_torch_train.py)
        with jax.disable_jit():
            mj = jt.step({k_: jnp.asarray(v) for k_, v in b.items()})
        mt = tt.step({k_: _t(v) for k_, v in b.items()}, draws=draws)
        yield mj, mt


def test_packed_trainer_steps_match_jax():
    sj, jt, tt = _pair()
    init = {k: v.detach().clone() for k, v in tt.state.hash_table.items()}
    for step, (mj, mt) in enumerate(_steps(sj, jt, tt, 8)):
        # float32 sums in other orders: 1e-4
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {step + 1}")
        np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]), rtol=1e-4,
                                   err_msg=f"psnr, step {step + 1}")
    assert tt.global_step == jt.global_step == 8
    assert tt.state.fine is None
    for k in ("dense", "fine"):
        got, want = tt.state.hash_table[k].detach().numpy(), np.asarray(jt.state.hash_table[k])
        assert not np.array_equal(got, init[k].numpy())  # the table moved
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=k)
    for name in ("sigma_net", "color_net"):
        for layer, jl in zip(getattr(tt.state.coarse, name), jt.state.coarse[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_packed_bf16_step_loss_matches_jax():
    sj, jt, tt = _pair(compute_dtype="bfloat16")
    ((mj, mt),) = list(_steps(sj, jt, tt, 1))
    # bf16 products summed in other orders
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-3)


# --------------------------------------------------------------------------- #
# Checkpoints and conversion
# --------------------------------------------------------------------------- #

def _trainer(seed, **kw):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    scene = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    return Trainer(_args(config_parser(), **kw), scene, device="cpu", seed=seed)


def test_packed_checkpoint_round_trip(tmp_path):
    a = _trainer(0)
    for _ in range(7):  # past RAdam's warm-up, so the moments are live
        a.step(a.sample_image(0, 32, precrop=False))
    a.save(str(tmp_path / "000007.ckpt"))
    b = _trainer(1)
    assert not torch.equal(a.state.hash_table["fine"], b.state.hash_table["fine"])
    assert b.try_restore(str(tmp_path))
    assert b.global_step == 7
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert set(sa) == set(sb) and {"hash_table.dense", "hash_table.fine"} <= set(sa)
    assert not any(k.startswith("fine.") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    sel = torch.arange(32)
    batch = a.sample_image(1, 32, precrop=False, sel=sel)
    a.generator.manual_seed(5)
    b.generator.manual_seed(5)
    a.step(batch)
    b.step(batch)
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("saved_packed", [True, False])
def test_checkpoint_of_the_other_layout_raises(tmp_path, saved_packed):
    a = _trainer(0, packed_layout=saved_packed, share_fine=saved_packed)
    a.save(str(tmp_path / "000001.ckpt"))
    b = _trainer(1, packed_layout=not saved_packed, share_fine=not saved_packed)
    before = {k: v.clone() for k, v in b.state.state_dict().items()}
    with pytest.raises(ValueError, match=r"packed \(\{dense, fine\} tables\).*hash \(per-corner"
                       if saved_packed else r"hash \(per-corner.*packed \(\{dense, fine\}"):
        b.try_restore(str(tmp_path))
    # nothing was loaded
    assert b.global_step == 0
    for k, v in b.state.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_load_jax_state_of_a_packed_state():
    from hashnerf_tpu.models.factory import ModelConfig as JModelConfig, create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JHash
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13, finest_resolution=32)
    for share in (True, False):
        common = dict(N_importance=8, share_fine=share, packed_layout=True, log2_blocks=10)
        js, _ = create_model(jax.random.PRNGKey(3), JModelConfig(hash_grid=JHash(**kw), **common))
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        state = NGPState(ModelConfig(hash_grid=HashGridConfig(**kw), **common), device="cpu")
        load_jax_state(state, to_np(js.hash_table), to_np(js.coarse),
                       None if js.fine is None else to_np(js.fine))
        assert (state.fine is None) == share == (js.fine is None)
        for k in ("dense", "fine"):
            np.testing.assert_array_equal(state.hash_table[k].detach().numpy(), np.asarray(js.hash_table[k]))
        nets = [("coarse", js.coarse)] + ([] if share else [("fine", js.fine)])
        for which, jnet in nets:
            for layer, jl in zip(getattr(state, which).color_net, jnet["color_net"]):
                np.testing.assert_array_equal(layer.weight.detach().numpy(), np.asarray(jl["w"]).T)

    # a per-corner JAX table into a packed state, and a fine net where there is none
    js, _ = create_model(jax.random.PRNGKey(3), JModelConfig(hash_grid=JHash(**kw), N_importance=8))
    state = NGPState(ModelConfig(hash_grid=HashGridConfig(**kw), N_importance=8, share_fine=True,
                                 packed_layout=True, log2_blocks=10), device="cpu")
    with pytest.raises(ValueError, match="packed layout"):
        load_jax_state(state, np.asarray(js.hash_table), to_np(js.coarse), None)
    with pytest.raises(ValueError, match="fine network"):
        load_jax_state(state, to_np(js.hash_table), to_np(js.coarse), to_np(js.fine))


def test_packed_cli_trains_and_writes_a_checkpoint(tmp_path):
    cmd = [sys.executable, "-m", "hashnerf_torch.run_nerf",
           "--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"),
           "--n_levels", "4", "--n_features_per_level", "8", "--packed_layout", "--share_fine",
           "--compute_dtype", "bfloat16", "--aabb_clip", "--device", "cpu", "--no_reload",
           "--N_iters", "10", "--i_weights", "10", "--i_print", "5", "--basedir", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    (expdir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (expdir / "000010.ckpt").exists()
    assert "[TRAIN] Iter: 10 " in r.stdout

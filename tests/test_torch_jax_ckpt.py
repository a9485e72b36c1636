"""The JAX package's checkpoints in the port (train/checkpoint.py
`load_jax_checkpoint`, utils/msgpack.py): the committed fixture renders its
view as the JAX package did; a checkpoint of 8 JAX steps renders as JAX
renders it and trains on for 4 steps as JAX does; a checkpoint of another
layout raises before anything is loaded; the two formats are told apart by
content. The packed layout is in test_torch_jax_ckpt_packed.py."""
import os
import pickle
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "golden", "jax_smoke_ckpt")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the fixture view's tolerance)

# test_torch_train.py's settings
SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                use_viewdirs=True, finest_res=64, log2_hashmap_size=10, white_bkgd=True,
                no_batching=True, perturb=1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _args(parser, **kw):
    args = parser.parse_args([])
    for k, v in {**SETTINGS, **kw}.items():
        setattr(args, k, v)
    return args


def _fixture_trainer(*flags):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    view = np.load(os.path.join(FIXTURE, "view.npz"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the flags name configs/ relative to the root
    try:
        args = parse_args(list(view["flags"]) + ["--device", "cpu", *flags])
    finally:
        os.chdir(cwd)
    return Trainer(args, make_synthetic_scene(), device="cpu", seed=1), view


def test_fixture_renders_as_jax():
    tt, view = _fixture_trainer()
    assert tt.try_restore(FIXTURE)
    assert tt.global_step == 8
    assert {float(st["step"]) for st in tt.optimizer.state.values()} == {8.0}
    rgb, depth, _, _ = tt.render_image(view["c2w"])
    assert rgb.shape == view["rgb"].shape
    ok, err = chip_smoke.jax_view_close(rgb.numpy(), view["rgb"])
    assert ok, err
    assert float(np.std(view["rgb"])) > 0.05  # the view has structure


def test_view_tolerance_admits_last_bits_and_refuses_a_fresh_state():
    """jax_view_close's calibration: weights moved by 3e-7 of themselves
    move single pixels of the fixture's view past the fine pass's
    element-wise tolerance (the inverse CDF places the fine samples) while
    the mean barely moves, and stay within the tolerance; an untrained
    state does not."""
    tt, view = _fixture_trainer()
    assert tt.try_restore(FIXTURE)
    base = tt.render_image(view["c2w"])[0].numpy()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tt.state.parameters():
            p.mul_(1 + 3e-7 * torch.randn(p.shape, generator=g))
    moved = tt.render_image(view["c2w"])[0].numpy()
    d = np.abs(moved - base)
    assert d.max() > 1e-4 and d.mean() < 1e-6, (d.max(), d.mean())
    assert chip_smoke.jax_view_close(moved, view["rgb"])[0]
    fresh, _ = _fixture_trainer()
    ok, err = chip_smoke.jax_view_close(fresh.render_image(view["c2w"])[0].numpy(), view["rgb"])
    assert not ok and err["mean_abs_err"] > 100 * chip_smoke.JAX_VIEW_MEAN_TOL, err


def _jax_draws(jt, R):
    """The draws the next JAX step takes from its key (test_torch_train.py)."""
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws
    from hashnerf_torch.train.losses import tv_level_geometry

    L = 16
    _, k = jax.random.split(jt.key)
    k_render, k_tv = jax.random.split(k)
    k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
    tv_keys = jax.random.split(k_tv, L)
    mv = np.stack([np.asarray(jax.random.randint(tv_keys[l], (3,), 0, r - c))
                   for l, (r, c) in enumerate(tv_level_geometry(16, 64, l, L) for l in range(L))])
    return TrainDraws(render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, 8))),
                                         u_pdf=_t(jax.random.uniform(k_pdf, (R, 8)))),
                      tv_min_vertices=_t(mv))


def _batches(sj, n, seed):
    from hashnerf_tpu.ops.rays import get_rays_np

    R = SETTINGS["N_rand"]
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, sj.K, sj.poses[img])
        yield {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
               "target": sj.images[img][ys, xs], "near": np.full(R, 2.0, np.float32),
               "far": np.full(R, 6.0, np.float32)}


def test_jax_checkpoint_renders_and_trains_on(tmp_path):
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    jt = JTrainer(_args(jparser()), sj)
    # U(-1, 1) tables (test_torch_train.py says why)
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    batches = list(_batches(sj, 12, seed=0))
    # op by op, as the port runs (test_torch_train.py)
    with jax.disable_jit():
        for b in batches[:8]:
            jt.step({k: jnp.asarray(v) for k, v in b.items()})
    jt.save(str(tmp_path / "000008.ckpt"))

    tt = Trainer(_args(config_parser()), make_synthetic_scene(H=24, W=24, n_train=3, n_test=1),
                 device="cpu", seed=1)
    assert tt.try_restore(str(tmp_path))
    assert tt.global_step == jt.global_step == 8
    # parameters and RAdam's state, leaf by leaf
    np.testing.assert_array_equal(tt.state.hash_table.detach().numpy(), np.asarray(jt.state.hash_table))
    jopt = jt.opt_state.inner_states
    st = tt.optimizer.state[tt.state.hash_table]
    np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(jopt["embed"].inner_state.mu.hash_table))
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(jopt["embed"].inner_state.nu.hash_table))
    assert float(st["step"]) == int(jopt["embed"].inner_state.step) == 8
    for which in ("coarse", "fine"):
        for name in ("sigma_net", "color_net"):
            for i, layer in enumerate(getattr(getattr(tt.state, which), name)):
                st = tt.optimizer.state[layer.weight]
                net = jopt["net"].inner_state
                np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                              np.asarray(getattr(jt.state, which)[name][i]["w"]).T)
                np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                              np.asarray(getattr(net.mu, which)[name][i]["w"]).T)
                np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                              np.asarray(getattr(net.nu, which)[name][i]["w"]).T)
                assert float(st["step"]) == 8.0

    # the same render, held as chip_smoke.py holds the JAX fixture's view
    c2w = sj.poses[sj.i_test[0]]
    with jax.disable_jit():
        rgb_j, _, _, _ = jt.render_image(c2w)
    rgb, _, _, _ = tt.render_image(c2w)
    ok, err = chip_smoke.jax_view_close(rgb.numpy(), np.asarray(rgb_j))
    assert ok, err

    # 4 more steps on each side, from the checkpoint's moments
    for b in batches[8:]:
        draws = _jax_draws(jt, SETTINGS["N_rand"])
        with jax.disable_jit():
            mj = jt.step({k: jnp.asarray(v) for k, v in b.items()})
        mt = tt.step({k: _t(v) for k, v in b.items()}, draws=draws)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
    assert tt.global_step == jt.global_step == 12
    np.testing.assert_allclose(tt.state.hash_table.detach().numpy(), np.asarray(jt.state.hash_table),
                               rtol=1e-4, atol=1e-6)
    for which in ("coarse", "fine"):
        for name in ("sigma_net", "color_net"):
            for layer, jl in zip(getattr(getattr(tt.state, which), name), getattr(jt.state, which)[name]):
                np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                           rtol=1e-4, atol=1e-6, err_msg=f"{which}.{name}")


@pytest.mark.parametrize("flags,what", [
    (["--packed_layout", "--n_levels", "4", "--n_features_per_level", "8"], "packed layout"),
    (["--log2_hashmap_size", "12"], "hash_table"),
    (["--share_fine"], "fine network"),
    (["--n_features_per_level", "4", "--n_levels", "8"], "hash_table"),
])
def test_layout_mismatch_raises_before_loading(flags, what):
    from hashnerf_torch.train.checkpoint import load_jax_checkpoint

    tt, _ = _fixture_trainer(*flags)
    before = {k: v.clone() for k, v in tt.state.state_dict().items()}
    with pytest.raises(ValueError, match=what):
        load_jax_checkpoint(os.path.join(FIXTURE, "000008.ckpt"), tt.state, tt.optimizer)
    assert not tt.optimizer.state
    for k, v in tt.state.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_formats_are_told_apart_by_content(tmp_path):
    from hashnerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    tt, view = _fixture_trainer()
    # a port checkpoint at step 9 named as the JAX one would be, a JAX one at 8
    shutil.copy(os.path.join(FIXTURE, "000008.ckpt"), tmp_path / "000008.ckpt")
    tt.global_step = 9
    tt.save(str(tmp_path / "000009.ckpt"))
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "000009.ckpt")
    other, _ = _fixture_trainer()
    assert load_checkpoint(str(tmp_path / "000009.ckpt"), other.state, other.optimizer) == 9
    assert load_checkpoint(str(tmp_path / "000008.ckpt"), other.state, other.optimizer) == 8
    # neither format
    (tmp_path / "bad.ckpt").write_bytes(b"not a checkpoint")
    with open(tmp_path / "np.ckpt", "wb") as f:  # a pickle that names a class
        pickle.dump({"state": np.zeros(3)}, f)
    for name in ("bad.ckpt", "np.ckpt"):
        with pytest.raises(ValueError, match="neither a port nor a JAX checkpoint"):
            load_checkpoint(str(tmp_path / name), other.state, other.optimizer)

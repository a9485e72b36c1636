"""A checkpoint of the JAX package's packed layout (--packed_layout
--share_fine, {dense, fine} tables, no fine net) in the port: after 8 JAX
steps it is restored leaf for leaf, renders a view's rays as JAX renders
them and trains on for 4 steps as JAX does (test_torch_jax_ckpt.py has the
per-corner layout)."""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(2)

from test_torch_packed import jax_packed_tv_draws
from test_torch_packed_train import SETTINGS, _args

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the JAX fixture view's tolerance)


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _draws(jt):
    """The draws the next JAX step takes from its key."""
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws

    R, S, Si = SETTINGS["N_rand"], SETTINGS["N_samples"], SETTINGS["N_importance"]
    _, k = jax.random.split(jt.key)
    k_render, k_tv = jax.random.split(k)
    k_strat, _, k_pdf, _ = jax.random.split(k_render, 4)
    corners, rows = jax_packed_tv_draws(k_tv, jt.model_cfg.packed_grid)
    return TrainDraws(
        render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, S))),
                           u_pdf=_t(jax.random.uniform(k_pdf, (R, Si)))),
        tv_min_vertices=_t(corners), tv_fine_rows=_t(rows),
    )


def _outside(tt, jt, k):
    got, want = tt.state.hash_table[k].detach().numpy(), np.asarray(jt.state.hash_table[k])
    return int((~np.isclose(got, want, rtol=1e-4, atol=1e-6)).sum())


def test_packed_jax_checkpoint_renders_and_trains_on(tmp_path):
    """JAX takes 12 steps, saving a checkpoint after 8. The port trains
    beside it twice, on the same batches and JAX's draws: once from the
    converted init for all 12 steps, once from the checkpoint for the last
    4. Each of RAdam's normalised steps can turn a last-bit difference of a
    gradient that nearly cancels into a step of up to lr (ROADMAP C): the
    port that never saw a checkpoint already leaves a few fine entries
    outside rtol 1e-4 / atol 1e-6 after 12 steps. So the resumed port may
    leave as many outside, and no more."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer
    from test_torch_packed_train import _pair

    sj, jt, whole = _pair()  # tables already scaled to U(-1, 1)
    assert jt.state.fine is None and set(jt.state.hash_table) == {"dense", "fine"}
    resumed = None
    # batches of seed 1 (test_torch_packed_train.py says why)
    for i, b in enumerate(_batches(sj, 12, seed=1)):
        draws = _draws(jt)
        with jax.disable_jit():
            mj = jt.step({k: jnp.asarray(v) for k, v in b.items()})
        for tt in (whole, resumed):
            if tt is not None:
                mt = tt.step({k: _t(v) for k, v in b.items()}, draws=draws)
                np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
        if i == 7:
            jt.save(str(tmp_path / "000008.ckpt"))
            resumed = Trainer(_args(config_parser()),
                              make_synthetic_scene(H=24, W=24, n_train=3, n_test=1),
                              device="cpu", seed=1)
            _check_restored(tmp_path, jt, resumed)
            _check_render(sj, jt, resumed)
    assert resumed.global_step == jt.global_step == whole.global_step == 12
    for k in ("dense", "fine"):
        assert _outside(resumed, jt, k) <= _outside(whole, jt, k), k
    for name in ("sigma_net", "color_net"):
        for layer, jl in zip(getattr(resumed.state.coarse, name), jt.state.coarse[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def _check_restored(tmp_path, jt, tt):
    """The port restores the JAX checkpoint leaf for leaf."""
    assert tt.try_restore(str(tmp_path))
    assert tt.global_step == 8 and tt.state.fine is None
    jopt = jt.opt_state.inner_states
    for k in ("dense", "fine"):
        p = tt.state.hash_table[k]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jt.state.hash_table[k]))
        st = tt.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(jopt["embed"].inner_state.mu.hash_table[k]))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(jopt["embed"].inner_state.nu.hash_table[k]))
        assert float(st["step"]) == 8.0
    for name in ("sigma_net", "color_net"):
        for i, layer in enumerate(getattr(tt.state.coarse, name)):
            st = tt.optimizer.state[layer.weight]
            np.testing.assert_array_equal(
                st["exp_avg"].numpy(), np.asarray(jopt["net"].inner_state.mu.coarse[name][i]["w"]).T)
            assert float(st["step"]) == 8.0


def _check_render(sj, jt, tt):
    """The test view, its rays given to both renderers. The packed fine
    levels store each block's 27 vertices apart, so the field jumps at
    block faces, and at U(-1, 1) tables a ray whose direction moves by one
    ulp (get_rays' einsum against the port's product and sum) can cross a
    face and change its pixel far past any tolerance; the jitted JAX render
    parts from the eager one the same way. The rgb is held as
    chip_smoke.py holds the JAX fixture's view."""
    from hashnerf_tpu.ops.rays import get_rays
    from hashnerf_tpu.render.renderer import render_rays as jrender_rays
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import render_rays

    with jax.disable_jit():
        rays_o, rays_d = get_rays(24, 24, sj.K, jnp.asarray(sj.poses[sj.i_test[0]][:3, :4]))
        rays_o, rays_d = np.asarray(rays_o).reshape(-1, 3), np.asarray(rays_d).reshape(-1, 3)
        viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        want = jrender_rays(jt.state, jt.query_fn, jnp.asarray(rays_o), jnp.asarray(rays_d),
                            jnp.asarray(viewdirs), 2.0, 6.0, jt.bbox, None, jt.render_cfg.eval_mode())
    with torch.no_grad():
        n = rays_o.shape[0]
        got = render_rays(tt.state, query_fn, _t(rays_o), _t(rays_d), _t(viewdirs),
                          torch.full((n,), 2.0), torch.full((n,), 6.0), tt.bbox,
                          tt.render_cfg.eval_mode())
    ok, err = chip_smoke.jax_view_close(got["rgb_map"].numpy(), np.asarray(want["rgb_map"]))
    assert ok, err

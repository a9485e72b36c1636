"""NDC training and rendering in the port against the JAX package on the CPU,
on tests/test_ndc_train.py's forward-facing scene: 8 NDC trainer steps from
one converted state with the same batches and JAX's draws (the eager JAX
step), a full NDC view rendered from one state, train_loop with ray
batching (per step and in pool blocks) whose loss falls, configs/fern.txt
through the CLI on a small LLFF set (figures, PSNR pickle, spiral video,
checkpoint, --render_only), and the flags check_supported now takes."""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_ndc_train import _forward_facing_scene
from test_torch_llff import write_llff_set
from test_torch_render import g, jax_setup, port_state  # noqa: F401 (fixtures)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FERN = os.path.join(ROOT, "configs", "fern.txt")


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_scene(js):
    from hashnerf_torch.data.scene import Scene

    return Scene(**{f.name: getattr(js, f.name) for f in dataclasses.fields(Scene)})


SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                use_viewdirs=True, finest_res=64, log2_hashmap_size=10, raw_noise_std=1.0,
                perturb=1.0)


def _pair(settings=SETTINGS, H=24, W=24):
    """A JAX and a port Trainer on one forward-facing scene, the port's state
    copied from JAX's, whose table is scaled to U(-1, 1) (see
    tests/test_torch_train.py::test_trainer_steps_match_jax)."""
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    def args(parser):
        a = parser.parse_args([])
        for k, v in settings.items():
            setattr(a, k, v)
        return a

    js = _forward_facing_scene(H=H, W=W, n_train=3, n_test=1)
    jt = JTrainer(args(jparser()), js)
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    tt = Trainer(args(config_parser()), _port_scene(js), device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(tt.state, np.asarray(jt.state.hash_table), to_np(jt.state.coarse),
                   to_np(jt.state.fine))
    assert jt.render_cfg.ndc and tt.render_cfg.ndc and not tt.render_cfg.aabb_clip
    return js, jt, tt


def test_ndc_trainer_steps_match_jax():
    """NDC steps from one state with the same rays and draws: the port warps
    its rays in the loss and takes viewdirs from the world directions, as
    JAX does; the loss each step, and tables and MLPs after RAdam moved
    (step 6 on), at the standing rtol 1e-4 / atol 1e-6."""
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws
    from hashnerf_torch.train.losses import tv_level_geometry

    js, jt, tt = _pair()
    L, R, S = 16, SETTINGS["N_rand"], SETTINGS["N_samples"]
    rng = np.random.default_rng(0)
    for step in range(8):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, js.K, js.poses[img])
        b = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
             "target": js.images[img][ys, xs], "near": np.zeros(R, np.float32),
             "far": np.ones(R, np.float32)}
        _, k = jax.random.split(jt.key)
        k_render, k_tv = jax.random.split(k)
        k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(k_render, 4)
        tv_keys = jax.random.split(k_tv, L)
        mv = np.stack([
            np.asarray(jax.random.randint(tv_keys[l], (3,), 0, r - c))
            for l, (r, c) in enumerate(tv_level_geometry(16, 64, l, L) for l in range(L))
        ])
        draws = TrainDraws(
            render=RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, S))),
                               noise0=_t(jax.random.normal(k_noise0, (R, S))),
                               u_pdf=_t(jax.random.uniform(k_pdf, (R, S))),
                               noise1=_t(jax.random.normal(k_noise1, (R, 2 * S)))),
            tv_min_vertices=_t(mv),
        )
        with jax.disable_jit():
            mj = jt.step({k_: jnp.asarray(v) for k_, v in b.items()})
        mt = tt.step({k_: _t(v) for k_, v in b.items()}, draws=draws)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {step + 1}")
    np.testing.assert_allclose(tt.state.hash_table.detach().numpy(), np.asarray(jt.state.hash_table),
                               rtol=1e-4, atol=1e-6)
    for which in ("coarse", "fine"):
        net, jnet = getattr(tt.state, which), getattr(jt.state, which)
        for name in ("sigma_net", "color_net"):
            for layer, jl in zip(getattr(net, name), jnet[name]):
                np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(jl["w"]).T,
                                           rtol=1e-4, atol=1e-6, err_msg=f"{which}.{name}")


def test_ndc_view_matches_jax(port_state, jax_setup):
    """A whole 20 x 24 view of the forward-facing scene rendered with ndc
    from the reference goldens' state (tests/test_torch_render.py's
    fixtures): rays warped to NDC after their view directions, near 0 /
    far 1, the NDC bbox of get_bbox3d_for_llff. The coarse pass at rtol
    1e-5 / atol 1e-6, the fine pass's colour and opacity at 1e-4 / 5e-5
    (ROADMAP C)."""
    from hashnerf_tpu.render.renderer import RenderConfig as JRC, render as jrender
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.ops.bbox import get_bbox3d_for_llff
    from hashnerf_torch.render.renderer import RenderConfig, render

    jstate, jquery = jax_setup
    js = _forward_facing_scene(H=20, W=24, n_train=3, n_test=1)
    bbox = np.stack(get_bbox3d_for_llff(js.poses, js.hwf))
    c2w = js.poses[js.i_test[0]]
    kw = dict(N_samples=32, N_importance=32, perturb=False, ndc=True, use_viewdirs=True)
    rgb_j, depth_j, acc_j, ex_j = jrender(jstate, jquery, 20, 24, js.K, jnp.asarray(bbox), JRC(**kw),
                                          chunk=256, c2w=jnp.asarray(c2w), near=0.0, far=1.0)
    rgb, depth, acc, ex = render(port_state, query_fn, 20, 24, js.K, _t(bbox), RenderConfig(**kw),
                                 chunk=256, c2w=_t(c2w), near=0.0, far=1.0)
    assert rgb.shape == (20, 24, 3) and float(acc.max()) > 0.1
    np.testing.assert_allclose(ex["rgb0"].numpy(), np.asarray(ex_j["rgb0"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ex["acc0"].numpy(), np.asarray(ex_j["acc0"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-4, atol=5e-5)
    # The depth of this view moves with the fine samples' placement: on the
    # CPU, JAX's own jitted and eager renders of it differ by up to 2.25e-3 (3.9e-5 on
    # average), the port from the jitted one by 1.98e-3 (6.4e-5). So depth
    # is held as whole views are (ROADMAP C): its mean and largest error.
    err = np.abs(depth.numpy() - np.asarray(depth_j))
    assert err.mean() <= 2e-4 and err.max() <= 5e-3, (err.mean(), err.max())


@pytest.mark.parametrize("spd", [1, 8])
def test_ndc_train_loop_with_batching_loss_decreases(tmp_path, spd):
    """tests/test_ndc_train.py's run in the port, through train_loop with ray
    batching: one sample_pool step at a time, or run_steps blocks on the pool."""
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import train_loop

    args = config_parser().parse_args([])
    for k, v in dict(N_rand=256, N_samples=24, N_importance=16, use_viewdirs=True,
                     finest_res=64, log2_hashmap_size=12, n_levels=8, lrate=0.01, chunk=2048,
                     N_iters=24, i_print=1, i_weights=10**6, i_testset=0, i_video=0,
                     steps_per_dispatch=spd, basedir=str(tmp_path), no_reload=True).items():
        setattr(args, k, v)
    assert not args.no_batching
    trainer = train_loop(args, _port_scene(_forward_facing_scene()), log_fn=lambda *_: None,
                         device="cpu")
    assert trainer.render_cfg.ndc and trainer.global_step == 24
    losses = [h[1] for h in trainer.history]
    psnrs = [h[2] for h in trainer.history]
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert np.mean(psnrs[-6:]) > np.mean(psnrs[:6])


def test_fern_cli_on_a_small_llff_set(tmp_path):
    """configs/fern.txt through hashnerf_torch.run_nerf on the CPU at small
    widths: ray batching in blocks, NDC; the test set's figures and PSNR
    pickle, the 120-pose spiral video and a checkpoint; then --render_only
    --render_test gives the training run's PSNRs."""
    import pickle

    from hashnerf_torch.run_nerf import main
    from hashnerf_torch.utils.png import read_png

    data = str(tmp_path / "fern")
    write_llff_set(data, n=9, H=12, W=16, factor=8)
    base = ["--config", FERN, "--datadir", data, "--basedir", str(tmp_path / "logs"),
            "--device", "cpu", "--log2_hashmap_size", "10", "--finest_res", "32", "--N_rand", "64",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "4096"]
    tr = main(base + ["--N_iters", "8", "--i_weights", "8", "--i_testset", "8", "--i_video", "8",
                      "--i_print", "4", "--steps_per_dispatch", "4", "--no_reload"])
    assert tr.scene.ndc and tr.render_cfg.ndc and tr.global_step == 8
    expdir = tmp_path / "logs" / tr.args.expname
    assert (expdir / "000008.ckpt").exists()
    assert list(tr.scene.i_test) == [0, 8]  # llffhold 8
    figs = [read_png(str(expdir / "testset_000008" / f"{i:03d}.png")) for i in range(2)]
    assert all(f.shape == (12, 32, 3) for f in figs)
    with open(next((expdir / "testset_000008").glob("test_psnrs_avg*.pkl")), "rb") as f:
        psnrs = pickle.load(f)
    video = [p.name for p in expdir.iterdir() if "_spiral_000008_rgb" in p.name]
    assert len(video) == 1

    only = main(base + ["--render_only", "--render_test"])
    assert only.global_step == 8
    with open(next((expdir / "renderonly_test_000008").glob("test_psnrs_avg*.pkl")), "rb") as f:
        np.testing.assert_allclose(pickle.load(f), psnrs, rtol=0, atol=1e-4)


def test_llff_and_batching_are_accepted():
    from hashnerf_torch.train.config import check_supported, parse_args

    args = parse_args(["--config", FERN])
    assert args.dataset_type == "llff" and not args.no_batching
    check_supported(args)


@pytest.mark.parametrize("flags,row", [
    (["--dataset_type", "scannet"], "A6"),
    (["--dataset_type", "deepvoxels"], "A6"),
    (["--dataset_type", "LINEMOD"], "A6"),
    (["--dataset_type", "st3d"], "A6"),
    (["--num_devices", "2"], "A8"),
])
def test_still_unported_with_batching_raise(flags, row):
    from hashnerf_torch.train.config import check_supported, parse_args

    with pytest.raises(NotImplementedError, match=row):
        check_supported(parse_args(["--config", FERN] + flags))

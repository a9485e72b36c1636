"""Many steps a launch (`--steps_per_dispatch`) in the port, against the JAX
package on the CPU: run_steps' block plan against JAX's Trainer.run_steps
(both with the block and the single step stubbed, so nothing compiles),
get_rays_at, the device-scalar RAdam, the presets, and on the CPU run_steps
against the same number of eager steps, bit for bit. Also the old
checkpoints' int step counts, and the tpu-quality widths of the packed
encode."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_torch_packed import BMAX, BMIN, _points, _tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")

FLAGSHIP = ["--n_levels", "4", "--n_features_per_level", "8", "--compute_dtype", "bfloat16",
            "--packed_layout", "--share_fine", "--aabb_clip", "--use_occupancy",
            "--occ_keep_fraction", "0.125", "--occ_keep_coarse", "0.375",
            "--occ_keep_schedule", "0:0.5,512:0.25,1024:0.125", "--occ_block", "8",
            "--occ_adaptive_update"]


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# The block plan
# --------------------------------------------------------------------------- #

def _fake_step(trainer, plan, fill):
    """A stand-in for Trainer.step: records it, counts it, and after a step
    that ends on the update grid marks the grid as holding density."""

    def step(batch):
        plan.append("step")
        trainer.global_step += 1
        occ = trainer.render_cfg.occupancy
        if occ is not None and trainer.global_step % occ.update_every == 0:
            fill()
            trainer._occ_ready = True
        return {}

    return step


def jax_plan(flags, start, n_steps, block_size, precrop):
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.train.config import parse_args
    from hashnerf_tpu.train.driver import Trainer

    jt = Trainer(parse_args(["--config", SMOKE, *flags]), make_synthetic_scene(H=16, W=16, n_train=2, n_test=1))
    jt.global_step = start
    plan = []

    def build(n, with_tv, occ_mode, precrop, keep=None):
        def block(state, opt_state, occ_in, key, tv_w, images, poses):
            plan.append((n, with_tv, occ_mode, precrop, keep))
            # an update found density: the next readiness read sees it
            return state, opt_state, None if occ_in is None else jnp.ones_like(occ_in), {}

        return block

    def fill():
        jt.occ_grid = jnp.ones_like(jt.occ_grid)

    jt._build_block = build
    jt._host_sample = lambda precrop: None
    jt.step = _fake_step(jt, plan, fill)
    jt.run_steps(n_steps, block_size=block_size, precrop=precrop)
    return plan, jt.global_step


def torch_plan(flags, start, n_steps, block_size, precrop):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    tt = Trainer(parse_args(["--config", SMOKE, *flags]), make_synthetic_scene(H=16, W=16, n_train=2, n_test=1),
                 device="cpu")
    tt.global_step = start
    plan = []

    def run_block(b, use_tv, occ_mode, precrop, keep, pool=None, at=0):
        assert pool is None
        plan.append((b, use_tv, occ_mode, precrop, keep))
        if occ_mode is not None:
            tt.occ_grid.fill_(1.0)
        return {}

    tt._run_block = run_block
    tt.sample_batch = lambda precrop: None
    tt.step = _fake_step(tt, plan, lambda: tt.occ_grid.fill_(1.0))
    tt.run_steps(n_steps, block_size=block_size, precrop=precrop)
    return plan, tt.global_step


PLANS = {
    # the flagship from step 0 to 1100: update blocks through the warmup
    # (256), culled at 0.5, 0.25 from 512, 0.125 from 1024; TV to 1008
    "flagship_0_1100": (FLAGSHIP, 0, 1100, 16, False),
    # no occupancy: a block ends at the TV cutoff, 1000
    "across_tv_cutoff": ([], 990, 30, 16, False),
    # update every 4, warmup 8, blocks of 8: two steps short of a block
    "remainder": (["--use_occupancy", "--occ_warmup", "8", "--occ_update_every", "4"], 0, 10, 8, True),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_block_plan_matches_jax(case):
    flags, start, n, block, precrop = PLANS[case]
    want, j_end = jax_plan(flags, start, n, block, precrop)
    got, t_end = torch_plan(flags, start, n, block, precrop)
    assert got == want
    assert t_end == j_end == start + n
    if case == "flagship_0_1100":
        blocks = [p for p in got if p != "step"]
        assert blocks[0] == (16, True, "update", False, None)
        # the TV window ends on the update grid: 1008; keep steps 512, 1024
        starts, s = [], 0
        for b in blocks:
            starts.append((s, b))
            s += b[0]
        assert (992, (16, True, "cull", False, 0.25)) in starts
        assert (1008, (16, False, "cull", False, 0.25)) in starts
        assert (512, (16, True, "cull", False, 0.25)) in starts
        assert (496, (16, True, "cull", False, 0.5)) in starts
        assert (1024, (16, False, "cull", False, 0.125)) in starts
    if case == "remainder":
        assert got[-2:] == ["step", "step"]


# --------------------------------------------------------------------------- #
# get_rays_at and RAdam
# --------------------------------------------------------------------------- #

def test_get_rays_at_matches_jax():
    from hashnerf_tpu.ops.rays import get_rays_at as jrays
    from hashnerf_torch.ops.rays import get_rays_at

    rng = np.random.default_rng(0)
    K = np.array([[140.0, 0, 63.5], [0, 140.0, 64.0], [0, 0, 1]], np.float32)
    c2w = rng.normal(size=(3, 4)).astype(np.float32)
    ys = rng.integers(0, 128, 500).astype(np.int64)
    xs = rng.integers(0, 128, 500).astype(np.int64)
    jo, jd = jrays(jnp.asarray(K), jnp.asarray(c2w), jnp.asarray(ys), jnp.asarray(xs))
    to, td = get_rays_at(_t(K), _t(c2w), _t(ys), _t(xs))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wd,eps", [(1e-6, 1e-8), (0.0, 1e-15)])  # the net and table groups
def test_device_radam_matches_jax(wd, eps):
    from hashnerf_tpu.train.driver import make_lr_schedule as jsched
    from hashnerf_tpu.train.radam import radam
    from hashnerf_torch.train.driver import make_lr_schedule
    from hashnerf_torch.train.radam import RAdam

    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(6, 4)).astype(np.float32)
    grads = rng.normal(size=(8, 6, 4)).astype(np.float32)
    opt_j = radam(jsched(0.01, 10), b1=0.9, b2=0.99, eps=eps, weight_decay=wd)
    pj = {"p": jnp.asarray(p0)}
    sj = opt_j.init(pj)
    p = torch.nn.Parameter(_t(p0))
    opt = RAdam([p], lr=make_lr_schedule(0.01, 10), betas=(0.9, 0.99), eps=eps, weight_decay=wd)
    for i, g in enumerate(grads):
        upd, sj = opt_j.update({"p": jnp.asarray(g)}, sj, pj)
        pj = {"p": pj["p"] + upd["p"]}
        p.grad = _t(g)
        opt.step()
        step = opt.state[p]["step"]
        assert step.dtype == torch.float32 and step.dim() == 0 and float(step) == i + 1
        if i < 5:  # the gate opens at step 6
            np.testing.assert_array_equal(p.detach().numpy(), p0)
        # XLA's float32 expm1 and PyTorch's differ by up to 2e-7 of 1 - b2^t,
        # which N_sma's cancellation makes 1e-5 of rect: 1e-5 of an update
        # of at most lr = 1e-2, hence atol 1e-7 where p crosses 0
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj["p"]), rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {i + 1}")
    assert not np.allclose(p.detach().numpy(), p0)


# --------------------------------------------------------------------------- #
# run_steps against eager steps on the CPU
# --------------------------------------------------------------------------- #

SMALL = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
             use_viewdirs=True, finest_res=64, log2_hashmap_size=10, white_bkgd=True,
             no_batching=True, perturb=1.0)
# test_torch_occupancy_train.py's flagship: warmup 2, an update every 2,
# the keep schedule cut to 8 steps
SMALL_FLAGSHIP = dict(SMALL, finest_res=32, n_levels=4, n_features_per_level=2,
                      log2_hashmap_size=13, log2_blocks=10, packed_layout=True, share_fine=True,
                      aabb_clip=True, use_occupancy=True, occ_resolution=32, occ_warmup=2,
                      occ_update_every=2, occ_keep_fraction=0.125, occ_keep_coarse=0.375,
                      occ_keep_schedule="0:0.5,4:0.25,6:0.125", occ_block=8,
                      occ_adaptive_update=True, compute_dtype="bfloat16")


def _trainer(settings, seed=0):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    args = config_parser().parse_args([])
    for k, v in settings.items():
        setattr(args, k, v)
    return Trainer(args, make_synthetic_scene(H=24, W=24, n_train=3, n_test=1), device="cpu", seed=seed)


@pytest.mark.parametrize("which", ["chair", "flagship"])
def test_run_steps_equals_eager_steps(which):
    """16 steps of run_steps(16) and 16 Trainer.step calls on sample_batch,
    from one state and one generator state: the same draws in the same
    order, so the same bits."""
    settings = SMALL if which == "chair" else SMALL_FLAGSHIP
    a, b = _trainer(settings), _trainer(settings)
    ma = a.run_steps(16, block_size=16)
    for _ in range(16):
        mb = b.step(b.sample_batch(False))
    assert a.global_step == b.global_step == 16
    assert a.last_occ_keep == b.last_occ_keep
    if which == "flagship":
        assert a.last_occ_keep == (0.125, 0.375) and a._occ_ready
        assert torch.equal(a.occ_grid, b.occ_grid) and float(a.occ_grid.max()) > 0
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k
    for x, y in zip(a.training_state(), b.training_state()):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_sample_batch_draws_distinct_pixels_in_the_window():
    t = _trainer(dict(SMALL, N_rand=64, precrop_frac=0.5))
    batch = t.sample_batch(precrop=True)
    assert set(batch) == {"rays_o", "rays_d", "target", "near", "far", "viewdirs"}
    # the window's 12 x 12 pixels of image i: rays and targets of those pixels
    hits = []
    for i in t.scene.i_train:
        full = t.sample_image(int(i), 144, precrop=True, sel=torch.arange(144))
        d = full["rays_d"][:, None, :] - batch["rays_d"][None]
        match = (d.abs().amax(-1) == 0) & (full["rays_o"][:, None] == batch["rays_o"][None]).all(-1)
        hits.append(int(match.any(0).sum()))
    assert max(hits) == 64  # all from one image, all inside its window
    assert torch.unique(batch["rays_d"], dim=0).shape[0] == 64  # without replacement


# --------------------------------------------------------------------------- #
# Presets, checkpoints, the tpu-quality widths
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("argv", [
    ["--preset", "tpu-fast"],
    ["--preset", "tpu-quality"],
    # the config file overrides the preset, the command line both
    ["--config", SMOKE, "--preset", "tpu-fast", "--n_levels", "8"],
    ["--preset", "tpu-quality", "--config", SMOKE, "--steps_per_dispatch", "4"],
])
def test_presets_parse_to_jax_args(argv):
    from hashnerf_tpu.train.config import parse_args as jparse
    from hashnerf_torch.train.config import check_supported, parse_args

    jargs, targs = vars(jparse(argv)), vars(parse_args(argv))
    shared = set(targs) & set(jargs)
    assert len(shared) > 80
    assert {k: targs[k] for k in shared} == {k: jargs[k] for k in shared}
    if "--config" in argv:
        args = parse_args(argv)
        check_supported(args)


def test_checkpoint_with_int_step_counts_loads(tmp_path):
    """Checkpoints written before RAdam's step count became a tensor hold
    ints; they load, and the next step equals that of the saving trainer."""
    a = _trainer(SMALL)
    for _ in range(7):
        a.step(a.sample_batch(False))
    a.save(str(tmp_path / "000007.ckpt"))
    payload = torch.load(str(tmp_path / "000007.ckpt"), weights_only=True)
    for st in payload["opt_state"]["state"].values():
        st["step"] = int(st["step"])
    torch.save(payload, str(tmp_path / "000007.ckpt"))

    b = _trainer(SMALL, seed=1)
    assert b.try_restore(str(tmp_path)) and b.global_step == 7
    for st in b.optimizer.state.values():
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 7
    a.generator.manual_seed(5)
    b.generator.manual_seed(5)
    a.step(a.sample_batch(False))
    b.step(b.sample_batch(False))
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k


def test_packed_encode_at_tpu_quality_widths_matches_jax():
    """tpu-quality's L8 / F4 packed grid (small tables): the forward and the
    table gradients against JAX."""
    from hashnerf_tpu.ops import packed_grid as jpg
    from hashnerf_torch.ops import packed_grid as tpg

    kw = dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=13, base_resolution=16,
              finest_resolution=64, log2_blocks=10)
    jc, tc = jpg.PackedGridConfig(**kw), tpg.PackedGridConfig(**kw)
    assert 0 < tc.dense_level_count < 8
    tables = _tables(tc, 7)
    x = _points(tc, 1000, 8)
    probe = np.random.default_rng(9).normal(size=(x.shape[0], tc.out_dim)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(BMIN), jnp.asarray(BMAX))
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    fj, _ = jpg.packed_encode(jt, *jargs, jc)
    gj = jax.grad(lambda t: jnp.sum(jpg.packed_encode(t, *jargs, jc)[0] * probe))(jt)
    tt = {k: _t(v).requires_grad_(True) for k, v in tables.items()}
    ft, _ = tpg.packed_encode(tt, _t(x), _t(BMIN), _t(BMAX), tc)
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    (ft * _t(probe)).sum().backward()
    for k in ("dense", "fine"):
        np.testing.assert_allclose(tt[k].grad.numpy(), np.asarray(gj[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("preset", ["tpu-fast", "tpu-quality"])
def test_preset_cli_trains_in_blocks_on_the_cpu(tmp_path, capsys, monkeypatch, preset):
    """python -m hashnerf_torch.run_nerf --preset ... --device cpu at smoke
    sizes: 16 update steps, then 16 culled, in blocks of 16."""
    from hashnerf_torch.run_nerf import main
    from hashnerf_torch.train.driver import Trainer

    blocks = set()
    build = Trainer._build_block

    def recorded(self, *key):
        blocks.add(key)
        return build(self, *key)

    monkeypatch.setattr(Trainer, "_build_block", recorded)
    trainer = main(["--config", SMOKE, "--preset", preset, "--N_rand", "64", "--occ_warmup", "16",
                    "--device", "cpu", "--no_reload", "--N_iters", "32", "--i_weights", "32",
                    "--i_print", "16", "--basedir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[TRAIN] Iter: 16 " in out and "[TRAIN] Iter: 32 " in out
    assert trainer.global_step == 32 and trainer._occ_ready
    assert blocks == {(16, True, "update", False, None),
                      (16, True, "cull", False, 0.5 if preset == "tpu-fast" else None)}
    assert trainer.last_occ_keep == ((0.5, 0.375) if preset == "tpu-fast" else (0.5, 0.5))
    (expdir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (expdir / "000032.ckpt").exists()

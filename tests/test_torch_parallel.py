"""Data parallelism and ZeRO-1 in the port (hashnerf_torch/parallel/) on the
CPU: ranks spawned as processes under gloo (parallel/mesh.py::launch; what
they run is tests/torch_parallel_ranks.py), held against the port's own
one-process run and against the JAX package's sharded steps on its 8-device
virtual CPU mesh (tests/conftest.py). Also the --num_devices checks, the
CLI's spawned run with its checkpoint, the multihost smoke tool and the
three modes' dry run.

Tolerances: rtol 1e-4 / atol 1e-6 on states after RAdam's warm-up
(ROADMAP §C), from tables scaled to U(-1, 1)."""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402

from hashnerf_torch.parallel.mesh import Layout, launch  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
JAX_SETTINGS = ranks.JAX_SETTINGS


def _close_states(got, want, what, outside=None):
    """Every entry within RTOL / ATOL; or, given outside = (share, bound),
    all but that share of each tensor's entries, and those within bound."""
    for k in want:
        if outside is None:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {k}")
            continue
        d = np.abs(got[k] - want[k])
        out = d > ATOL + RTOL * np.abs(want[k])
        assert out.sum() <= outside[0] * out.size and d.max() <= outside[1], \
            (what, k, int(out.sum()), out.size, float(d.max()))


def _close_losses(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, err_msg=what)


# --------------------------------------------------------------------------- #
# (a) a rank's rows
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_rows_match_jax_shards(n):
    from hashnerf_tpu.parallel.mesh import make_mesh
    from hashnerf_tpu.parallel.train_sharded import shard_train_batch
    from hashnerf_torch.parallel.mesh import shard_batch

    rng = np.random.default_rng(0)
    batch = {"rays_o": rng.normal(size=(64, 3)).astype(np.float32),
             "near": rng.normal(size=(64,)).astype(np.float32)}
    jb = shard_train_batch(make_mesh(n), batch)
    for key in batch:
        shards = sorted(jb[key].addressable_shards, key=lambda s: s.index[0].start or 0)
        for r, shard in enumerate(shards):
            layout = Layout(n, 1, r, r, 0, None, None)
            got = shard_batch(layout, {k: torch.from_numpy(v) for k, v in batch.items()})[key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


# --------------------------------------------------------------------------- #
# (b), (d), (e): the data-parallel Trainer against the one-process Trainer
# --------------------------------------------------------------------------- #

F32_PER_RAY = [f for f in ranks.PER_RAY if f not in ("--compute_dtype", "bfloat16")]
DP_RUNS = {
    # name: (flags, steps, mode)
    "step": ([], 8, "step"),
    "blocks": ([], 8, "blocks"),
    "pool": ([], 8, "pool"),
    "columns": (ranks.OMNI, 8, "columns"),
    "per_ray": (F32_PER_RAY, 8, "step"),
    "per_ray_bf16": (ranks.PER_RAY, 8, "step"),
}


@pytest.fixture(scope="module")
def dp2():
    """Every DP_RUNS run in one launch of 2 ranks, and each in one process."""
    torch.set_num_threads(1)
    many = launch(ranks.dp_suite_rank, 2, "cpu", (DP_RUNS,))
    one = {name: ranks.trainer_run(0, 1, "cpu", *spec) for name, spec in DP_RUNS.items()}
    torch.set_num_threads(2)
    return one, many


def test_dp_step_matches_one_process_at_2(dp2):
    """8 eager steps (past RAdam's 5-step warm-up) at N = 2: every draw
    global and in lockstep, so the losses and states are the one-process
    run's up to summation order; both ranks hold the same state."""
    one, many = dp2
    _close_losses([l for l, _ in many[0]["step"]["losses"]],
                  [l for l, _ in one["step"]["losses"]], "losses")
    _close_states(many[0]["step"]["state"], one["step"]["state"], "N=2")
    for k, v in many[0]["step"]["state"].items():
        np.testing.assert_array_equal(many[1]["step"]["state"][k], v, err_msg=k)


def test_dp_step_matches_one_process_at_4():
    torch.set_num_threads(1)
    try:
        many = launch(ranks.trainer_run, 4, "cpu", ([], 8))
        one = ranks.trainer_run(0, 1, "cpu", [], 8)
    finally:
        torch.set_num_threads(2)
    _close_losses([l for l, _ in many[0]["losses"]], [l for l, _ in one["losses"]], "losses")
    _close_states(many[0]["state"], one["state"], "N=4")
    for r in range(1, 4):
        for k, v in many[0]["state"].items():
            np.testing.assert_array_equal(many[r]["state"][k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("mode", ["blocks", "pool", "columns"])
def test_dp_run_steps_matches_one_process(dp2, mode):
    """Trainer(num_devices=2).run_steps(.., block_size=2), on sampled
    images, on the ray pool of an NDC scene (llff's path) and on a pool of
    st3d's columns (OmniNeRF's NeRFGradient with depth and gradient
    targets, Adam), against the one-process trainer: JAX's
    test_num_devices_flag_scanned_path_matches_single_device, here past
    the warm-up."""
    one, many = dp2
    assert many[0][mode]["global_step"] == one[mode]["global_step"] == 8
    _close_losses([l for l, _ in many[0][mode]["losses"]],
                  [l for l, _ in one[mode]["losses"]], f"{mode} losses")
    np.testing.assert_allclose([p for _, p in many[0][mode]["losses"]],
                               [p for _, p in one[mode]["losses"]], rtol=RTOL)
    # Adam (the NeRF family's) moves every entry by about lr from its first
    # step on (its first update is lr * sign(g)): where an entry's gradient
    # is near 0, the sum of two halves against the whole can flip its sign
    # and move it by up to 2 lr a step (measured: 22 of 65,536 entries of an
    # MLP, by up to 3.3e-5, after 8 steps at synthetic_smoke.txt's lr 0.01).
    # So there at most 1e-3 of a tensor's entries may leave the tolerance,
    # each by at most 2 lr a step.
    lr = ranks.small_args(ranks.OMNI).lrate
    _close_states(many[0][mode]["state"], one[mode]["state"], mode,
                  outside=(1e-3, 2 * lr * 8) if mode == "columns" else None)


def test_dp_per_ray_flagship(dp2):
    """The per-ray culled flagship (packed, share_fine, aabb_clip, per-ray
    culling from step 2, grid updates every 2 steps) at N = 2: culled at its
    budgets, the replicated grid update equal to the one-process one. In
    float32 the states agree to the standing tolerance; with bf16 MLP
    operands (the flagship's) a last-bit difference of a float32 weight
    moves its bf16 rounding by 2^-9 of it, so there the losses are held,
    and the states only where float32 compute holds them."""
    one, many = dp2
    for name in ("per_ray", "per_ray_bf16"):
        assert many[0][name]["keeps"] == one[name]["keeps"] == (0.25, 0.5)
        _close_losses([l for l, _ in many[0][name]["losses"]],
                      [l for l, _ in one[name]["losses"]], f"{name} losses")
    np.testing.assert_allclose(many[0]["per_ray"]["occ"], one["per_ray"]["occ"], rtol=RTOL,
                               atol=ATOL)
    _close_states(many[0]["per_ray"]["state"], one["per_ray"]["state"], "per-ray")


# --------------------------------------------------------------------------- #
# (c) against JAX's make_sharded_train_step
# --------------------------------------------------------------------------- #

def _jax_pair():
    """A JAX Trainer at JAX_SETTINGS with a U(-1, 1) table, its loss without
    TV, and one batch with viewdirs."""
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_tpu.train.config import config_parser
    from hashnerf_tpu.train.driver import Trainer, make_loss_fn

    args = config_parser().parse_args([])
    for k, v in JAX_SETTINGS.items():
        setattr(args, k, v)
    sc = make_synthetic_scene(H=24, W=24, n_train=3, n_test=1)
    jt = Trainer(args, sc)
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    loss_fn = make_loss_fn(args, jt.render_cfg, jt.query_fn, jt.bbox, jt.model_cfg.hash_grid,
                           with_tv=False)
    rng = np.random.default_rng(1)
    R = JAX_SETTINGS["N_rand"]
    ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
    ro, rd = get_rays_np(24, 24, sc.K, sc.poses[0])
    rd = rd[ys, xs].astype(np.float32)
    batch = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd,
             "viewdirs": rd / np.linalg.norm(rd, axis=-1, keepdims=True),
             "target": sc.images[0][ys, xs], "near": np.full(R, 2.0, np.float32),
             "far": np.full(R, 6.0, np.float32)}
    return jt, loss_fn, batch


def _np_state(state):
    to = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (np.asarray(state.hash_table), to(state.coarse), to(state.fine))


def test_dp_step_matches_jax_sharded_step():
    """One step at N = 2 against make_sharded_train_step on make_mesh(2),
    same batch, deterministic rendering: the loss, the summed gradient of
    every parameter (JAX's partitioned by GSPMD over the same mesh) and
    the state after the step. The jitted JAX step sums in other orders
    than the port: the port's one-process gradient is up to 5.3e-7 from
    JAX's on the table (its largest entry 9.3e-4), 1.9e-6 on an MLP. So
    the summed gradient is held to the port's one-process gradient at
    rtol 1e-4 / atol 1e-9, and to JAX's within rtol 1e-4 and the
    one-process port's own largest distance from it."""
    from hashnerf_tpu.parallel.mesh import make_mesh
    from hashnerf_tpu.parallel.train_sharded import make_sharded_train_step, shard_train_batch

    jt, loss_fn, batch = _jax_pair()
    mesh = make_mesh(2)
    sb = shard_train_batch(mesh, batch)
    key, tvw = jax.random.PRNGKey(0), jnp.float32(0.0)
    step = make_sharded_train_step(mesh, loss_fn, jt.optimizer)(jt.state, jt.opt_state, sb)
    s2, _, mj = step(jt.state, jt.opt_state, sb, key, tvw)
    grads = jax.jit(jax.grad(lambda st: loss_fn(st, sb, key, tvw)[0]))(jt.state)

    inputs = (JAX_SETTINGS, _np_state(jt.state), batch, _np_state(grads))
    torch.set_num_threads(1)
    try:
        got = launch(ranks.dp_jax_run, 2, "cpu", inputs)
        one = ranks.dp_jax_run(0, 1, "cpu", *inputs)
    finally:
        torch.set_num_threads(2)
    for r in got:
        np.testing.assert_allclose(r["loss"], float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["psnr"], float(mj["psnr"]), rtol=1e-5)
        for i, ((g, want), (g1, _)) in enumerate(zip(r["grads"], one["grads"])):
            np.testing.assert_allclose(g, g1, rtol=RTOL, atol=1e-9, err_msg=f"gradient {i}")
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=float(np.abs(g1 - want).max()),
                                       err_msg=f"gradient {i}")
    for (p, _), want in zip(got[0]["state"], [a for _, a in ranks_state_pairs(s2)]):
        np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-8)


def ranks_state_pairs(state):
    """(port parameter, JAX array in the port's layout) of a JAX state, by
    convert.jax_pairs on a fresh port state of JAX_SETTINGS."""
    from hashnerf_torch.convert import jax_pairs
    from hashnerf_torch.train.driver import Trainer

    t = Trainer(ranks.small_args(settings=JAX_SETTINGS), ranks.jax_scene(), device="cpu")
    return jax_pairs(t.state, *_np_state(state))


# --------------------------------------------------------------------------- #
# (f) the checks
# --------------------------------------------------------------------------- #

def test_num_devices_checks():
    """As the JAX Trainer: N_rand not divisible by N, and more NCCL ranks
    than cards, raise ValueError; so does N > 1 outside a process group of
    N ranks, and run_nerf's spawn checks N_rand before it starts a rank.
    Global culling under N > 1 is taken (A8.4, slice 11), per-ray culling
    too."""
    from hashnerf_torch import run_nerf
    from hashnerf_torch.train.config import check_supported
    from hashnerf_torch.train.driver import Trainer, data_parallel_layout

    with pytest.raises(ValueError, match="divisible"):
        Trainer(ranks.small_args(["--N_rand", "66"], world=4), ranks.scene(), device="cpu")
    with pytest.raises(ValueError, match="process group of 2"):
        Trainer(ranks.small_args(world=2), ranks.scene(), device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="available devices"):
            data_parallel_layout(ranks.small_args(world=2), torch.device("cuda"))
    with pytest.raises(ValueError, match="divisible"):
        run_nerf.main(["--config", ranks.SMOKE, "--device", "cpu", "--num_devices", "3"])
    check_supported(ranks.small_args(["--use_occupancy"], world=2))
    check_supported(ranks.small_args(ranks.TPU_FAST, world=2))
    check_supported(ranks.small_args(ranks.PER_RAY, world=2))
    # one device: no layout, no process group needed; --num_devices 1 is
    # --num_devices 0, and a layout its caller gives is taken as it is
    for n in (0, 1):
        assert data_parallel_layout(ranks.small_args(["--num_devices", str(n)]),
                                    torch.device("cpu")) is None
    one = Layout(1, 1, 0, 0, 0, None, None)
    assert data_parallel_layout(ranks.small_args(), torch.device("cpu"), one) is one


def test_launch_needs_a_device():
    """launch has no default device: every caller names the CPU or the
    card, and a call without one raises before any rank starts."""
    with pytest.raises(TypeError, match="device"):
        launch(ranks.trainer_run, 2)
    with pytest.raises(TypeError, match="device"):
        launch(ranks.trainer_run, 2, args=([], 1))


def test_global_culling_draws_raise():
    """draw_render gives global culling's draws (it refused them before
    slice 11): a global cull composites every pass on its full z grid, so
    its noise has the full sample counts, drawn in render_rays' order
    (jitter, coarse noise, importance uniforms, fine noise); per-ray
    culling's noise has each ray's budget."""
    from hashnerf_torch.render.renderer import draw_render
    from hashnerf_torch.train.driver import render_config_from_args

    cfg = render_config_from_args(ranks.small_args(["--use_occupancy"]))
    S, Si = cfg.N_samples, cfg.N_importance
    g = torch.Generator().manual_seed(5)
    d = draw_render(cfg, 8, g, "cpu", culled=True)
    g.manual_seed(5)
    want = [torch.rand((8, S), generator=g), torch.randn((8, S), generator=g),
            torch.rand((8, Si), generator=g), torch.randn((8, S + Si), generator=g)]
    for got, w in zip((d.t_strat, d.noise0, d.u_pdf, d.noise1), want):
        assert torch.equal(got, w)
    assert d.u_sorted is None
    assert draw_render(cfg, 8, g, "cpu", culled=False).noise1.shape == (8, S + Si)
    per_ray = render_config_from_args(ranks.small_args(ranks.PER_RAY))
    d = draw_render(per_ray, 8, g, "cpu", culled=True)
    assert d.noise0.shape == (8, 8) and d.noise1.shape == (8, 8)  # keeps 0.5 of 8, 0.25 of 16


# --------------------------------------------------------------------------- #
# (g) ZeRO-1
# --------------------------------------------------------------------------- #

def test_chunk_params_match_jax():
    from hashnerf_tpu.parallel.train_sharded import chunk_params as jchunk
    from hashnerf_tpu.parallel.train_sharded import unchunk_params as junchunk
    from hashnerf_torch.parallel.train_sharded import chunk_params, unchunk_params

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32), np.float32(rng.normal(size=()))]}
    ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
    for n in (2, 4, 8):
        want = jchunk(jax.tree_util.tree_map(jnp.asarray, tree), n)
        got = chunk_params(ttree, n)
        for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
        back = unchunk_params(got, ttree)
        jback = junchunk(want, jax.tree_util.tree_map(jnp.asarray, tree))
        for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, back)),
                        jax.tree_util.tree_leaves(jback)):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture(scope="module")
def zero2(tmp_path_factory):
    jt, loss_fn, batch = _jax_pair()
    ckpt = str(tmp_path_factory.mktemp("zero") / "000008.ckpt")
    torch.set_num_threads(1)
    try:
        got = launch(ranks.zero_suite_rank, 2, "cpu", (_np_state(jt.state), batch, ckpt))
    finally:
        torch.set_num_threads(2)
    return jt, loss_fn, batch, got, ckpt


def _stitch(got, key, i):
    return np.concatenate([r[key][i] for r in got])


def test_zero_fp32_matches_jax_dp_zero_step(zero2):
    """One ZeRO-1 step, fp32 wire, against make_dp_zero_train_step on
    make_mesh(2) from the same state and batch: the loss, the masters
    after the step and the first moments (0.1 of the reduce-scattered
    gradient), unchunked and in the port's layout; a moment within 0.1 of
    the distance of the port's one-device gradient from JAX's."""
    from hashnerf_tpu.parallel.mesh import make_mesh
    from hashnerf_tpu.parallel.train_sharded import (
        init_dp_zero, make_dp_zero_train_step, unchunk_params,
    )
    from hashnerf_torch.convert import jax_pairs
    from hashnerf_torch.parallel.train_sharded import unchunk_params as tunchunk
    from hashnerf_torch.train.driver import Trainer

    jt, loss_fn, batch, got, _ = zero2
    mesh = make_mesh(2)
    build = make_dp_zero_train_step(mesh, loss_fn, jt.optimizer, grad_dtype=jnp.float32,
                                    broadcast_dtype=jnp.float32)
    master, zopt = init_dp_zero(mesh, jt.state, jt.optimizer)
    master2, zopt2, m = build(jt.state, zopt)(master, zopt, dict(batch), jax.random.PRNGKey(3),
                                              jnp.float32(0.0))
    runs = [r["jax"] for r in got]
    np.testing.assert_allclose(runs[0]["losses"][0], float(m["loss"]), rtol=1e-5)

    t = Trainer(ranks.small_args(settings=JAX_SETTINGS), ranks.jax_scene(), device="cpu")
    params = t.state.net_parameters() + t.state.table_parameters()
    jmaster = unchunk_params(jax.tree_util.tree_map(np.asarray, master2), jt.state)
    embed = zopt2.inner_states["embed"].inner_state.mu
    net = zopt2.inner_states["net"].inner_state.mu
    mu = unchunk_params(jax.tree_util.tree_map(np.asarray, (embed.hash_table, net.coarse,
                                                            net.fine)),
                        (jt.state.hash_table, jt.state.coarse, jt.state.fine))
    # how far the port's one-device gradient is from JAX's (jitted, other
    # summation orders) on this batch, in params' order (jax_pairs gives
    # the table first)
    key, tvw = jax.random.PRNGKey(3), jnp.float32(0.0)
    grads = jax.jit(jax.grad(lambda st: loss_fn(st, batch, key, tvw)[0]))(jt.state)
    one = ranks.dp_jax_run(0, 1, "cpu", JAX_SETTINGS, _np_state(jt.state), batch,
                           _np_state(grads))
    dist = [float(np.abs(g - w).max()) for g, w in one["grads"]]
    dist = dist[1:] + dist[:1]
    for name, want_tree, atol in (("master", _np_state(jmaster), [1e-9] * len(dist)),
                                  ("exp_avg", mu, [0.1 * d for d in dist])):
        want = {id(p): a for p, a in jax_pairs(t.state, *want_tree)}
        for i, p in enumerate(params):
            whole = tunchunk(torch.from_numpy(_stitch(runs, name, i)), p)
            # rtol as JAX's own test; a first moment is 0.1 of a gradient
            np.testing.assert_allclose(whole.numpy(), want[id(p)], rtol=2e-4, atol=atol[i],
                                       err_msg=f"{name} {i}")


def test_zero_fp32_matches_one_device_and_holds_chunks(zero2):
    """8 ZeRO-1 steps, fp32 wire, deterministic rendering, against 8
    one-device Trainer steps on the batch (past the warm-up): the masters,
    stitched and unchunked, equal the one-device state. Each rank holds
    its moments only as 1/N chunks. (ZeRO-1 divides every gradient by N,
    the sparsity's per-ray sum too, as JAX's: its weight is 0 here.)"""
    from hashnerf_torch.parallel.train_sharded import unchunk_params
    from hashnerf_torch.train.driver import Trainer

    *_, got, _ = zero2
    runs = [r["one"] for r in got]
    torch.set_num_threads(1)
    one = ranks.one_device_run(0, 1, "cpu", ["--sparse-loss-weight", "0"], 8)
    torch.set_num_threads(2)
    _close_losses(runs[0]["losses"], one["losses"], "losses")
    t = Trainer(ranks.small_args(ranks.DET), ranks.scene(), device="cpu")
    names = {id(p): n for n, p in t.state.named_parameters()}
    params = t.state.net_parameters() + t.state.table_parameters()
    for i, p in enumerate(params):
        whole = unchunk_params(torch.from_numpy(_stitch(runs, "master", i)), p).numpy()
        np.testing.assert_allclose(whole, one["state"][names[id(p)]], rtol=RTOL, atol=ATOL,
                                   err_msg=names[id(p)])
    for r in runs:
        chunks = [s for s in r["moments"]]
        wants = [(-(-int(np.prod(s)) // 2),) for s in r["params"] for _ in range(2)]
        assert chunks == wants


def test_zero_checkpoint_round_trip(zero2):
    """The 8-step fp32 ZeRO-1 run's checkpoint, written whole by rank 0
    (every parameter "data"-chunked): restored into fresh chunks on both
    ranks, bit for bit, moments and step counts too; and into a
    one-process Trainer (another layout), whose state is the one-device
    run's at the standing tolerance."""
    from hashnerf_torch.train.checkpoint import load_checkpoint
    from hashnerf_torch.train.driver import Trainer

    *_, got, ckpt = zero2
    for r in got:
        assert r["one"]["restored"] == {"step": 8, "equal": True}
    payload = torch.load(ckpt, weights_only=True)
    assert set(payload["placement"].values()) == {"data"}
    t = Trainer(ranks.small_args(ranks.DET), ranks.scene(), device="cpu", seed=5)
    assert load_checkpoint(ckpt, t.state, t.optimizer) == 8
    torch.set_num_threads(1)
    one = ranks.one_device_run(0, 1, "cpu", ["--sparse-loss-weight", "0"], 8)
    torch.set_num_threads(2)
    _close_states(ranks.state_np(t.state), one["state"], "restored")


def test_zero_bf16_wire_trains(zero2):
    """bf16 all-gather and reduce-scatter: finite, and the loss falls over 8
    steps on the fixed batch (fp32 masters keep the updates that the bf16
    broadcast rounds away)."""
    *_, got, _ = zero2
    losses = got[0]["bf16"]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert got[1]["bf16"]["losses"] == losses


# --------------------------------------------------------------------------- #
# (k) the CLI, (l) the tools
# --------------------------------------------------------------------------- #

def test_run_nerf_spawns_ranks_and_restores(tmp_path):
    """run_nerf --device cpu --num_devices 2 spawns its ranks: 8 steps, one
    checkpoint written by rank 0 alone, the same losses on both ranks; a
    re-run restores it on both ranks and trains on to 12."""
    from hashnerf_torch import run_nerf

    base = ["--config", ranks.SMOKE, "--device", "cpu", "--num_devices", "2", "--N_rand", "64",
            "--N_samples", "8", "--N_importance", "8", "--basedir", str(tmp_path),
            "--i_print", "4", "--i_weights", "8"]
    torch.set_num_threads(1)
    try:
        first = run_nerf.main(base + ["--N_iters", "8"])
        ckpts = sorted(p.name for p in tmp_path.rglob("*.ckpt"))
        again = run_nerf.main(base + ["--N_iters", "12", "--i_weights", "100"])
    finally:
        torch.set_num_threads(2)
    assert [r["rank"] for r in first] == [0, 1]
    assert all(r["global_step"] == 8 and r["restored_from"] is None for r in first)
    assert first[0]["history"] == first[1]["history"] and len(first[0]["history"]) == 2
    assert ckpts == ["000008.ckpt"]
    assert all(r["global_step"] == 12 and r["restored_from"].endswith("000008.ckpt")
               for r in again)
    assert sorted(p.name for p in tmp_path.rglob("*.ckpt")) == ckpts
    payload = torch.load(next(tmp_path.rglob("000008.ckpt")), weights_only=True)
    assert set(payload["placement"].values()) == {"replicated"}
    # --render_only renders in this one process, from the latest checkpoint
    only = run_nerf.main(base + ["--render_only", "--render_test", "--i_weights", "100"])
    assert only.layout is None and only.global_step == 8


def test_multihost_smoke_tool(tmp_path):
    from hashnerf_torch.tools import multihost_smoke

    out = tmp_path / "smoke.json"
    rec = multihost_smoke.main(["--device", "cpu", "--out", str(out)])
    assert rec["ok"] and rec["n_processes"] == 2 and rec["n_global_devices"] == 2
    assert np.isfinite(rec["loss"])
    import json

    assert json.loads(out.read_text()) == rec


def test_dryrun_multichip_4():
    from hashnerf_torch.parallel.dryrun import dryrun_multichip

    torch.set_num_threads(1)
    try:
        res = dryrun_multichip(4, "cpu")
    finally:
        torch.set_num_threads(2)
    assert set(res) == {"dp_per_ray", "dp_global", "table_sharded", "zero_bf16"}
    assert all(np.isfinite(r["loss"]) for r in res.values())
    assert res["dp_global"]["keeps"] == (0.25, 0.5)  # the second step culls globally
    assert res["table_sharded"]["layout"] == [2, 2]


def test_bench_scaling_measure():
    from hashnerf_torch.tools.bench_scaling import measure

    torch.set_num_threads(1)
    try:
        res = measure([1, 2], "cpu", n_rand=64, n_iters=1, n_samples=8, n_importance=4)
    finally:
        torch.set_num_threads(2)
    assert [r["devices"] for r in res] == [1, 2]
    assert all(r["rays_per_s"] > 0 and r["device"] == "cpu" for r in res)
    assert res[0]["scaling_efficiency"] == 1.0

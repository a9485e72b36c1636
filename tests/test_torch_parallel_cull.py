"""Global occupancy culling under data parallelism (the tpu-fast flagship
under --num_devices N) on the CPU: ranks spawned as processes under gloo
(what they run is tests/torch_parallel_ranks.py), held against the port's
one-process culled run and against the JAX package's sharded step with
global culling on its virtual CPU mesh (tests/conftest.py). Every rank
takes the one cut over the whole batch, queries its share of the kept
blocks (or points) and gathers the others' raws
(render/occupancy.py::query_with_culling, parallel/mesh.py::gather_shares).

Tolerances: tests/test_torch_parallel.py's (rtol 1e-4 / atol 1e-6 on
states after RAdam's warm-up, from tables scaled to U(-1, 1)); the bf16
preset is held by its losses, as the per-ray bf16 flagship is there."""
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
from test_torch_parallel import _close_losses, _close_states, _np_state  # noqa: E402

from hashnerf_torch.parallel.mesh import launch  # noqa: E402

# the keeps of 8 steps: warmup 2, then culled at (fine, coarse); GLOBAL's
# schedule turns the fine budget to 0.25 at step 4
KEEPS = {"global": (0.25, 0.5), "global_point": (0.25, 0.5), "tpu_fast": (0.5, 0.375)}
RUNS = {
    # name: (flags, steps, mode)
    "global": (ranks.GLOBAL, 8, "step"),
    "global_point": (ranks.GLOBAL_POINT, 8, "step"),
    "tpu_fast": (ranks.TPU_FAST, 8, "step"),
    "global_blocks": (ranks.GLOBAL, 8, "blocks"),
}


def _one(names):
    torch.set_num_threads(1)
    try:
        return {name: ranks.trainer_run(0, 1, "cpu", *RUNS[name]) for name in names}
    finally:
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def one():
    """The one-process runs (the blocks are held to the eager steps)."""
    return _one(("global", "global_point", "tpu_fast"))


@pytest.fixture(scope="module")
def dp2():
    torch.set_num_threads(1)
    try:
        return launch(ranks.dp_suite_rank, 2, "cpu", (RUNS,))
    finally:
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dp4():
    torch.set_num_threads(1)
    try:
        return launch(ranks.dp_suite_rank, 4, "cpu",
                      ({k: RUNS[k] for k in ("global", "global_point")},))
    finally:
        torch.set_num_threads(2)


def _same_on_every_rank(many, name):
    for r in range(1, len(many)):
        for k, v in many[0][name]["state"].items():
            np.testing.assert_array_equal(many[r][name]["state"][k], v, err_msg=f"rank {r}: {k}")
        np.testing.assert_array_equal(many[r][name]["occ"], many[0][name]["occ"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["global", "global_point"])
def test_global_culled_steps_match_one_process(request, one, n, name):
    """8 eager steps (2 of warmup, 6 culled, the fine budget annealed at
    step 4) at N ranks: the one cut over the whole batch, each rank's share
    of the kept blocks (block 8) or points gathered back, every ray
    composited on every rank, the loss on its rows. The losses, the states
    and the replicated grid are the one-process run's up to summation
    order; every rank holds the same state; last_occ_keep is the global
    budget."""
    many = request.getfixturevalue(f"dp{n}")
    got, want = many[0][name], one[name]
    assert got["keeps"] == want["keeps"] == KEEPS[name]
    _close_losses([l for l, _ in got["losses"]], [l for l, _ in want["losses"]], f"{name} losses")
    _close_states(got["state"], want["state"], f"{name} N={n}")
    np.testing.assert_allclose(got["occ"], want["occ"], rtol=1e-4, atol=1e-6)
    _same_on_every_rank(many, name)


def test_tpu_fast_preset_at_2_is_held_by_its_losses(dp2, one):
    """--preset tpu-fast (bf16 MLP operands; warmup and updates cut to 2
    steps): a last-bit difference of a float32 weight moves its bf16
    rounding by 2^-9 of it, so the losses are held (tests/test_torch_parallel.py
    test_dp_per_ray_flagship says why), and the keeps."""
    got, want = dp2[0]["tpu_fast"], one["tpu_fast"]
    assert got["keeps"] == want["keeps"] == KEEPS["tpu_fast"]
    _close_losses([l for l, _ in got["losses"]], [l for l, _ in want["losses"]], "tpu-fast losses")
    _same_on_every_rank(dp2, "tpu_fast")


def test_global_culled_blocks_match_eager_steps(dp2, one):
    """Trainer.run_steps blocks of 2 at N = 2 with global culling (on the
    CPU each block runs its steps eagerly, the grid update after each
    second step) against the one-process eager steps."""
    got, want = dp2[0]["global_blocks"], one["global"]
    assert got["global_step"] == want["global_step"] == 8
    assert got["keeps"] == KEEPS["global"]
    _close_losses([l for l, _ in got["losses"]], [l for l, _ in want["losses"]][1::2],
                  "block losses")
    _close_states(got["state"], want["state"], "blocks")


@pytest.mark.parametrize("name", ["global", "global_point"])
def test_global_culled_step_with_padded_shares_at_3(name):
    """N = 3 does not divide the coarse pass's kept count (48 rays: 32
    blocks, 256 points): the shares are padded and the padding's raws
    dropped. Three steps, the third culled, against one process."""
    flags = [*RUNS[name][0], "--N_rand", "48"]
    torch.set_num_threads(1)
    try:
        many = launch(ranks.trainer_run, 3, "cpu", (flags, 3))
        want = ranks.trainer_run(0, 1, "cpu", flags, 3)
    finally:
        torch.set_num_threads(2)
    assert many[0]["keeps"] == want["keeps"] == (0.5, 0.5)
    _close_losses([l for l, _ in many[0]["losses"]], [l for l, _ in want["losses"]], "losses")
    _close_states(many[0]["state"], want["state"], "N=3")


# --------------------------------------------------------------------------- #
# against JAX's make_sharded_train_step with global culling
# --------------------------------------------------------------------------- #

OCC_SETTINGS = dict(ranks.JAX_SETTINGS, use_occupancy=True, occ_resolution=32, occ_block=8,
                    occ_keep_fraction=0.25, occ_keep_coarse=0.5)


def test_global_culled_step_matches_jax_sharded_step():
    """One step at N = 2 against make_sharded_train_step(make_mesh(2), ...,
    with_occ=True), same batch, deterministic rendering, one seeded grid
    (a third of its cells empty: the cut falls inside runs of equal
    scores): the loss, every parameter's summed gradient (held as
    tests/test_torch_parallel.py::test_dp_step_matches_jax_sharded_step
    holds them) and the state after the step."""
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.ops.rays import get_rays_np
    from hashnerf_tpu.parallel.mesh import make_mesh
    from hashnerf_tpu.parallel.train_sharded import make_sharded_train_step, shard_train_batch
    from hashnerf_tpu.train.config import config_parser
    from hashnerf_tpu.train.driver import Trainer, make_loss_fn
    from test_torch_parallel import ranks_state_pairs

    args = config_parser().parse_args([])
    for k, v in OCC_SETTINGS.items():
        setattr(args, k, v)
    sc = make_synthetic_scene(H=24, W=24, n_train=3, n_test=1)
    jt = Trainer(args, sc)
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    loss_fn = make_loss_fn(args, jt.render_cfg, jt.query_fn, jt.bbox, jt.model_cfg.hash_grid,
                           with_tv=False)
    rng = np.random.default_rng(1)
    R = OCC_SETTINGS["N_rand"]
    ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
    ro, rd = get_rays_np(24, 24, sc.K, sc.poses[0])
    rd = rd[ys, xs].astype(np.float32)
    batch = {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd,
             "viewdirs": rd / np.linalg.norm(rd, axis=-1, keepdims=True),
             "target": sc.images[0][ys, xs], "near": np.full(R, 2.0, np.float32),
             "far": np.full(R, 6.0, np.float32)}
    grid = (rng.uniform(size=32**3) * (rng.uniform(size=32**3) > 1 / 3)).astype(np.float32)

    mesh = make_mesh(2)
    sb = shard_train_batch(mesh, batch)
    key, tvw, jgrid = jax.random.PRNGKey(0), jnp.float32(0.0), jnp.asarray(grid)
    step = make_sharded_train_step(mesh, loss_fn, jt.optimizer, with_occ=True)(
        jt.state, jt.opt_state, sb)
    s2, _, mj = step(jt.state, jt.opt_state, sb, key, tvw, jgrid)
    grads = jax.jit(jax.grad(lambda st: loss_fn(st, sb, key, tvw, occ_grid=jgrid)[0]))(jt.state)

    inputs = (OCC_SETTINGS, _np_state(jt.state), batch, _np_state(grads), grid)
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
            np.testing.assert_allclose(g, g1, rtol=1e-4, atol=1e-9, err_msg=f"gradient {i}")
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=float(np.abs(g1 - want).max()),
                                       err_msg=f"gradient {i}")
    for (p, _), want in zip(got[0]["state"], [a for _, a in ranks_state_pairs(s2)]):
        np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-8)


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #

def test_run_nerf_tpu_fast_at_2_culls_and_checkpoints(tmp_path):
    """run_nerf --preset tpu-fast --num_devices 2 --device cpu: 16 steps as
    one block of 16 (eager on the CPU) after 4 steps of warmup, culled at
    the preset's budgets from step 4, one checkpoint by rank 0, the same
    losses on both ranks."""
    from hashnerf_torch import run_nerf

    argv = ["--config", ranks.SMOKE, "--preset", "tpu-fast", "--device", "cpu",
            "--num_devices", "2", "--N_rand", "64", "--N_samples", "8", "--N_importance", "8",
            "--occ_warmup", "4", "--occ_update_every", "4", "--N_iters", "20",
            "--i_print", "10", "--i_weights", "20", "--basedir", str(tmp_path)]
    torch.set_num_threads(1)
    try:
        res = run_nerf.main(argv)
    finally:
        torch.set_num_threads(2)
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["global_step"] == 20 and r["last_occ_keep"] == (0.5, 0.375) for r in res)
    assert res[0]["history"] == res[1]["history"] and len(res[0]["history"]) == 2
    assert all(np.isfinite(l) for _, l, _ in res[0]["history"])
    assert sorted(p.name for p in tmp_path.rglob("*.ckpt")) == ["000020.ckpt"]

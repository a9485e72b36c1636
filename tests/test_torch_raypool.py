"""Ray batching in the port against the JAX package on the CPU: the ray pool
(unshuffled against hashnerf_tpu.native.build_ray_pool, shuffled as a
permutation of it, reshuffled in place), run_steps on the pool against the
same number of sample_pool steps bit for bit, its block plan against JAX's
Trainer.run_steps_pool, a fresh capture's first step against step(), and
train_loop's pool spans and epochs against
JAX's train_loop (blocks, steps and the trainer's pool stubbed, so nothing
compiles)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_torch_scanned import FLAGSHIP, SMOKE


def _scene():
    from hashnerf_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(H=16, W=16, n_train=3, n_test=1)


def _trainer(flags=(), seed=0):
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    args = parse_args(["--config", SMOKE, "--N_rand", "32", "--N_samples", "8",
                       "--N_importance", "8", *flags])
    return Trainer(args, _scene(), device="cpu", seed=seed)


def _sorted_rows(pool):
    flat = np.asarray(pool).reshape(len(pool), -1)
    return flat[np.lexsort(flat.T[::-1])]


def test_pool_matches_jax_and_shuffles_to_a_permutation():
    from hashnerf_tpu import native

    tt = _trainer()
    sc = tt.scene
    want = native.build_ray_pool(sc.poses[sc.i_train], sc.images[sc.i_train], sc.K, shuffle=False)
    got = tt.build_ray_pool(shuffle=False)
    assert got.shape == want.shape == (3 * 16 * 16, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    shuffled = tt.build_ray_pool()
    assert not torch.equal(shuffled, got)
    np.testing.assert_allclose(_sorted_rows(shuffled.numpy()), _sorted_rows(want), rtol=1e-5, atol=1e-6)

    # an epoch's reshuffle permutes in place: graphs read the pool's address
    ptr, before = shuffled.data_ptr(), shuffled.clone()
    tt.shuffle_pool(shuffled)
    assert shuffled.data_ptr() == ptr and not torch.equal(shuffled, before)
    np.testing.assert_array_equal(_sorted_rows(shuffled.numpy()), _sorted_rows(before.numpy()))


def test_sample_pool_takes_the_next_rows():
    tt = _trainer()
    pool = tt.build_ray_pool()
    b = tt.sample_pool(pool, 64, 32)
    assert torch.equal(b["rays_o"], pool[64:96, 0]) and torch.equal(b["target"], pool[64:96, 2])
    assert torch.equal(b["near"], torch.full((32,), 2.0)) and torch.equal(b["far"], torch.full((32,), 6.0))
    tail = tt.sample_pool(pool, pool.shape[0] - 5, 32)  # the last rows of an epoch
    assert tail["rays_d"].shape == (5, 3) and tail["near"].shape == (5,)
    tt.shuffle_pool(pool)  # a batch taken is a copy, not a view
    assert torch.equal(b["rays_o"], b["rays_o"].clone())


@pytest.mark.parametrize("flags,start,n,block", [
    ((), 0, 12, 8),
    # update every 4 from step 0, warmup 4: update blocks, then culled ones
    (("--use_occupancy", "--occ_warmup", "4", "--occ_update_every", "4"), 0, 10, 8),
])
def test_run_steps_pool_equals_sample_pool_steps(flags, start, n, block):
    """On the CPU a pool block runs the graphed body eagerly: bit for bit the
    eager steps on the same rows, from the same state and generator."""
    a, b = _trainer(flags), _trainer(flags)
    pool = a.build_ray_pool()
    assert torch.equal(pool, b.build_ray_pool())
    a.global_step = b.global_step = start
    offset = 2 * 32
    ma = a.run_steps(n, block_size=block, pool=pool, offset=offset)
    for k in range(n):
        mb = b.step(b.sample_pool(pool, offset + k * 32, 32))
    assert a.global_step == b.global_step == start + n
    for key in ("loss", "psnr"):
        assert torch.equal(ma[key], mb[key]), key
    for (name, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), name
    if a.occ_grid is not None:
        assert torch.equal(a.occ_grid, b.occ_grid) and a._occ_ready == b._occ_ready
        assert a.last_occ_keep == b.last_occ_keep
    with pytest.raises(ValueError, match="pool's end"):
        a.run_steps(3, pool=pool, offset=pool.shape[0] - 64)


@pytest.mark.parametrize("source", ["images", "pool"])
def test_capture_first_step_is_the_eager_step(source):
    """The step a fresh capture runs (graph_window's one-step gate) is, on the
    CPU, step() on the same batch bit for bit: loss and every gradient;
    global_step stays, and a plan whose block is shorter raises."""
    a, b = _trainer(), _trainer()
    pool = a.build_ray_pool() if source == "pool" else None
    if pool is not None:
        assert torch.equal(pool, b.build_ray_pool())
    a.global_step = b.global_step = 40
    ma = a.capture_first_step(16, pool=pool, offset=96)
    mb = b.step(b.sample_batch(False) if pool is None else b.sample_pool(pool, 96, 32))
    assert a.global_step == 40 and torch.equal(ma["loss"], mb["loss"])
    for (name, x), (_, y) in zip(a.state.named_parameters(), b.state.named_parameters()):
        assert torch.equal(x.grad, y.grad), name
    a.global_step = 990  # the TV window ends at 1000: a block of 11
    with pytest.raises(ValueError, match="is 11 steps, not 16"):
        a.capture_first_step(16, pool=pool)


# --------------------------------------------------------------------------- #
# The block plan and train_loop's spans, against JAX (stubbed)
# --------------------------------------------------------------------------- #

N_RAND = 8


def jax_pool_plan(flags, start, n_steps, block_size, offset):
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.train.config import parse_args
    from hashnerf_tpu.train.driver import Trainer

    jt = Trainer(parse_args(["--config", SMOKE, "--N_rand", str(N_RAND), *flags]),
                 make_synthetic_scene(H=16, W=16, n_train=2, n_test=1))
    jt.global_step = start
    plan = []

    def build(n, with_tv, occ_mode, pool_keys, keep=None):
        def block(state, opt_state, occ_in, pool, off, key, tv_w):
            plan.append((n, with_tv, occ_mode, keep, int(off)))
            return state, opt_state, None if occ_in is None else jnp.ones_like(occ_in), {}

        return block

    def step(batch):
        plan.append(("step", int(batch["rays_o"][0, 0])))
        jt.global_step += 1
        occ = jt.render_cfg.occupancy
        if occ is not None and jt.global_step % occ.update_every == 0:
            jt.occ_grid = jnp.ones_like(jt.occ_grid)
            jt._occ_ready = True
        return {}

    rows = offset + n_steps * N_RAND
    ids = jnp.arange(rows, dtype=jnp.float32)
    pool = {"rays_o": jnp.stack([ids] * 3, 1), "rays_d": jnp.zeros((rows, 3)),
            "target": jnp.zeros((rows, 3))}
    jt._build_pool_block = build
    jt.step = step
    jt.run_steps_pool(pool, offset, n_steps, block_size=block_size)
    return plan, jt.global_step


def torch_pool_plan(flags, start, n_steps, block_size, offset):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    tt = Trainer(parse_args(["--config", SMOKE, "--N_rand", str(N_RAND), *flags]),
                 make_synthetic_scene(H=16, W=16, n_train=2, n_test=1), device="cpu")
    tt.global_step = start
    plan = []

    def run_block(b, use_tv, occ_mode, precrop, keep, pool, at):
        assert not precrop
        plan.append((b, use_tv, occ_mode, keep, at))
        if occ_mode is not None:
            tt.occ_grid.fill_(1.0)
        return {}

    def step(batch):
        plan.append(("step", int(batch["rays_o"][0, 0])))
        tt.global_step += 1
        occ = tt.render_cfg.occupancy
        if occ is not None and tt.global_step % occ.update_every == 0:
            tt.occ_grid.fill_(1.0)
            tt._occ_ready = True
        return {}

    pool = torch.zeros(offset + n_steps * N_RAND, 3, 3)
    pool[:, 0, 0] = torch.arange(pool.shape[0], dtype=torch.float32)
    tt._run_block = run_block
    tt.step = step
    tt.run_steps(n_steps, block_size=block_size, pool=pool, offset=offset)
    return plan, tt.global_step


POOL_PLANS = {
    "flagship_0_1100": (FLAGSHIP, 0, 1100, 16, 0),
    "across_tv_cutoff": ([], 990, 30, 16, 24),
    "remainder": (["--use_occupancy", "--occ_warmup", "8", "--occ_update_every", "4"], 0, 10, 8, 40),
}


@pytest.mark.parametrize("case", sorted(POOL_PLANS))
def test_pool_block_plan_matches_jax(case):
    """run_steps on the pool splits like JAX's run_steps_pool (the plan of
    run_steps), and each block and single step starts at JAX's pool row."""
    flags, start, n, block, offset = POOL_PLANS[case]
    want, j_end = jax_pool_plan(flags, start, n, block, offset)
    got, t_end = torch_pool_plan(flags, start, n, block, offset)
    assert got == want
    assert t_end == j_end == start + n
    if case == "remainder":
        assert got[-2:] == [("step", 40 + 8 * N_RAND), ("step", 40 + 9 * N_RAND)]


def _loop_calls(monkeypatch, Trainer, train_loop, args, scene, pool, blocks):
    """train_loop's pool calls with the Trainer's pool, blocks and steps
    stubbed: [(kind, i_batch, n_steps)]; a reshuffle shows as i_batch 0.
    `blocks` names the method that runs pool blocks: JAX's run_steps_pool,
    the port's run_steps (given the pool)."""
    calls = []

    def block(self, offset, n_steps, block_size):
        assert block_size == args.steps_per_dispatch
        calls.append(("block", int(offset), n_steps))
        self.global_step += n_steps
        return {"loss": 0.0, "psnr": 0.0}

    if blocks == "run_steps_pool":
        def run_blocks(self, pool, offset, n_steps, block_size=0):
            return block(self, offset, n_steps, block_size)
    else:
        def run_blocks(self, n_steps, block_size=0, precrop=False, pool=None, offset=0):
            assert pool is not None and not precrop
            return block(self, offset, n_steps, block_size)

    def sample_pool(self, pool, i_batch, n_rand):
        calls.append(("step", int(i_batch), 1))
        return {}

    def step(self, batch):
        self.global_step += 1
        return {"loss": 0.0, "psnr": 0.0}

    monkeypatch.setattr(Trainer, "build_ray_pool", lambda self: pool)
    monkeypatch.setattr(Trainer, blocks, run_blocks)
    monkeypatch.setattr(Trainer, "sample_pool", sample_pool)
    monkeypatch.setattr(Trainer, "step", step)
    train_loop(args, scene, log_fn=lambda *_: None)
    return calls


@pytest.mark.parametrize("spd", [1, 8])
def test_train_loop_pool_spans_match_jax(tmp_path, monkeypatch, spd):
    """With ray batching, spans end at the events (i_print 20) and where the
    pool's rows run out (10.5 batches), where the pool is reshuffled, as in
    JAX's loop; without --steps_per_dispatch, one pool step at a time."""
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.train import driver as jdriver
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train import driver
    from hashnerf_torch.train.config import parse_args

    def args_for(basedir):
        args = parse_args(["--config", SMOKE, "--N_rand", str(N_RAND), "--N_iters", "50",
                           "--i_print", "20", "--i_weights", "1000000", "--i_video", "1000000",
                           "--i_testset", "1000000", "--steps_per_dispatch", str(spd),
                           "--basedir", str(basedir), "--no_reload", "--device", "cpu"])
        args.no_batching = False
        return args

    rows = 10 * N_RAND + N_RAND // 2
    want = _loop_calls(monkeypatch, jdriver.Trainer, jdriver.train_loop, args_for(tmp_path / "j"),
                       jscene(H=8, W=8, n_train=2, n_test=1), jnp.zeros((rows, 3, 3)),
                       "run_steps_pool")
    shuffles = []
    monkeypatch.setattr(driver.Trainer, "shuffle_pool", lambda self, pool: shuffles.append(pool))
    got = _loop_calls(monkeypatch, driver.Trainer, driver.train_loop, args_for(tmp_path / "t"),
                      make_synthetic_scene(H=8, W=8, n_train=2, n_test=1), torch.zeros(rows, 3, 3),
                      "run_steps")
    assert got == want
    assert sum(n for _, _, n in got) == 50
    assert len(shuffles) == sum(1 for c in got[1:] if c[1] == 0) > 0

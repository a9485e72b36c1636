"""The level-sharded table in the port (hashnerf_torch/parallel/
table_sharded.py) on the CPU: (data, model) layouts of 2 and 4 ranks
spawned under gloo (what they run is tests/torch_parallel_ranks.py). The
encoder against the JAX package's make_sharded_encoder on its virtual CPU
mesh; the table-sharded trainer against the one-device trainer; its
checkpoint restored onto a layout of another shape; and a checkpoint of
the JAX package's table-sharded trainer (save_table_sharded) restored into
the port."""
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

from hashnerf_torch.parallel.mesh import launch  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
N_STEPS = 8  # past RAdam's 5-step warm-up
NEXT_SEED = 100  # the generator's seed for the step after the checkpoint
TABLE_FLAGS = ["--n_levels", "8", *ranks.DET]


@pytest.fixture(scope="module")
def enc_inputs():
    """An 8-level table of U(-1, 1), 64 points, the box."""
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, (8, 1 << 10, 2)).astype(np.float32)
    x = rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    return table, x, bbox


def _jax_encoder(enc_inputs, n_data, n_model):
    """JAX's sharded features and the table's gradient of sum(f^2)."""
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig
    from hashnerf_tpu.parallel.table_sharded import make_sharded_encoder, make_table_mesh, shard_table

    table, x, bbox = enc_inputs
    cfg = HashGridConfig(n_levels=8, n_features_per_level=2, log2_hashmap_size=10,
                         base_resolution=4, finest_resolution=64)
    mesh = make_table_mesh(n_data, n_model)
    encode = make_sharded_encoder(mesh, cfg)
    b = jnp.asarray(bbox)

    t = shard_table(mesh, jnp.asarray(table))
    # not jitted, as JAX's own test: jitted, XLA's fusion sums the blend
    # and its gradient in other orders (1.6e-6 on a feature, 4.7e-7 on a
    # table gradient at these inputs)
    feats, keep = encode(t, jnp.asarray(x), b[0], b[1])
    grad = jax.grad(lambda t: jnp.sum(encode(t, jnp.asarray(x), b[0], b[1])[0] ** 2))(t)
    return np.asarray(feats), np.asarray(keep), np.asarray(grad)


@pytest.fixture(scope="module")
def layouts(enc_inputs, tmp_path_factory):
    """(2, 2) on 4 ranks: the encoder, N_STEPS table-sharded steps, a
    checkpoint, one more step. Then (1, 2) on 2 ranks: the encoder,
    N_STEPS steps, the (2, 2) checkpoint restored with one more step, and
    a JAX save_table_sharded checkpoint restored."""
    from hashnerf_tpu.parallel.table_sharded import (
        make_table_mesh, make_table_sharded_trainer, save_table_sharded,
    )
    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from tests.test_train_e2e import tiny_args

    tmp = tmp_path_factory.mktemp("table_sharded")
    ckpt = str(tmp / "000008.ckpt")
    # the JAX package's table-sharded trainer on a (2, 4) mesh, its table
    # scaled to U(-1, 1), checkpointed at step 5 with its specs
    sc = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    jargs = tiny_args(N_rand=64, N_samples=8, N_importance=8, n_levels=8)
    jstate, jopt, _ = make_table_sharded_trainer(make_table_mesh(2, 4), jargs,
                                                 jax.random.PRNGKey(5), np.stack(sc.bounding_box),
                                                 sc.near, sc.far)
    jstate = jstate._replace(hash_table=jstate.hash_table * 1e4)
    jax_ckpt = str(tmp / "jax_000005.ckpt")
    save_table_sharded(jax_ckpt, 5, jstate, jopt)

    torch.set_num_threads(1)
    try:
        r22 = launch(ranks.table_suite_rank, 4, "cpu", (2, 2, enc_inputs, {
            "train": dict(n_steps=N_STEPS, save=ckpt, next_seed=NEXT_SEED)}))
        r12 = launch(ranks.table_suite_rank, 2, "cpu", (1, 2, enc_inputs, {
            "train": dict(n_steps=N_STEPS),
            "restore": dict(n_steps=0, restore=ckpt, jax_ckpt=jax_ckpt, next_seed=NEXT_SEED)}))
        one = ranks.trainer_run(0, 1, "cpu", TABLE_FLAGS, N_STEPS, next_seed=NEXT_SEED)
    finally:
        torch.set_num_threads(2)
    return {(2, 2): r22, (1, 2): r12, "one": one, "jax": jstate, "ckpt": ckpt}


def _whole_table(res, key):
    """The table of one data row's model ranks, levels in order."""
    parts = {r[key]["model"]: r[key]["state"]["hash_table"] for r in res}
    return np.concatenate([parts[m] for m in sorted(parts)])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_encoder_matches_jax(layouts, enc_inputs, shape):
    """Features (each rank's rows, all levels) and the table's gradient
    (each rank's levels, summed over the data group) against JAX's
    make_sharded_encoder on make_table_mesh(*shape)."""
    feats, keep, grad = _jax_encoder(enc_inputs, *shape)
    for r in layouts[shape]:
        start, stop = r["enc"]["rows"]
        np.testing.assert_allclose(r["enc"]["feats"], feats[start:stop], rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(r["enc"]["keep"], keep[start:stop])
        per = 8 // shape[1]
        m = r["enc"]["model"]
        np.testing.assert_allclose(r["enc"]["grad"], grad[m * per:(m + 1) * per], rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_table_sharded_steps_match_one_device(layouts, shape):
    """N_STEPS table-sharded steps (TV off, deterministic rendering) against
    the one-device trainer from the same seed and U(-1, 1) table: losses,
    the table stitched from the model ranks, and every rank's MLPs (the
    same on every rank: no sum over the model axis)."""
    one, res = layouts["one"], layouts[shape]
    key = "train"
    np.testing.assert_allclose(res[0][key]["losses"], [l for l, _ in one["losses"]], rtol=RTOL)
    np.testing.assert_allclose(_whole_table(res, key), one["state"]["hash_table"], rtol=RTOL,
                               atol=ATOL)
    for r in res:
        for k, v in one["state"].items():
            if k != "hash_table":
                np.testing.assert_allclose(r[key]["state"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_checkpoint_restores_onto_another_layout(layouts):
    """The (2, 2) run's checkpoint, written whole by rank 0 with each
    parameter's placement, restored onto (1, 2): the same step, each
    rank's levels and moments those the (2, 2) ranks of its model index
    held, and the next step's loss that of the uninterrupted run (and of
    the one-device run)."""
    r22, r12 = layouts[(2, 2)], layouts[(1, 2)]
    payload = torch.load(layouts["ckpt"], weights_only=True)
    assert payload["placement"]["hash_table"] == "model"
    assert {v for k, v in payload["placement"].items() if k != "hash_table"} == {"replicated"}
    for r in r12:
        rest = r["restore"]
        assert rest["restored_step"] == rest["global_step"] == N_STEPS
        src = next(q for q in r22 if q["train"]["model"] == rest["model"])["train"]
        for k, v in src["state"].items():
            np.testing.assert_array_equal(rest["state"][k], v, err_msg=k)
        for a, b in zip(rest["exp_avg"], src["exp_avg"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(rest["next_loss"], src["next_loss"], rtol=1e-6)
        np.testing.assert_allclose(rest["next_loss"], layouts["one"]["next_loss"], rtol=RTOL)


def test_jax_table_sharded_checkpoint_restores(layouts):
    """A checkpoint of the JAX package's table-sharded trainer
    (save_table_sharded on a (2, 4) mesh, with its sharding specs) restored
    into the port's (1, 2) layout: its step, each rank's levels and the
    MLPs equal to the JAX state's."""
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import NGPState
    from hashnerf_torch.train.driver import model_config_from_args

    js = layouts["jax"]
    whole = NGPState(model_config_from_args(ranks.small_args(TABLE_FLAGS)), None, "cpu")
    to = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    load_jax_state(whole, np.asarray(js.hash_table), to(js.coarse), to(js.fine))
    want = ranks.state_np(whole)
    for r in layouts[(1, 2)]:
        assert r["restore"]["jax_step"] == 5
        m = r["restore"]["model"]
        for k, v in want.items():
            got = r["restore"]["jax_state"][k]
            if k == "hash_table":
                v = v[m * 4:(m + 1) * 4]
            np.testing.assert_array_equal(got, v, err_msg=k)

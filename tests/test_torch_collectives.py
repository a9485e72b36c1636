"""The collectives' payload bytes (parallel/mesh.py::collective_bytes) and
tools/bench_scaling.py::collective_volumes on 2 gloo ranks at a tiny chair
config, against hlo_collective_summary of the JAX package's steps at the
same shapes, compiled on a 2-device virtual mesh (tests/conftest.py).

Counts may differ (XLA fuses the gradients' all-reduces into one tuple and
splits the table by level; the port sends a tensor a parameter); payload
bytes are held exactly, under two differences XLA makes that each test
shows from the HLO itself (ROADMAP §C):
- the data-parallel step: XLA all-reduces the coarse and the fine pass's
  partial gradients of each parameter apart and adds them after (each
  shape twice in the tuple); the port all-reduces each summed gradient
  once, so it sends half the bytes;
- ZeRO-1: the program's bf16 wire (its StableHLO) is what the port sends;
  XLA:CPU's compiled HLO carries it in float32, twice the bytes (the
  SCALING_r05.json record was compiled there).
The table-sharded step's feature all-gathers are equal; the reduce-scatter
JAX's transpose of the gather adds, the port does not send (each rank
takes its columns of the replicated cotangent), and JAX's all-reduce over
the data axis of one rank moves nothing. The step's metrics (JAX's
scalars) are listed apart."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TINY = {"N_rand": 64, "N_samples": 8, "N_importance": 8, "log2_hashmap_size": 10,
        "finest_res": 32}
TABLE_LOG2 = 11

_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4}


def _shape_bytes(dtype, dims):
    n = _BYTES[dtype]
    for d in filter(None, dims.split(",")):
        n *= int(d)
    return n


def _tuple_elements(hlo_text, kind):
    """[(dtype, dims)] of every output of the compiled HLO's `kind` ops."""
    out = []
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(\([^)]*\)|\S+)\s+" + kind + r"(-start)?\(", line)
        if m:
            out += _SHAPE.findall(m.group(1))
    return out


def _stablehlo_bytes(text, op):
    """Bytes of the results of every stablehlo `op` of a lowered program
    (the program's own dtypes, before XLA compiles it)."""
    total = 0
    for m in re.finditer(r'"stablehlo\.' + op + r'"', text):
        sig = text[m.end():].split(" -> ", 1)[1].split("\n", 1)[0]
        for dims, dt in re.findall(r"tensor<((?:\d+x)*)(\w+)>", sig):
            n = {"f32": 4, "bf16": 2}[dt]
            for d in filter(None, dims.split("x")):
                n *= int(d)
            total += n
    return total


@pytest.fixture(scope="module")
def port():
    from hashnerf_torch.tools.bench_scaling import collective_volumes

    torch.set_num_threads(1)
    try:
        return collective_volumes(2, "cpu", over=TINY, table_log2=TABLE_LOG2, scene_hw=16)
    finally:
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_steps():
    """The compiled HLO text of JAX's data-parallel, table-sharded and
    ZeRO-1 steps (and ZeRO-1's StableHLO) at TINY on 2 devices."""
    from jax.sharding import Mesh

    from hashnerf_tpu.data.synthetic import make_synthetic_scene
    from hashnerf_tpu.parallel.table_sharded import make_table_mesh, make_table_sharded_trainer
    from hashnerf_tpu.parallel.train_sharded import (
        init_dp_zero, make_dp_zero_train_step, make_sharded_train_step, shard_train_batch,
    )
    from hashnerf_tpu.tools.bench_scaling import _chair_args
    from hashnerf_tpu.train.config import config_parser
    from hashnerf_tpu.train.driver import Trainer, make_loss_fn

    def args_of(**over):
        a = _chair_args(config_parser)
        for k, v in {**TINY, **over}.items():
            setattr(a, k, v)
        return a

    args = args_of()
    scene = make_synthetic_scene(H=16, W=16, n_train=4, n_test=1)
    tr = Trainer(args, scene)
    loss_fn = make_loss_fn(args, tr.render_cfg, tr.query_fn, tr.bbox, tr.model_cfg.hash_grid,
                           with_tv=False)
    devices = jax.devices()[:2]
    mesh = Mesh(np.array(devices), axis_names=("data",))
    batch = tr.sample_image(0, args.N_rand, precrop=False)
    d = batch["rays_d"]
    batch["viewdirs"] = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    key, zero = jax.random.PRNGKey(0), jnp.float32(0.0)
    sbatch = shard_train_batch(mesh, dict(batch))
    dp = make_sharded_train_step(mesh, loss_fn, tr.optimizer)(tr.state, tr.opt_state, sbatch)
    out = {"dp": dp.lower(tr.state, tr.opt_state, sbatch, key, zero).compile().as_text()}

    st, opt, tstep = make_table_sharded_trainer(
        make_table_mesh(1, 2, devices=devices), args_of(log2_hashmap_size=TABLE_LOG2),
        jax.random.PRNGKey(1), np.stack(scene.bounding_box), scene.near, scene.far)
    out["table"] = tstep.lower(st, opt, batch, jax.random.PRNGKey(2)).compile().as_text()

    master, zopt = init_dp_zero(mesh, tr.state, tr.optimizer)
    zstep = make_dp_zero_train_step(mesh, loss_fn, tr.optimizer)(tr.state, zopt)
    lowered = zstep.lower(master, zopt, dict(batch), key, zero)
    out["zero_stablehlo"] = lowered.as_text()
    out["zero"] = lowered.compile().as_text()
    return out


def test_data_parallel_bytes(port, jax_steps):
    from hashnerf_tpu.tools.bench_scaling import hlo_collective_summary

    rec = port["data_parallel"]
    got = rec["collectives_per_step"]
    assert set(got) == {"all-reduce"} and rec["all_reduce_metrics_bytes"] == 8  # loss, img_loss
    want = hlo_collective_summary(jax_steps["dp"])
    assert set(want) == {"all-reduce"} and want["all-reduce"]["count"] == 1
    elems = _tuple_elements(jax_steps["dp"], "all-reduce")
    scalars = [e for e in elems if e[1] == ""]
    tensors = [e for e in elems if e[1] != ""]
    jax_scalar_bytes = sum(_shape_bytes(*e) for e in scalars)
    assert jax_scalar_bytes == 16  # four f32 metrics, fused into the tuple
    # every gradient shape appears an even number of times: the coarse and
    # the fine pass's partial sums, all-reduced apart
    shapes = [e[1] for e in tensors]
    assert all(shapes.count(s) % 2 == 0 for s in shapes)
    assert shapes.count("1024,4") == 2 * 8  # the table, by level, twice
    grads = got["all-reduce"]["bytes"] - rec["all_reduce_metrics_bytes"]
    assert 2 * grads == want["all-reduce"]["bytes"] - jax_scalar_bytes
    assert grads == sum(_shape_bytes(*e) for e in tensors) // 2


def test_table_sharded_bytes(port, jax_steps):
    from hashnerf_tpu.tools.bench_scaling import hlo_collective_summary

    rec = port["table_sharded"]
    assert rec["mesh"] == {"data": 1, "model": 2}
    got, want = rec["collectives_per_step"], hlo_collective_summary(jax_steps["table"])
    assert got["all-gather"] == want["all-gather"]  # both passes' features, equal
    assert set(got) == {"all-gather"}
    # JAX's transpose of the gather: the features' cotangent, reduce-scattered
    assert want["reduce-scatter"]["bytes"] * 2 == want["all-gather"]["bytes"]
    # its all-reduce over the data axis of one rank a group moves nothing
    assert re.search(r"all-reduce\(.*replica_groups=\{\{0\},\{1\}\}", jax_steps["table"])


def test_zero_bytes(port, jax_steps):
    from hashnerf_tpu.tools.bench_scaling import hlo_collective_summary

    rec = port["data_parallel_zero"]
    got, want = rec["collectives_per_step"], hlo_collective_summary(jax_steps["zero"])
    program = {k: _stablehlo_bytes(jax_steps["zero_stablehlo"], op) for k, op in (
        ("all-gather", "all_gather"), ("reduce-scatter", "reduce_scatter"))}
    assert re.search(r"tensor<2x1x\d+xbf16>", jax_steps["zero_stablehlo"])
    for kind in ("all-gather", "reduce-scatter"):
        assert got[kind]["count"] == want[kind]["count"] == 6
        assert got[kind]["bytes"] == program[kind]  # the program's bf16 wire
        assert 2 * got[kind]["bytes"] == want[kind]["bytes"]  # XLA:CPU's float32
    assert got["all-reduce"] == want["all-reduce"] == {"count": 1, "bytes": 12}
    assert rec["all_reduce_metrics_bytes"] == 12
    # JAX's ring model over these
    n = 2
    assert rec["wire_mb_per_device"] == pytest.approx(
        (got["all-gather"]["bytes"] / n + got["reduce-scatter"]["bytes"] + 12) / 1e6)


def test_collective_bytes_counted_and_replayed():
    """collective_tally's differences added back (a CUDA graph's replays,
    train/graphs.py::_add): counts, bytes and the metrics' bytes, each
    times over; kernel launches go to the kernels' counts."""
    from hashnerf_torch import kernels
    from hashnerf_torch.parallel import mesh
    from hashnerf_torch.train import graphs

    mesh.reset_collective_counts()
    kernels.reset_launch_counts()
    graphs._add({"hash_encode_fwd": 1, "all_reduce": 2, "all_reduce_bytes": 100,
                 "all_reduce_metrics_bytes": 8, "all_gather": 1, "all_gather_bytes": 64}, 3)
    assert mesh.collective_counts() == {"all_reduce": 6, "all_gather": 3, "reduce_scatter": 0}
    assert mesh.collective_bytes() == {"all_reduce": 300, "all_gather": 192,
                                       "reduce_scatter": 0, "all_reduce_metrics": 24}
    assert mesh.collective_tally()["all_gather_bytes"] == 192
    assert kernels.launch_counts()["hash_encode_fwd"] == 3
    mesh.reset_collective_counts()
    kernels.reset_launch_counts()
    assert not any(mesh.collective_tally().values())


def test_metrics_bytes_are_the_marked_all_reduces(monkeypatch):
    """Only all-reduces marked as metrics count as metrics, whatever their
    size: reduce_gradients' 1- and 3-element biases (the NeRF family's)
    count as gradients, the step's metric vector as metrics."""
    from hashnerf_torch.parallel import mesh, train_sharded

    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t, group=None: None)
    mesh.reset_collective_counts()
    params = [torch.nn.Parameter(torch.zeros(n)) for n in (1, 3, 256)]
    for p in params:
        p.grad = torch.ones_like(p)
    train_sharded.reduce_gradients(params, group=object())
    mesh.all_reduce(torch.zeros(3), group=object(), metrics=True)
    assert mesh.collective_counts()["all_reduce"] == 4
    assert mesh.collective_bytes()["all_reduce"] == 4 * (1 + 3 + 256 + 3)
    assert mesh.collective_bytes()["all_reduce_metrics"] == 12
    mesh.reset_collective_counts()


def test_table_layout_and_wire_model():
    from hashnerf_torch.tools.bench_scaling import table_layout, wire_mb

    assert [table_layout(w) for w in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (2, 4)]
    summ = {"all-reduce": {"count": 1, "bytes": 8e6}, "all-gather": {"count": 1, "bytes": 4e6},
            "reduce-scatter": {"count": 1, "bytes": 1e6}}
    assert wire_mb(summ, 4) == pytest.approx(2 * 8 * 3 / 4 + 4 * 3 / 4 + 1 * 3)
    assert wire_mb(summ, 1) == 0.0

"""Data-parallel scaling, the collectives' bytes a step, and a two-host
projection.

Counterpart of hashnerf_tpu/tools/bench_scaling.py:

* `measure`: train rays/s at each world size of a list. Each world size
  runs as that many ranks (parallel/mesh.py::launch); each rank's Trainer
  (timing_args: the JAX tool's shapes and learning rate) takes its rows of
  one fixed global batch of n_rand rays for a warm-up step and n_iters
  timed steps (host clock, closed by a synchronize on the card). On the
  CPU the ranks share the host's cores: those rates say nothing of a
  device.
* `collective_volumes`: the bytes each kind of collective carries in one
  step of each parallel mode at JAX's shapes (chair_args: L8 / F4, log2 T
  19, 4096 rays, 64 + 128 samples; the table mode at log2 T 21), read from
  the counted collectives (parallel/mesh.py::collective_bytes, JAX's
  hlo_collective_summary convention), with JAX's ring model of the wire
  bytes a device sends (wire_mb).
* `project_two_host`: JAX's arithmetic (`projection`) over the ZeRO-1 bf16
  wire at the flagship's shape (two ranks) and step times of the card:
  given, or the flagship's graphed step measured in the call.

Ranks run on the card unless a device is named: NCCL a card a rank, gloo
ranks sharing card 0 where there are fewer cards (parallel/mesh.py::
world_backend), gloo on the CPU. Not ported: `hlo_overlap_report` and
`tpu_topology_check`, which read XLA's compiled HLO and a TPU topology.

    python -m hashnerf_torch.tools.bench_scaling --json-out OUT.json [--worlds 1 2]
        [--skip-volumes] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def timing_args(n_rand: int, world: int = 0, n_samples: int = 16, n_importance: int = 32):
    """The arguments of measure's Trainer, as the JAX tool's
    _tiny_timing_args builds them (hashnerf_tpu/tools/bench_scaling.py:99):
    the parser's defaults (lrate 5e-4), N_rand, finest_res 128,
    log2_hashmap_size 15, use_viewdirs and white_bkgd, with the sample
    counts measure passes; no TV, as the JAX loss there has none."""
    from hashnerf_torch.train.config import config_parser

    args = config_parser().parse_args(["--num_devices", str(world)])
    args.N_rand = n_rand
    args.N_samples = n_samples
    args.N_importance = n_importance
    args.finest_res = 128
    args.log2_hashmap_size = 15
    args.use_viewdirs = True
    args.white_bkgd = True
    args.tv_loss_weight = 0.0
    return args


def _rank(rank: int, world: int, device, n_rand: int, n_iters: int, n_samples: int,
          n_importance: int):
    import torch.distributed as dist

    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh
    from hashnerf_torch.train.driver import Trainer

    args = timing_args(n_rand, world, n_samples, n_importance)
    # a layout at every world, one rank too: each step runs its all-reduce
    t = Trainer(args, make_synthetic_scene(H=64, W=64, n_train=4, n_test=1), device=device,
                layout=make_mesh(world))
    batch = t.sample_image(0, n_rand, False)

    def sync():
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    float(t.step(batch)["loss"])
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        m = t.step(batch)
    float(m["loss"])
    sync()
    return (time.perf_counter() - t0) / n_iters


def measure(worlds, device=None, n_rand=4096, n_iters=10, n_samples=16, n_importance=32):
    """[{devices, device, backend, step_ms, rays_per_s, scaling_efficiency}]
    for each world size in worlds (n_rand divisible by each), on the card
    unless device names another (hashnerf_torch.resolve_device: with no
    card and no device named this raises). A world larger than the cards
    present runs as gloo ranks sharing card 0 (parallel/mesh.py::world_backend)."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.parallel.mesh import launch, world_backend

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    results, base = [], None
    for n in worlds:
        backend = world_backend(n, dev)
        dt = max(launch(_rank, n, dev, (n_rand, n_iters, n_samples, n_importance),
                        backend=backend))
        rate = n_rand / dt
        base = base or rate / n
        results.append({"devices": n, "device": name, "backend": backend, "step_ms": dt * 1e3,
                        "rays_per_s": rate, "scaling_efficiency": rate / (base * n)})
        print(json.dumps(results[-1]), flush=True)
    return results


KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}


def chair_args(**over):
    """JAX's _chair_args (hashnerf_tpu/tools/bench_scaling.py:111): the
    parser's defaults, 4096 rays, 64 + 128 samples, finest_res 512, log2 T
    19, L8 / F4, share_fine, viewdirs, white_bkgd; no TV (the JAX step has
    none). over: attributes set after these."""
    from hashnerf_torch.train.config import config_parser

    args = config_parser().parse_args([])
    args.N_rand = 4096
    args.N_samples = 64
    args.N_importance = 128
    args.finest_res = 512
    args.log2_hashmap_size = 19
    args.n_levels = 8
    args.n_features_per_level = 4
    args.share_fine = True
    args.use_viewdirs = True
    args.white_bkgd = True
    args.tv_loss_weight = 0.0
    for k, v in over.items():
        setattr(args, k, v)
    return args


def flagship_args(**over):
    """JAX's _flagship_args (:315): the flagship's parameters (packed L4 /
    F8, log2 T 19, finest_res 512, a shared net, bf16 MLPs), 1024 rays,
    no culling (the collectives carry parameters and gradients alone)."""
    return chair_args(**{"N_rand": 1024, "n_levels": 4, "n_features_per_level": 8,
                         "packed_layout": True, "compute_dtype": "bfloat16", **over})


def _tally():
    """{kind: {count, bytes}} of the collectives since the last reset, and
    the metrics' all-reduce bytes (a subset of the all-reduce's)."""
    from hashnerf_torch.parallel.mesh import collective_bytes, collective_counts

    counts, nbytes = collective_counts(), collective_bytes()
    summ = {KINDS[k]: {"count": counts[k], "bytes": nbytes[k]} for k in KINDS if counts[k]}
    return summ, nbytes["all_reduce_metrics"]


def wire_mb(summ, n: int) -> float:
    """MB a device sends a step under JAX's ring model (:273-286): an
    all-reduce of X 2X(n-1)/n, an all-gather of output X X(n-1)/n, a
    reduce-scatter of output shard X X(n-1)."""
    w = 0.0
    for kind, ent in summ.items():
        if kind == "all-reduce":
            w += 2 * ent["bytes"] * (n - 1) / n
        elif kind == "reduce-scatter":
            w += ent["bytes"] * (n - 1)
        else:
            w += ent["bytes"] * (n - 1) / n
    return w / 1e6


def _mode_record(mesh_axes, config, summ, metric_bytes, n):
    return {"mesh": mesh_axes, "config": config, "collectives_per_step": summ,
            "all_reduce_metrics_bytes": metric_bytes,
            "total_mb": sum(v["bytes"] for v in summ.values()) / 1e6,
            "wire_mb_per_device": wire_mb(summ, n)}


def table_layout(world: int):
    """JAX's (W/4, 4) layout, or the largest model axis the ranks allow."""
    n_model = next(m for m in (4, 2, 1) if world % m == 0)
    return world // n_model, n_model


def _volumes_rank(rank: int, world: int, device, over: dict, table_log2: int, hw: int):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh, reset_collective_counts
    from hashnerf_torch.parallel.table_sharded import make_table_mesh, make_table_sharded_trainer
    from hashnerf_torch.train.driver import Trainer

    scene = make_synthetic_scene(H=hw, W=hw, n_train=4, n_test=1)
    out = {}
    # 1. data parallelism, parameters replicated: the gradients' all-reduce
    args = chair_args(**over)
    layout = make_mesh(world)
    t = Trainer(args, scene, device=device, layout=layout)
    batch = t.sample_image(0, args.N_rand, False)
    reset_collective_counts()
    float(t.step(batch)["loss"])
    summ, mb = _tally()
    out["data_parallel"] = _mode_record(
        {"data": world}, f"chair flagship (L{args.n_levels}/F{args.n_features_per_level}, "
        f"log2T={args.log2_hashmap_size}, N_rand={args.N_rand}, "
        f"{args.N_samples}+{args.N_importance})", summ, mb, world)
    del t

    # 2. the level-sharded table on (W/4, 4), or the largest layout
    n_data, n_model = table_layout(world)
    args2 = chair_args(**{**over, "log2_hashmap_size": table_log2})
    ts = make_table_sharded_trainer(make_table_mesh(n_data, n_model), args2, scene,
                                    device=device, seed=1)
    reset_collective_counts()
    float(ts.step(ts.sample_image(0, args2.N_rand, False))["loss"])
    summ, mb = _tally()
    table_mb = (args2.n_levels << args2.log2_hashmap_size) * args2.n_features_per_level * 4 / 1e6
    out["table_sharded"] = _mode_record(
        {"data": n_data, "model": n_model},
        f"log2T={table_log2} table level-sharded ({table_mb:.0f} MB), N_rand={args2.N_rand}",
        summ, mb, world)
    del ts

    # 3. ZeRO-1: bf16 reduce-scatter of g / N, bf16 all-gather of the
    # parameters, float32 master chunks
    out["data_parallel_zero"] = _zero_record(
        args, scene, layout, device, world, "chair flagship, ZeRO-1: bf16 reduce-scatter grads "
        "+ sharded fp32 masters/moments + bf16 param all-gather")
    return out


def _zero_record(args, scene, layout, device, world: int, config: str = "") -> dict:
    """One ZeRO-1 step's collectives (the rank's record)."""
    from hashnerf_torch.parallel.mesh import reset_collective_counts
    from hashnerf_torch.parallel.train_sharded import (
        init_dp_zero, make_dp_zero_train_step, rank_generator,
    )
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    t = Trainer(args, scene, device=device)
    batch = t.sample_image(0, args.N_rand, False)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, with_tv=False,
                           hwf=scene.hwf)
    master, opt = init_dp_zero(layout, t.state, args)
    step = make_dp_zero_train_step(layout, loss_fn, t.state)
    reset_collective_counts()
    float(step(master, opt, batch, 0.0, rank_generator(0, layout, t.device))["loss"])
    summ, mb = _tally()
    return _mode_record({"data": world}, config, summ, mb, world)


def collective_volumes(world: int, device=None, over=None, table_log2: int = 21,
                       scene_hw: int = 64) -> dict:
    """One step of each mode on `world` ranks; rank 0's {data_parallel, table_sharded,
    data_parallel_zero}, each {mesh, config, collectives_per_step,
    all_reduce_metrics_bytes, total_mb, wire_mb_per_device} and the ranks'
    backend. over: chair_args attributes (tests shrink the widths)."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.parallel.mesh import launch, world_backend

    dev = resolve_device(device)
    backend = world_backend(world, dev)
    out = launch(_volumes_rank, world, dev, (dict(over or {}), table_log2, scene_hw),
                 backend=backend)[0]
    for rec in out.values():
        rec["backend"] = backend
        print(json.dumps(rec), flush=True)
    return out


def _two_host_rank(rank: int, world: int, device, over: dict, hw: int):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh, reset_collective_counts
    from hashnerf_torch.train.driver import Trainer

    scene = make_synthetic_scene(H=hw, W=hw, n_train=4, n_test=1)
    args = flagship_args(**over)
    layout = make_mesh(world)
    zero = _zero_record(args, scene, layout, device, world)
    # the replicated data-parallel step at the same shape: the wire ZeRO-1 saves
    t = Trainer(args, scene, device=device, layout=layout)
    reset_collective_counts()
    float(t.step(t.sample_image(0, args.N_rand, False))["loss"])
    summ, mb = _tally()
    return {"zero": zero, "replicated": _mode_record({"data": world}, "", summ, mb, world)}


def flagship_step_ms(device=None, blocks: int = 4, hw: int = 128) -> float:
    """ms a step of the flagship (the tpu-fast preset: packed L4 / F8,
    block-8 culling at its last budgets, graphed blocks of 16 on the card)
    on the procedural scene: from step 1024, after 32 steps fill the grid
    (warmup 16), `blocks` blocks timed by the host clock closed by a
    synchronize, after one that captures."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    dev = resolve_device(device)
    args = parse_args(["--preset", "tpu-fast", "--N_rand", "1024", "--N_samples", "64",
                       "--N_importance", "128", "--finest_res", "512",
                       "--log2_hashmap_size", "19", "--lrate", "0.01", "--lrate_decay", "10",
                       "--use_viewdirs", "--white_bkgd", "--occ_warmup", "16",
                       "--device", str(dev)])
    t = Trainer(args, make_synthetic_scene(H=hw, W=hw, n_train=8, n_test=1), device=dev)
    float(t.run_steps(32)["loss"])
    t.global_step = 1024
    b = args.steps_per_dispatch
    float(t.run_steps(b)["loss"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    float(t.run_steps(blocks * b)["loss"])
    sync()
    return (time.perf_counter() - t0) * 1e3 / (blocks * b)


def projection(wire: float, step_ms_points, bw_grid_gbps=(6.25, 12.5, 25, 50, 100)):
    """JAX's two-host table (:420-445): for each step time and DCN
    bandwidth (GB/s a host), the wire's ms (wire MB / bandwidth) and the
    weak-scaling efficiency with no overlap, step / (step + wire), and with
    full overlap, step / max(step, wire); and the bandwidth each step time
    needs for 85% under each. Rounded as JAX rounds them."""
    rows = []
    for name, step_ms in step_ms_points.items():
        for bw in bw_grid_gbps:
            t_wire = wire / bw
            rows.append({
                "step": name,
                "step_ms": step_ms,
                "dcn_gbps_per_host": bw,
                "wire_ms": round(t_wire, 2),
                "eff_no_overlap": round(step_ms / (step_ms + t_wire), 3),
                "eff_full_overlap": round(step_ms / max(step_ms, t_wire), 3),
            })
    need = {name: {"gbps_for_85pct_no_overlap": round(wire / (step_ms * (1 / 0.85 - 1)), 1),
                   "gbps_for_85pct_full_overlap": round(wire / step_ms, 1)}
            for name, step_ms in step_ms_points.items()}
    return rows, need


def project_two_host(step_ms_points=None, device=None, bw_grid_gbps=(6.25, 12.5, 25, 50, 100),
                     over=None, scene_hw: int = 64) -> dict:
    """The two-host weak-scaling projection: the ZeRO-1 step's collectives
    at the flagship's shape on two ranks (each host one rank), against
    step_ms_points {name: ms} of the card (the flagship's graphed step
    measured here when None), beside the replicated step's wire."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.parallel.mesh import launch, world_backend

    dev = resolve_device(device)
    if step_ms_points is None:
        step_ms_points = {"flagship_graphed_1024": flagship_step_ms(dev)}
    backend = world_backend(2, dev)
    res = launch(_two_host_rank, 2, dev, (dict(over or {}), scene_hw), backend=backend)[0]
    wire = res["zero"]["wire_mb_per_device"]
    rows, need = projection(wire, step_ms_points, bw_grid_gbps)
    return {
        "model": "2-host weak scaling (per-host batch fixed): ZeRO-1 bf16 wire vs the "
                 "card's measured single-card step time; occupancy culling does not change "
                 "the collective payload (params/grads only)",
        "param_shape": "flagship packed L4/F8 log2T=19 finest=512 shared net",
        "backend": backend,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "zero1_collectives_2dev": res["zero"]["collectives_per_step"],
        "zero1_all_reduce_metrics_bytes": res["zero"]["all_reduce_metrics_bytes"],
        "zero1_wire_mb_per_host": wire,
        "replicated_dp_collectives_2dev": res["replicated"]["collectives_per_step"],
        "replicated_dp_wire_mb_per_host": res["replicated"]["wire_mb_per_device"],
        "step_ms_points": step_ms_points,
        "projection": rows,
        "dcn_gbps_needed_for_85pct": need,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", required=True, help="the record's JSON file")
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    ap.add_argument("--n_rand", type=int, default=4096)
    ap.add_argument("--n_iters", type=int, default=10)
    ap.add_argument("--skip-volumes", action="store_true")
    o = ap.parse_args()
    res = {"timing": measure(o.worlds, o.device, o.n_rand, o.n_iters)}
    if not o.skip_volumes:
        res["collective_volumes"] = collective_volumes(max(o.worlds), o.device)
    res["projected_2host"] = project_two_host(device=o.device)
    with open(o.json_out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"# wrote {o.json_out}")

"""Data-parallel scaling: train rays/s at each world size of a list.

Counterpart of hashnerf_tpu/tools/bench_scaling.py::measure. Each world size
runs as that many ranks (parallel/mesh.py::launch: NCCL with a card a rank
on CUDA, gloo on the CPU); each rank's Trainer (timing_args: the JAX
tool's shapes and learning rate) takes its rows of one fixed
global batch of n_rand rays for a warm-up step and n_iters timed steps
(host clock, closed by a synchronize on the card). On the CPU the ranks
share the host's cores: those rates say nothing of a device. The JAX
tool's HLO collective summaries and its TPU AOT topology check are XLA's
own and are not ported (ROADMAP A9).

    python -m hashnerf_torch.tools.bench_scaling [--worlds 1 2] [--device cpu|cuda]
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


def measure(worlds, device="cpu", n_rand=4096, n_iters=10, n_samples=16, n_importance=32):
    """[{devices, device, step_ms, rays_per_s, scaling_efficiency}] for each
    world size in worlds (n_rand divisible by each); a world larger than
    the cards present under NCCL is skipped."""
    from hashnerf_torch.parallel.mesh import launch

    dev = torch.device(device)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    results, base = [], None
    for n in worlds:
        if dev.type == "cuda" and n > torch.cuda.device_count():
            print(f"# skipping {n} ranks ({torch.cuda.device_count()} cards)", flush=True)
            continue
        dt = max(launch(_rank, n, device, (n_rand, n_iters, n_samples, n_importance)))
        rate = n_rand / dt
        base = base or rate / n
        results.append({"devices": n, "device": name, "step_ms": dt * 1e3, "rays_per_s": rate,
                        "scaling_efficiency": rate / (base * n)})
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--n_rand", type=int, default=4096)
    ap.add_argument("--n_iters", type=int, default=10)
    ap.add_argument("--json-out", default=None)
    o = ap.parse_args()
    res = measure(o.worlds, o.device, o.n_rand, o.n_iters)
    if o.json_out:
        with open(o.json_out, "w") as f:
            json.dump(res, f, indent=1)

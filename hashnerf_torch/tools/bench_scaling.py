"""Data-parallel scaling: train rays/s at each world size of a list.

Counterpart of hashnerf_tpu/tools/bench_scaling.py::measure. Each world size
runs as that many ranks (parallel/mesh.py::launch: NCCL with a card a rank
on CUDA, gloo on the CPU); each rank's Trainer takes its rows of one fixed
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
import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(rank: int, world: int, device, n_rand: int, n_iters: int, n_samples: int,
          n_importance: int):
    import torch.distributed as dist

    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    args = parse_args(["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt"),
                       "--N_rand", str(n_rand), "--N_samples", str(n_samples),
                       "--N_importance", str(n_importance), "--num_devices", str(world),
                       "--tv-loss-weight", "0"])
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

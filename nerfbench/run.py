"""Run one cell of the benchmark once.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last `compared`: each number the correctness check compared, beside its
limit (also the last lines of standard error). Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), or
when a module of the JAX stack or the JAX package is loaded.
"""
from __future__ import annotations

import os
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
# Every cache the run may write sits at a fixed path inside the checkout.
# The port's kernels build into hashnerf_torch/build/ (by source hash).
for _var, _sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(HERE, ".cache", _sub)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from nerfbench import guard, spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="nerfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_state() -> str:
    """The card's name, power limit, SM clock, temperature and power draw."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu,"
                              "power.draw", "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg, tr = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    lim = spec.limits(cell["name"])
    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nerfbench: {cell['name']} needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr, flush=True)
        return 2
    guard.check("before set-up")
    print(f"nerfbench: {cell['name']} seed {args.seed} on {card_state()}", file=sys.stderr, flush=True)
    from nerfbench.harness import run_cell

    per_layer = spec.metrics_for(bench, cell["name"], "per_layer")
    out = run_cell(cell, cfg, tr, lim, args.seed, args.seconds, bool(args.trace), "cuda",
                   per_layer, t_origin=T0)
    guard.check("after the window")
    print(f"nerfbench: after the run: {card_state()}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

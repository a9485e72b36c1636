"""Benchmark of the port: training rays/s on the chair-like configuration.

    python -m hashnerf_torch.bench

Counterpart of the repo's bench.py (the JAX package's bench line). Prints
ONE JSON line, {"metric": "train_rays_per_s", "value", "unit",
"vs_baseline"}, with vs_baseline over 8533 rays/s: the reference's GTX
1050Ti, 5k iterations of 1024 rays in about 10 minutes.

The configuration and the knobs are bench.py's: the chair's widths (N_rand
1024, 64 + 128 samples, finest resolution 512, 2^19 rows) on the procedural
scene (128 x 128, 8 train views), from global_step 1001 (past the TV
window, as 98% of a run is). By default the flagship execution set (L4/F8
packed tables, one shared net, bf16 MLPs, bbox clip, block-8 occupancy
culling at keep 0.125 fine / 0.375 coarse, adaptive grid updates, warmup
8); BENCH_PARITY=1 the reference-exact step. BENCH_BLOCK steps a block
(default 256, 16 with BENCH_PARITY), BENCH_REPS timed blocks (2),
BENCH_N_RAND, BENCH_L, BENCH_F, BENCH_KEEP, BENCH_KEEP_COARSE,
BENCH_FASTMERGE, BENCH_PARTITION, BENCH_PERRAY, BENCH_OCC_BLOCK,
BENCH_SELECT, BENCH_ADAPTIVE, BENCH_SCORE_STRIDE, BENCH_PACKED.

With occupancy on, 32 steps populate the grid and readiness is then forced
(throughput depends on the keep budget, not on the grid's contents). The
value is the median over BENCH_REPS of Trainer.run_steps(block), each
closed by a host read of the loss, after one untimed block (which captures
the CUDA graphs). Unlike bench.py, nothing degrades: a block that fails
raises, and the process exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Mapping

BASELINE_RAYS_PER_S = 5000 * 1024 / 600.0  # the 1050Ti reference, about 8533 rays/s


def bench_args(env: Mapping[str, str]):
    """The port's args for bench.py's configuration under the knobs in env."""
    from hashnerf_torch.train.config import config_parser

    args = config_parser().parse_args([])
    args.N_rand = int(env.get("BENCH_N_RAND", "1024"))
    args.N_samples = 64
    args.N_importance = 128
    args.finest_res = 512
    args.log2_hashmap_size = 19
    args.lrate = 0.01
    args.lrate_decay = 10
    args.use_viewdirs = True
    args.white_bkgd = True
    args.no_batching = True
    if not env.get("BENCH_PARITY"):
        args.n_levels = int(env.get("BENCH_L", "4"))
        args.n_features_per_level = int(env.get("BENCH_F", "8"))
        args.share_fine = True
        args.compute_dtype = "bfloat16"
        args.use_occupancy = True
        args.occ_keep_fraction = float(env.get("BENCH_KEEP", "0.125"))
        args.occ_warmup = 8
        args.aabb_clip = True
        args.fast_merge = bool(int(env.get("BENCH_FASTMERGE", "0")))
        args.occ_partition = env.get("BENCH_PARTITION", "sort1")
        args.occ_per_ray = bool(int(env.get("BENCH_PERRAY", "0")))
        args.occ_block = int(env.get("BENCH_OCC_BLOCK", "8"))
        kc = float(env.get("BENCH_KEEP_COARSE", "0.375"))
        if kc > 0:
            args.occ_keep_coarse = kc
        args.occ_per_ray_select = env.get("BENCH_SELECT", "sort")
        args.occ_adaptive_update = bool(int(env.get("BENCH_ADAPTIVE", "1")))
        args.occ_score_stride = int(env.get("BENCH_SCORE_STRIDE", "1"))
        args.packed_layout = bool(int(env.get("BENCH_PACKED", "1")))
    return args


def measure(trainer, block: int, reps: int) -> float:
    """Median rays/s of `reps` timed run_steps(block) calls, each closed by
    a host read, after one untimed call."""
    float(trainer.run_steps(block, block_size=block)["loss"])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(trainer.run_steps(block, block_size=block)["loss"])
        ts.append(time.perf_counter() - t0)
    return block * trainer.args.N_rand / statistics.median(ts)


def run(env: Mapping[str, str]) -> dict:
    """Build the trainer, populate the grid, time the blocks; returns the
    JSON line's dict."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.driver import Trainer

    args = bench_args(env)
    trainer = Trainer(args, make_synthetic_scene(H=128, W=128, n_train=8, n_test=2))
    trainer.global_step = 1001
    if trainer.render_cfg.occupancy is not None:
        float(trainer.run_steps(32, block_size=32)["loss"])
        trainer._occ_ready = True
    block = int(env.get("BENCH_BLOCK", "16" if env.get("BENCH_PARITY") else "256"))
    rays_per_s = measure(trainer, block, int(env.get("BENCH_REPS", "2")))
    return {
        "metric": "train_rays_per_s",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 2),
    }


def main() -> int:
    print(json.dumps(run(os.environ)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

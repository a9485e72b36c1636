"""Quality benchmark: test PSNR against iterations on the procedural scene.

Counterpart of the root bench_quality.py, its knobs, curve and result kept:
the chair hyperparameters (finest_res 512, log2 T 19, lr 0.01, decay 10,
N_rand 1024, 64 + 128 samples, viewdirs, white_bkgd) on
make_synthetic_scene (128 x 128; QB_VIEWS train, QB_NTEST test views,
QB_SCENE), trained in run_steps blocks of QB_BLOCK with the test set
rendered after each; the curve, iters_to_psnr30 (linear between curve
points) and the steady step time (median ms a step over the blocks that
captured no new CUDA graph; under a keep schedule, over the last third of
the blocks). Every timed block ends in a synchronize of the card.

Env: QB_ITERS (1536), QB_BLOCK (128), QB_CHUNK (4096), QB_VIEWS (64),
QB_NTEST (2), QB_SCENE (sphere), QB_SEED (0), QB_EVALCULL, QB_TAG, and
QB_PARITY=1 for the reference-exact step (float32, L16/F2, a fine net, no
culling); otherwise the execution knobs QB_L, QB_F, QB_SHARE, QB_DTYPE,
QB_OCC, QB_KEEP, QB_AABB, QB_NRAND, QB_PACKED, QB_FASTMERGE, QB_PARTITION,
QB_ADAPTIVE, QB_PERRAY, QB_KEEP_COARSE, QB_SELECT, QB_OCCBLOCK,
QB_UPDATE_EVERY, QB_SCORE_STRIDE, QB_KEEP_SCHEDULE (occ_warmup 64).
A failing block raises. Runs on the card unless QB_DEVICE (or --device)
names another. The curve is written to --json-out, or QB_OUT: one of them
is required; it prints the result without the curve as one JSON line.

    QB_ITERS=256 python -m hashnerf_torch.bench_quality --json-out OUT.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Mapping, Optional


def quality_args(env: Mapping[str, str], device: str):
    """The Trainer's arguments under the knobs of env."""
    from hashnerf_torch.train.config import config_parser

    args = config_parser().parse_args(["--device", device])
    args.N_rand = 1024
    args.N_samples = 64
    args.N_importance = 128
    args.finest_res = 512
    args.log2_hashmap_size = 19
    args.lrate = 0.01
    args.lrate_decay = 10
    args.use_viewdirs = True
    args.white_bkgd = True
    args.no_batching = True
    if not env.get("QB_PARITY"):
        args.n_levels = int(env.get("QB_L", "4"))
        args.n_features_per_level = int(env.get("QB_F", "8"))
        args.share_fine = bool(int(env.get("QB_SHARE", "1")))
        args.compute_dtype = env.get("QB_DTYPE", "bfloat16")
        if args.compute_dtype in ("", "float32", "none"):
            args.compute_dtype = None
        args.use_occupancy = bool(int(env.get("QB_OCC", "1")))
        args.occ_keep_fraction = float(env.get("QB_KEEP", "0.25"))
        args.occ_warmup = 64
        args.aabb_clip = bool(int(env.get("QB_AABB", "0")))
        args.N_rand = int(env.get("QB_NRAND", str(args.N_rand)))
        args.packed_layout = bool(int(env.get("QB_PACKED", "0")))
        args.fast_merge = bool(int(env.get("QB_FASTMERGE", "0")))
        args.occ_partition = env.get("QB_PARTITION", "sort1")
        args.occ_adaptive_update = bool(int(env.get("QB_ADAPTIVE", "0")))
        args.occ_per_ray = bool(int(env.get("QB_PERRAY", "0")))
        args.occ_keep_coarse = float(env.get("QB_KEEP_COARSE", "-1"))
        args.occ_per_ray_select = env.get("QB_SELECT", "sort")
        args.occ_block = int(env.get("QB_OCCBLOCK", "1"))
        args.occ_update_every = int(env.get("QB_UPDATE_EVERY", "16"))
        args.occ_score_stride = int(env.get("QB_SCORE_STRIDE", "1"))
        sched = env.get("QB_KEEP_SCHEDULE", "")
        if sched:
            args.occ_keep_schedule = sched
    # 4096 rays a render chunk keeps the eval's memory small in every mode
    args.chunk = int(env.get("QB_CHUNK", "4096"))
    return args


def iters_to(curve, db: float = 30.0) -> Optional[int]:
    """The first iteration the curve reaches db at, linear between its
    points (the first point itself when it is already there); None if
    never."""
    prev = None
    for pt in curve:
        if pt["test_psnr"] >= db:
            if prev is None:
                return pt["iter"]
            f = (db - prev["test_psnr"]) / (pt["test_psnr"] - prev["test_psnr"])
            return round(prev["iter"] + f * (pt["iter"] - prev["iter"]))
        prev = pt
    return None


def run(env: Mapping[str, str], device=None, scene_hw: int = 128, overrides=None) -> dict:
    """The curve and result under env's knobs. overrides: args attributes
    set after the knobs (tests shrink the widths with them)."""
    import numpy as np
    import torch

    from hashnerf_torch import resolve_device
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.driver import Trainer

    dev = resolve_device(device)
    args = quality_args(env, str(dev))
    for k, v in (overrides or {}).items():
        setattr(args, k, v)
    n_iters = int(env.get("QB_ITERS", "1536"))
    block = int(env.get("QB_BLOCK", "128"))
    scene_kind = env.get("QB_SCENE", "sphere")
    scene = make_synthetic_scene(H=scene_hw, W=scene_hw, n_train=int(env.get("QB_VIEWS", "64")),
                                 n_test=int(env.get("QB_NTEST", "2")), scene=scene_kind)
    seed = int(env.get("QB_SEED", "0"))
    trainer = Trainer(args, scene, device=dev, seed=seed)
    trainer.eval_cull = bool(int(env.get("QB_EVALCULL", "0")))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def n_graphs():
        return 0 if trainer._graphs is None else len(trainer._graphs.graphs)

    curve, block_times = [], []  # block_times: (steps, seconds, captured a graph)
    t0 = time.perf_counter()
    train_s, done = 0.0, 0
    while done < n_iters:
        b = min(block, n_iters - done)
        before = n_graphs()
        sync()
        tb = time.perf_counter()
        m = trainer.run_steps(b, block_size=b)
        float(m["loss"])
        sync()
        dt = time.perf_counter() - tb
        block_times.append((b, dt, n_graphs() > before))
        train_s += dt
        done = trainer.global_step
        _, _, psnrs = trainer.render_test_path(scene.poses[scene.i_test],
                                               gt_imgs=scene.images[scene.i_test])
        curve.append({"iter": done, "test_psnr": float(np.mean(psnrs)),
                      "train_psnr": float(m["psnr"]), "wall_s": time.perf_counter() - t0,
                      "train_s": train_s})
        print(f"# iter {done}: test PSNR {curve[-1]['test_psnr']:.2f}", file=sys.stderr)

    # under an annealed keep schedule only the last third of the blocks
    # runs the final budget
    window = (block_times[-max(1, len(block_times) // 3):] if args.occ_keep_schedule
              else block_times)
    steady = sorted(dt / b for b, dt, fresh in window if not fresh)
    if not steady:
        steady = sorted(dt / b for b, dt, fresh in block_times if not fresh)
    steady_step_s = steady[len(steady) // 2] if steady else None

    tag = env.get("QB_TAG", "")
    return {
        "metric": "test_psnr_at_%d" % n_iters,
        "value": curve[-1]["test_psnr"],
        "unit": "dB",
        "iters_to_psnr30": iters_to(curve, 30.0),
        "wall_s": curve[-1]["wall_s"],
        "train_s": curve[-1]["train_s"],
        "steady_step_ms": steady_step_s * 1e3 if steady_step_s else None,
        "steady_rays_per_s": args.N_rand / steady_step_s if steady_step_s else None,
        "mode": tag or ("parity" if env.get("QB_PARITY") else "tpu-fast"),
        "seed": seed,
        "N_rand": args.N_rand,
        "scene": scene_kind,
        "packed": bool(args.packed_layout),
        "knobs": {
            "keep": args.occ_keep_fraction,
            "keep_schedule": args.occ_keep_schedule,
            "partition": args.occ_partition,
            "adaptive_update": args.occ_adaptive_update,
            "fast_merge": args.fast_merge,
            "aabb": args.aabb_clip,
            "per_ray": args.occ_per_ray,
            "keep_coarse": args.occ_keep_coarse,
            "select": args.occ_per_ray_select,
            "occ_block": args.occ_block,
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "block_times": block_times,
        "curve": curve,
    }


def main(argv=None, env: Optional[Mapping[str, str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None, help="the result's JSON file (else QB_OUT)")
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default; else QB_DEVICE)")
    a = ap.parse_args(argv)
    env = os.environ if env is None else env
    out = a.json_out or env.get("QB_OUT")
    if not out:
        raise SystemExit("bench_quality: give --json-out or QB_OUT (it writes nowhere else)")
    result = run(env, a.device or env.get("QB_DEVICE"))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("curve", "block_times")}))
    return result


if __name__ == "__main__":
    main()

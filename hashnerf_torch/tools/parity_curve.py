"""Convergence against the PyTorch reference: test PSNR every 64 iterations.

Counterpart of hashnerf_tpu/tools/parity_curve.py, its protocol kept: a
procedural "sphere" set in the blender layout (100 x 100, 24 train / 2
test views, tools/make_blender_dataset.py), the shared hyperparameters HP
(N_rand 256, 64 + 128 samples, L16 / F2, log2 T 15, finest_res 256, lr
0.01, decay 10, white_bkgd, viewdirs, no precrop), the test-set PSNR every
MILESTONE iterations to PARITY_ITERS (640). Stages:

  dataset DATA                     write the set into DATA
  ours DATA OUT.json [--seed N]    the port's reference-exact step (float32,
                                   per-corner hash, a fine net, no culling)
                                   on the card unless --device names
                                   another; seed PARITY_SEED by default
  merge OUT.json --ref R.json... --ours O.json...
                                   the gate against recorded reference
                                   curves (read only: the repo's
                                   PARITY_CURVE_ref*.json): at every common
                                   milestone the mean over seeds of ours at
                                   least the reference's less max(0.3 dB,
                                   the cross-seed spread)
  reference                        the PyTorch reference's own loop: it
                                   cannot run here (its checkout is not in
                                   the repo), so this stage raises

    python -m hashnerf_torch.tools.parity_curve dataset DIR
    python -m hashnerf_torch.tools.parity_curve ours DIR OUT.json --seed 0
    python -m hashnerf_torch.tools.parity_curve merge OUT.json --ref PARITY_CURVE_ref*.json --ours OURS*.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

import numpy as np

N_ITERS = int(os.environ.get("PARITY_ITERS", "640"))
MILESTONE = 64
HW = 100

# the shared hyperparameters (the reference's configs/chair.txt at a tiny
# size; precrop off on both sides so that the ray sampling coincides)
HP = dict(
    N_rand=256, N_samples=64, N_importance=128, lrate=0.01, lrate_decay=10,
    finest_res=256, log2_hashmap_size=15, white_bkgd=True, use_viewdirs=True,
    no_batching=True, precrop_iters=0, testskip=1, chunk=4096,
)
DATASET_ARGS = ["--hw", str(HW), "--n_train", "24", "--n_val", "1", "--n_test", "2",
                "--scene", "sphere", "--ss", "2"]
GATE = ("mean-over-seeds ours >= mean-over-seeds reference within max(0.3 dB, "
        "cross-seed spread) at every milestone")


def make_dataset(data: str) -> str:
    from hashnerf_torch.tools.make_blender_dataset import main as make_main

    if os.path.exists(os.path.join(data, "transforms_train.json")):
        print(f"dataset already at {data}")
        return data
    make_main([data] + DATASET_ARGS)
    return data


def run_reference():
    raise RuntimeError(
        "parity_curve reference: the PyTorch reference's checkout is not part of this repo, "
        "so its loop cannot run; merge reads its recorded curves (PARITY_CURVE_ref*.json)")


def parity_args(data: str, device: str):
    from hashnerf_torch.train.config import config_parser

    args = config_parser().parse_args(["--device", device])
    for k, v in HP.items():
        setattr(args, k, v)
    args.dataset_type = "blender"
    args.datadir = data
    # the reference-exact step: float32, the 16 x 2 per-corner table, a
    # fine net, no culling, no packing
    args.n_levels = 16
    args.n_features_per_level = 2
    args.compute_dtype = None
    args.share_fine = False
    args.use_occupancy = False
    args.packed_layout = False
    args.aabb_clip = False
    return args


def run_ours(data: str, out: str, seed: int = None, device=None, n_iters: int = None,
             overrides=None) -> dict:
    """Train the port on the set; write its curve to out. overrides: args
    attributes set after the protocol's (tests shrink the widths)."""
    import torch

    from hashnerf_torch import resolve_device
    from hashnerf_torch.data import load_scene
    from hashnerf_torch.train.driver import Trainer

    seed = int(os.environ.get("PARITY_SEED", "0")) if seed is None else seed
    n_iters = N_ITERS if n_iters is None else n_iters
    dev = resolve_device(device)
    args = parity_args(data, str(dev))
    for k, v in (overrides or {}).items():
        setattr(args, k, v)
    scene = load_scene("blender", data, args)
    trainer = Trainer(args, scene, device=dev, seed=seed)

    curve, done = [], 0
    t0 = time.perf_counter()
    while done < n_iters:
        m = trainer.run_steps(MILESTONE, block_size=MILESTONE)
        float(m["loss"])
        done = trainer.global_step
        _, _, psnrs = trainer.render_test_path(scene.poses[scene.i_test],
                                               gt_imgs=scene.images[scene.i_test])
        curve.append({"iter": done, "test_psnr": float(np.mean(psnrs)),
                      "train_psnr": float(m["psnr"])})
        print(f"# iter {done}: test PSNR {curve[-1]['test_psnr']:.2f}", file=sys.stderr)
    result = {"framework": "hashnerf_torch-parity",
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
              "seed": seed, "wall_s": time.perf_counter() - t0, "iters": done,
              "curve": curve, "hyperparams": HP}
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"curve": curve}))
    return result


def _collect(paths: Sequence[str]):
    """({iter: [psnr of each file]}, the files' count)."""
    by_iter = {}
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        for pt in d["curve"]:
            by_iter.setdefault(pt["iter"], []).append(pt["test_psnr"])
    return by_iter, len(paths)


def merge(out: str, ref_paths: Sequence[str], ours_paths: Sequence[str]) -> dict:
    """The milestones and the gate of our curves against the reference's;
    wall seconds from the first file of each (its seed 0). Written to out."""
    ref_paths, ours_paths = sorted(ref_paths), sorted(ours_paths)
    with open(ref_paths[0]) as f:
        ref = json.load(f)
    with open(ours_paths[0]) as f:
        ours = json.load(f)
    ref_by, n_ref = _collect(ref_paths)
    ours_by, n_ours = _collect(ours_paths)
    rows = []
    for it in sorted(set(ref_by) & set(ours_by)):
        rv, ov = ref_by[it], ours_by[it]
        spread = max(max(rv) - min(rv) if len(rv) > 1 else 0.0,
                     max(ov) - min(ov) if len(ov) > 1 else 0.0)
        rows.append({
            "iter": it,
            "reference_mean_psnr": round(float(np.mean(rv)), 2),
            "ours_mean_psnr": round(float(np.mean(ov)), 2),
            "seed_spread_db": round(spread, 2),
            "n_seeds": [len(rv), len(ov)],
            "delta_db": round(float(np.mean(ov)) - float(np.mean(rv)), 2),
        })
    deltas = [r["delta_db"] for r in rows]
    # a deficit must lie within the larger of the 0.3 dB noise band and the
    # cross-seed spread at that milestone
    ok = all(r["delta_db"] >= -max(0.3, r["seed_spread_db"]) for r in rows)
    result = {
        "protocol": {
            "scene": f"procedural sphere, blender on-disk format, {HW}x{HW}, "
                     "24 train / 2 test views",
            "hyperparams": HP,
            "milestones": f"every {MILESTONE} iters to {max(ours_by) if ours_by else 0}",
            "reference_loop": "the PyTorch reference's run_nerf.py loop, recorded "
                              f"({', '.join(os.path.basename(p) for p in ref_paths)})",
            "ours": "parity config (fp32, L16/F2 per-corner hash, separate fine net, no "
                    f"culling) on {ours.get('device', ours.get('backend', '?'))}",
            "n_seeds": {"reference": n_ref, "ours": n_ours},
        },
        "milestones": rows,
        "min_delta_db": min(deltas) if deltas else None,
        "mean_delta_db": round(float(np.mean(deltas)), 2) if deltas else None,
        "final": rows[-1] if rows else None,
        "gate": GATE,
        "gate_pass": bool(deltas) and ok,
        "reference_wall_s": ref["wall_s"],
        "ours_wall_s": ours["wall_s"],
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("milestones", "protocol")}))
    for r in rows:
        print(f"iter {r['iter']:4d}: ref {r['reference_mean_psnr']:6.2f} "
              f"ours {r['ours_mean_psnr']:6.2f}±{r['seed_spread_db'] / 2:.2f}  "
              f"Δ {r['delta_db']:+.2f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="stage", required=True)
    p = sub.add_parser("dataset")
    p.add_argument("data")
    p = sub.add_parser("ours")
    p.add_argument("data")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    p = sub.add_parser("merge")
    p.add_argument("out")
    p.add_argument("--ref", nargs="+", required=True)
    p.add_argument("--ours", nargs="+", required=True)
    sub.add_parser("reference")
    a = ap.parse_args(argv)
    if a.stage == "dataset":
        return make_dataset(a.data)
    if a.stage == "ours":
        return run_ours(a.data, a.out, a.seed, a.device)
    if a.stage == "merge":
        return merge(a.out, a.ref, a.ours)
    return run_reference()


if __name__ == "__main__":
    main()

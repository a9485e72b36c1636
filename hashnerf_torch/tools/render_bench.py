"""Full-scale train and render on a blender-format set (800 x 800 frames).

Counterpart of hashnerf_tpu/tools/render_bench.py, its protocol kept: the
blender loader (testskip 8, white_bkgd) → the tpu-fast preset with the JAX
tool's flags (N_rand 1024, 64 + 128 samples, finest_res 512, log2 T 19,
lr 0.01, decay 10, fast_merge, adaptive grid updates, occ_warmup 64) →
training in run_steps blocks of 128 steps → a full-frame render_image of
each of the first `frames` test views (frame 0, which pays the first
render's set-up, out of the median) → the --eval-keeps sweep, each budget
set through dataclasses.replace of the occupancy config and held against
the exact renders. Every timed region ends in a synchronize of the card.
Runs on the card unless --device names another; --json-out is required
(the keys of RENDER_r05.json, unrounded, and the card's name).

    python -m hashnerf_torch.tools.render_bench --datadir DIR --json-out OUT.json
        [--iters 500] [--frames 8] [--chunk 16384] [--half_res]
        [--eval-keeps 0.75,0.5,0.375]

The set comes from tools/make_blender_dataset.py (JAX's used
`make_blender_dataset datasets/proc_multi_800 --hw 800 --scene multi`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


BLOCK = 128  # training steps a run_steps call
OCC_WARMUP = 64
TESTSKIP = 8


def bench_argv(datadir: str, chunk: int, device: str):
    return ["--preset", "tpu-fast", "--dataset_type", "blender", "--datadir", datadir,
            "--expname", "render_bench", "--no_batching", "--white_bkgd",
            "--N_rand", "1024", "--N_samples", "64", "--N_importance", "128",
            "--finest_res", "512", "--log2_hashmap_size", "19",
            "--lrate", "0.01", "--lrate_decay", "10", "--fast_merge", "--occ_adaptive_update",
            "--chunk", str(chunk), "--device", device]


def parse_keeps(text: str):
    """[(keep_coarse or None, keep, transmittance)] of "0.5" (both passes),
    "coarse:fine" and a leading "t" (transmittance-weighted) items."""
    keeps = []
    for s in (text or "").split(","):
        s = s.strip()
        if not s:
            continue
        trans = s.startswith("t")
        if trans:
            s = s[1:]
        if ":" in s:
            c, f = s.split(":")
            keeps.append((float(c), float(f), trans))
        else:
            keeps.append((None, float(s), trans))
    return keeps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _psnr(a: np.ndarray, b: np.ndarray, eps: float = 0.0) -> float:
    return float(-10.0 * np.log10(np.mean(np.square(a - b)) + eps))


def run(datadir: str, iters: int = 500, frames: int = 8, chunk: int = 16384,
        half_res: bool = False, eval_keeps: str = "0.75,0.5,0.375", device=None,
        overrides=None) -> dict:
    """The measurement; returns the record. overrides: args attributes set
    after the protocol's (tests shrink the widths)."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.data.blender import load_blender_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    dev = resolve_device(device)
    t0 = time.perf_counter()
    scene = load_blender_scene(datadir, half_res=half_res, testskip=TESTSKIP, white_bkgd=True)
    print(f"# loaded {scene.images.shape} in {time.perf_counter() - t0:.1f}s "
          f"(train {len(scene.i_train)}, test {len(scene.i_test)})", flush=True)
    args = parse_args(bench_argv(datadir, chunk, str(dev)))
    args.occ_warmup = OCC_WARMUP
    for k, v in (overrides or {}).items():
        setattr(args, k, v)
    trainer = Trainer(args, scene, device=dev)

    # training: blocks of BLOCK steps (the first of each plan pays its
    # captures: the best block is the steady rate)
    done, rates = 0, []
    while done < iters:
        b = min(BLOCK, iters - done)
        _sync(dev)
        tb = time.perf_counter()
        m = trainer.run_steps(b, block_size=b)
        loss = float(m["loss"])
        _sync(dev)
        dt = time.perf_counter() - tb
        rates.append(b * args.N_rand / dt)
        done = trainer.global_step
        print(f"# iter {done}: loss {loss:.4f} ({rates[-1]:.0f} rays/s incl. capture)", flush=True)

    H, W = scene.H, scene.W
    test = [int(i) for i in list(scene.i_test)[:min(frames, len(scene.i_test))]]

    def render_views(what: str):
        """[(rgb, seconds)] of each test view."""
        out = []
        for j, idx in enumerate(test):
            _sync(dev)
            tf = time.perf_counter()
            rgb = trainer.render_image(scene.poses[idx])[0].cpu().numpy()
            dt = time.perf_counter() - tf
            out.append((rgb, dt))
            print(f"# {what} frame {j} ({H}x{W}): {dt:.3f}s", flush=True)
        return out

    exact = render_views("exact")
    psnrs = [_psnr(rgb, np.asarray(scene.images[idx])) for (rgb, _), idx in zip(exact, test)]
    frame_s = [dt for _, dt in exact[1:]]

    sweep = []
    keeps = parse_keeps(eval_keeps)
    if keeps and trainer.render_cfg.occupancy is not None:
        base_cfg = trainer.render_cfg
        try:
            for keep_c, keep, trans in keeps:
                trainer.render_cfg = dataclasses.replace(base_cfg, occupancy=dataclasses.replace(
                    base_cfg.occupancy, keep_fraction_eval=keep,
                    keep_fraction_eval_coarse=keep_c, eval_transmittance=trans))
                views = render_views(f"keep {keep}")
                k_gt = [_psnr(rgb, np.asarray(scene.images[idx]))
                        for (rgb, _), idx in zip(views, test)]
                k_vs = [_psnr(rgb, ref, 1e-12) for (rgb, _), (ref, _) in zip(views, exact)]
                k_s = [dt for _, dt in views[1:]]
                spf = float(np.median(k_s)) if k_s else None
                row = {"keep_eval": keep, "keep_eval_coarse": keep_c, "transmittance": trans,
                       "seconds_per_frame": spf,
                       "eval_rays_per_s": H * W / spf if spf else None,
                       "test_psnr": float(np.mean(k_gt)),
                       "psnr_delta_vs_exact_db": float(np.mean(k_gt)) - float(np.mean(psnrs)),
                       "psnr_of_delta_image": float(np.mean(k_vs))}
                sweep.append(row)
                print(f"# keep_eval={keep}: {row}", flush=True)
        finally:
            trainer.render_cfg = base_cfg

    spf = float(np.median(frame_s)) if frame_s else None
    out = {
        "metric": "render_frames_per_s",
        "H": H, "W": W,
        "rays_per_frame": H * W,
        "value": 1.0 / spf if spf else None,
        "unit": "frames/s",
        "seconds_per_frame": spf,
        "eval_rays_per_s": H * W / spf if spf else None,
        "first_frame_s_incl_compile": exact[0][1] if exact else None,
        "train_iters": iters,
        "train_rays_per_s_best_block": max(rates),
        f"test_psnr_at_{iters}": float(np.mean(psnrs)),
        "chunk": chunk,
        "dataset": os.path.basename(os.path.normpath(datadir)),
        "n_train_views": int(len(scene.i_train)),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "train_block_rays_per_s": rates,
        "frame_s": [dt for _, dt in exact],
    }
    if sweep:
        out["eval_keep_sweep"] = sweep
        ok = [r for r in sweep if r["psnr_delta_vs_exact_db"] >= -0.05 and r["eval_rays_per_s"]]
        if ok:
            best = max(ok, key=lambda r: r["eval_rays_per_s"])
            out["eval_accel_chosen"] = best
            out["eval_rays_per_s_accelerated"] = best["eval_rays_per_s"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--json-out", required=True, help="the record's JSON file")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--half_res", action="store_true")
    ap.add_argument("--eval-keeps", default="0.75,0.5,0.375",
                    help="comma list of --occ_keep_eval budgets swept after the exact "
                    "renders ('' skips the sweep)")
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    a = ap.parse_args(argv)
    out = run(a.datadir, a.iters, a.frames, a.chunk, a.half_res, a.eval_keeps, a.device)
    with open(a.json_out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

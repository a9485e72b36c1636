#!/usr/bin/env python3
"""Diagnostics of the PyTorch port on one NVIDIA GPU, beyond chip_smoke.py's
gates. Each prints JSON lines; none is a gate.

    python3 chip_diag.py gate-spread [--path flagship] [--reps 2]
        chip_smoke.py's main path `path`, `reps` times in one process, with
        every gate printed instead of raised: how far the graph-against-
        eager counts of graphed_window spread from run to run.
    python3 chip_diag.py one-step
        One TV step of the flagship (from 256) and of the chair (from 48),
        from one state and generator state: eager three times and as a
        1-step graphed block three times, the loss, each parameter's
        gradient and its value after RAdam compared bit for bit (the
        entries that differ and the largest difference).
    python3 chip_diag.py blender-step
        Device time of the chair's TV step (torch.profiler, 3 steps after 10
        timed ones) on the procedural scene and on a blender set of 8
        frames of 800 x 800 (half_res), twice each in one process.

Imports hashnerf_torch and chip_smoke.py (never jax); exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))


def _chair_trainer(torch, path: str, scene, workdir: str):
    """chip_smoke.py's main-path trainer: configs/chair.txt plus the path's
    flags, 40 steps of train_loop."""
    import chip_smoke as cs
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import train_loop

    args = parse_args(["--config", os.path.join(ROOT, "configs", "chair.txt"),
                       "--dataset_type", "synthetic", "--basedir", workdir, "--no_reload",
                       "--N_iters", "40", "--i_print", "40", "--i_weights", "40",
                       "--i_testset", "0", "--i_video", "0", "--device", "cuda",
                       *cs.PATHS[path]["flags"]])
    return train_loop(args, scene, log_fn=lambda *_: None)


def gate_spread(torch, np, path: str, reps: int) -> None:
    import chip_smoke as cs

    fails = []

    def require(cond, what):
        if not cond:
            fails.append(what)
            print(json.dumps({"gate_failed": what[:3000]}), flush=True)

    cs.require = require
    for rep in range(reps):
        rec = cs.phase_main_path(torch, np, path, False)
        for window in ("tv", "no_tv"):
            print(json.dumps({"rep": rep, "path": path, "window": window,
                              "gate": rec["graphed"][window]["gate"]}), flush=True)
    print(json.dumps({"gates_failed": len(fails)}), flush=True)


def one_step(torch) -> None:
    from hashnerf_torch.data.synthetic import make_synthetic_scene

    for path, start in (("flagship", 256), ("chair", 48)):
        tr = _chair_trainer(torch, path, make_synthetic_scene(H=128, W=128, n_train=8, n_test=2),
                            tempfile.mkdtemp())
        tr.global_step = start
        keep = tr._keep_at(start)[0] if tr.keep_schedule else None
        occ = "cull" if tr.render_cfg.occupancy is not None else None
        snap = [t.detach().clone() for t in tr.training_state()]
        rng, ready = tr.generator.get_state(), tr._occ_ready

        def restore():
            with torch.no_grad():
                for t, s in zip(tr.training_state(), snap):
                    t.copy_(s)
            tr.generator.set_state(rng)
            tr.global_step, tr._occ_ready = start, ready

        def grab(m):
            torch.cuda.synchronize()
            return (float(m["loss"]), [p.grad.detach().clone() for p in tr.state.parameters()],
                    [p.detach().clone() for p in tr.state.parameters()])

        res = {}
        for tag in ("e1", "e2", "e3"):
            restore()
            res[tag] = grab(tr.step(tr.sample_batch(True)))
        restore()
        block = tr._build_block(1, True, occ, True, keep)  # the capture, then a replay
        res["g1"] = grab(block())
        for tag in ("g2", "g3"):
            restore()
            res[tag] = grab(block())
        names = [n for n, _ in tr.state.named_parameters()]
        for a, b in (("e1", "e2"), ("e2", "e3"), ("g1", "g2"), ("g2", "g3"), ("e1", "g1"),
                     ("e2", "g2")):
            out = {"path": path, "pair": f"{a}-{b}", "loss": [res[a][0], res[b][0]]}
            for n, ga, gb, pa, pb in zip(names, res[a][1], res[b][1], res[a][2], res[b][2]):
                dg, dp = (ga - gb).abs(), (pa - pb).abs()
                out[n] = {"grad_ndiff": int((dg > 0).sum()), "grad_max": float(dg.max()),
                          "param_ndiff": int((dp > 0).sum()), "param_max": float(dp.max())}
            print(json.dumps(out), flush=True)
        del tr
        torch.cuda.empty_cache()


def blender_step(torch) -> None:
    import chip_smoke as cs
    from hashnerf_torch.data.blender import load_blender_scene
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.tools.make_blender_dataset import main as make_set

    work = tempfile.mkdtemp()
    data = os.path.join(work, "data")
    make_set([data, "--hw", "800", "--n_train", "8", "--n_val", "0", "--n_test", "1", "--ss", "1"])
    scenes = {"procedural": make_synthetic_scene(H=128, W=128, n_train=8, n_test=2),
              "blender": load_blender_scene(data, True, 1, True)}
    for rep in range(2):
        for name, scene in scenes.items():
            tr = _chair_trainer(torch, "chair", scene, work)
            tr.global_step = 48  # TV on
            ts, _ = cs.timed_steps(torch, tr, 10)
            p = cs.profile_steps(torch, tr, 3, statistics.median(ts))
            print(json.dumps({
                "rep": rep, "scene": name, "bbox": tr.bbox.cpu().tolist(),
                "rays_per_s_tv": tr.args.N_rand / statistics.median(ts),
                "busy_ms": p["device_busy_ms_per_step"], "share": p["device_busy_share"],
                "ops": p["device_ops_per_step"],
                "top": {r["name"][:60]: r["ms_per_step"] for r in p["top"][:12]}}), flush=True)
            del tr
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("gate-spread", "one-step", "blender-step"))
    ap.add_argument("--path", default="flagship", choices=("chair", "packed", "flagship"))
    ap.add_argument("--reps", type=int, default=2)
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hashnerf_torch.kernels import build

    build.build_all()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    if opts.what == "gate-spread":
        gate_spread(torch, np, opts.path, opts.reps)
    elif opts.what == "one-step":
        one_step(torch)
    else:
        blender_step(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Diagnostics of the PyTorch port on one NVIDIA GPU, beyond chip_smoke.py's
gates. Each prints JSON lines; only pool-faults is a gate.

    python3 chip_diag.py gate-spread [--path flagship] [--reps 2]
        chip_smoke.py's main path `path` (chair, packed or flagship), `reps`
        times in one process, or for `--path llff` the llff phase's two
        graphed pool windows `reps` times on one trainer at the llff
        phase's state (configs/fern.txt, 300 steps and 30 timed ones, on
        chip_smoke.llff_set's set), with every gate printed instead of
        raised: how far the graph-against-eager counts of graphed_window
        spread from run to run, and whether each window passes.
    python3 chip_diag.py pool-faults
        On that llff trainer, two faults of the pool blocks planted in turn
        (in this process only): a row offset that never advances, and a
        pool rebound after the capture. The llff window without TV must
        stop each at the graph gate; exits 1 if one passes.
    python3 chip_diag.py spread-why [--reps 2]
        The chair's and llff's eager pairs of one window (16 steps twice
        from one state), `reps` of them: how the table entries the runs
        leave apart grow over the steps, and the fine samples that jump.
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
import shutil
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


def _llff_trainer(torch, np, work: str):
    """The llff phase's trainer and ray pool at the state its graphed
    windows start from: configs/fern.txt trained LLFF_ITERS steps on
    chip_smoke.llff_set's set under `work`, then 10 pool steps with TV and
    20 from step 1001, as phase_llff times them. Returns (trainer, pool,
    the pool row the windows start at)."""
    import chip_smoke as cs
    from hashnerf_torch.data.llff import load_llff_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import train_loop

    data, n = os.path.join(work, "fern"), cs.LLFF_ITERS
    cs.llff_set(np, data)
    args = parse_args(["--config", os.path.join(ROOT, "configs", "fern.txt"), "--datadir", data,
                       "--basedir", work, "--no_reload", "--N_iters", str(n), "--i_print", "20",
                       "--i_weights", str(n), "--i_testset", "0", "--i_video", "0", "--device", "cuda"])
    tr = train_loop(args, load_llff_scene(data, factor=cs.LLFF_FACTOR), log_fn=lambda *_: None)
    pool, at = tr.build_ray_pool(), 0
    for k in range(30):
        if k == 10:
            tr.global_step = 1001
        tr.step(tr.sample_pool(pool, at, args.N_rand))
        at += args.N_rand
    return tr, pool, at


def _llff_windows(torch, np, reps: int):
    """The llff phase's graphed pool windows, `reps` times on one trainer
    (_llff_trainer); yields (rep, window, record)."""
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix="chip_diag_llff_")
    try:
        tr, pool, at = _llff_trainer(torch, np, work)
        for rep in range(reps):
            for window, start in (("tv", cs.LLFF_GRAPH_TV_START), ("no_tv", cs.GRAPH_NO_TV_START)):
                yield rep, window, cs.graphed_window(torch, tr, "llff", start, window, False,
                                                     pool=pool, offset=at)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def gate_spread(torch, np, path: str, reps: int) -> None:
    import chip_smoke as cs

    fails = []

    def require(cond, what):
        if not cond:
            fails.append(what)
            print(json.dumps({"gate_failed": what[:3000]}), flush=True)

    cs.require = require
    if path == "llff":
        runs = _llff_windows(torch, np, reps)
    else:
        runs = ((rep, window, rec["graphed"][window])
                for rep in range(reps) for rec in [cs.phase_main_path(torch, np, path, False)]
                for window in ("tv", "no_tv"))
    windows, seen = 0, 0
    for rep, window, rec in runs:
        # a window's failures name its start step; those of its rep's run
        # that were not yet shown
        mine = [f for f in fails[seen:] if f"from step {rec['start']}" in f]
        windows += 1
        print(json.dumps({"rep": rep, "path": path, "window": window, "start": rec["start"],
                          "gate": rec["gate"], "passed": not mine}), flush=True)
        if window == "no_tv":
            seen = len(fails)
    print(json.dumps({"path": path, "windows": windows, "gates_failed": len(fails)}), flush=True)


def _offset_frozen(torch, tr):
    """The pool blocks' row offset never advances: every replay of a block
    reads the rows of its first step (a step graph that lost its add_)."""
    off = tr._pool_offset
    off.add_ = lambda *a, **k: off
    return lambda: delattr(off, "add_")


def _pool_rebound(torch, tr):
    """A reshuffle that rebinds the pool: at their capture the graphs bind
    a pool whose rows the caller then reshuffles into another tensor, so
    they replay the old order while the eager steps read the new (modelled
    by binding a copy and reshuffling the caller's pool in place, by a
    generator of its own, at the first capture)."""
    from hashnerf_torch.train.driver import Trainer

    build, stale = Trainer._build_block, {}

    def faulty(self, b, use_tv, occ_mode, precrop, keep, pool=None):
        if pool is not None:
            if pool.data_ptr() not in stale:
                stale[pool.data_ptr()] = pool.clone()
                gen = torch.Generator(device=pool.device)
                gen.manual_seed(7)
                pool.copy_(pool[torch.randperm(pool.shape[0], generator=gen, device=pool.device)])
            pool = stale[pool.data_ptr()]
        return build(self, b, use_tv, occ_mode, precrop, keep, pool)

    Trainer._build_block = faulty

    def undo():
        Trainer._build_block = build
    return undo


POOL_FAULTS = (("offset_frozen", _offset_frozen), ("pool_rebound", _pool_rebound))


def pool_faults(torch, np) -> bool:
    """Each pool fault planted in turn on the llff trainer (_llff_trainer),
    then the llff window without TV (from GRAPH_NO_TV_START) run under the
    graph gate: each must stop there (chip_smoke.CheckFailed naming the
    window). Prints one JSON line per fault; returns whether all stopped."""
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix="chip_diag_llff_")
    rejected = 0
    try:
        tr, pool, at = _llff_trainer(torch, np, work)
        for name, plant in POOL_FAULTS:
            undo = plant(torch, tr)
            try:
                cs.graphed_window(torch, tr, "llff", cs.GRAPH_NO_TV_START, "no_tv", False,
                                  pool=pool, offset=at)
                msg = None
            except cs.CheckFailed as e:
                msg = str(e)
            finally:
                undo()
            hit = msg is not None and msg.startswith("graphed block from step")
            print(json.dumps({"fault": name, "path": "llff", "rejected": hit,
                              "message": None if msg is None else msg[:4000]}), flush=True)
            rejected += hit
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rejected == len(POOL_FAULTS)


def spread_why(torch, np, reps: int) -> None:
    """Why llff's runs of one mode spread further than the chair's. From
    the state each path's graphed window without TV starts from (the chair:
    phase_main_path's 40 + 30 steps; llff: _llff_trainer), at step
    GRAPH_NO_TV_START, `reps` eager pairs: 16 steps twice from one state and
    generator state (the window's eager pair), each pair from the state the
    last one's 16 steps left. Prints for each pair the table entries outside
    the row gate after 1, 4 and 16 steps and, for each step, the fine
    pass's sample points that are more than 1e-3 apart between the two runs
    (a sample that jumped: sample_pdf's bins move continuously, but a bin
    whose mass crosses its 1e-5 clamp moves its samples at once); for the
    first pair also step 1's table gradient (entries touched, entries whose
    bits differ). Then a line per path: the pairs' counts after 16 steps."""
    import chip_smoke as cs
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train import driver

    work = tempfile.mkdtemp(prefix="chip_diag_why_")
    query = driver.query_fn
    fine_pts = []

    def capture(state, pts, viewdirs, bbox, fine=False):
        if fine:
            fine_pts.append(pts.detach().reshape(-1, 3).clone())
        return query(state, pts, viewdirs, bbox, fine=fine)

    try:
        for path in ("chair", "llff"):
            if path == "llff":
                tr, pool, at = _llff_trainer(torch, np, work)
                n_rand = tr.args.N_rand
            else:
                scene = make_synthetic_scene(H=128, W=128, n_train=8, n_test=2)
                tr = _chair_trainer(torch, "chair", scene, work)
                cs.timed_steps(torch, tr, 10)
                tr.global_step = 1001
                cs.timed_steps(torch, tr, 20)
            tables = tr.state.table_parameters()
            driver.query_fn = capture
            counts = []
            for rep in range(reps):
                tr.global_step = cs.GRAPH_NO_TV_START
                snap = [t.detach().clone() for t in tr.training_state()]
                rng = tr.generator.get_state()

                def run():
                    with torch.no_grad():
                        for t, v in zip(tr.training_state(), snap):
                            t.copy_(v)
                    tr.generator.set_state(rng)
                    tr.global_step = cs.GRAPH_NO_TV_START
                    fine_pts.clear()
                    grad, after = None, {}
                    for j in range(16):
                        tr.step(tr.sample_batch(False) if path == "chair"
                                else tr.sample_pool(pool, at + j * n_rand, n_rand))
                        if j == 0:
                            grad = torch.cat([p.grad.detach().reshape(-1) for p in tables])
                        if j + 1 in (1, 4, 16):
                            after[j + 1] = [p.detach().clone() for p in tables]
                    return grad, after, list(fine_pts)

                (g1, a1, p1), (g2, a2, p2) = run(), run()
                jumped = [int(((x - y).abs().amax(-1) > 1e-3).sum()) for x, y in zip(p1, p2)]
                rec = {"path": path, "rep": rep, "fine_points_a_step": p1[0].shape[0],
                       "outside_after": {k: cs.row_gate(a2[k], a1[k])[0] for k in a1},
                       "fine_points_jumped_each_step": jumped}
                if rep == 0:
                    rec["step1_table_grad"] = {"entries": g1.numel(), "touched": int((g1 != 0).sum()),
                                               "bits_differ": int((g1 != g2).sum())}
                counts.append(rec["outside_after"][16])
                print(json.dumps(rec), flush=True)
                del g1, g2, a1, a2, p1, p2, snap
            driver.query_fn = query
            print(json.dumps({"path": path, "pairs": reps, "outside_after_16": counts,
                              "median": statistics.median(counts)}), flush=True)
            del tr
            torch.cuda.empty_cache()
    finally:
        driver.query_fn = query
        shutil.rmtree(work, ignore_errors=True)


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
    ap.add_argument("what", choices=("gate-spread", "pool-faults", "spread-why", "one-step",
                                     "blender-step"))
    ap.add_argument("--path", default="flagship", choices=("chair", "packed", "flagship", "llff"))
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
    elif opts.what == "pool-faults":
        return 0 if pool_faults(torch, np) else 1
    elif opts.what == "spread-why":
        spread_why(torch, np, opts.reps)
    elif opts.what == "one-step":
        one_step(torch)
    else:
        blender_step(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

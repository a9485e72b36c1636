#!/usr/bin/env python3
"""Diagnostics of the PyTorch port on one NVIDIA GPU, beyond chip_smoke.py's
gates. Each prints JSON lines; only pool-faults and field-query (through
chip_smoke.phase_field_kernels) are gates.

    python3 chip_diag.py gate-spread [--path flagship] [--reps 2]
        chip_smoke.py's main path `path` (chair, packed or flagship), `reps`
        times in one process, or for `--path llff` the llff phase's two
        graphed pool windows `reps` times on one trainer at the llff
        phase's state (configs/fern.txt, 300 steps and 30 timed ones, on
        chip_smoke.llff_set's set), or for `--path st3d` the st3d phase's
        two windows of its hash run at that run's state (configs/st3d.txt,
        320 steps and 10 timed pool steps, on chip_smoke.st3d_set's set),
        with every gate printed instead of raised: how far the
        graph-against-eager counts of graphed_window spread from run to
        run, and whether each window passes.
    python3 chip_diag.py pool-faults [--path llff]
        On that llff trainer, two faults of the pool blocks planted in turn
        (in this process only): a row offset that never advances, and a
        pool rebound after the capture. The llff window without TV must
        stop each at the graph gate. With `--path st3d`, two faults of the
        column pool's layout inside the captured blocks: the rgb target
        read one float off on the hash run's trainer, and the depth and
        gradient targets read one float off on OmniNeRF's, each under the
        run's window without TV. Exits 1 if a fault passes.
    python3 chip_diag.py st3d-step [--reps 2]
        On the st3d phase's OmniNeRF trainer, chip_smoke's card-against-CPU
        step (st3d_step_card_vs_cpu) on `reps` pool batches, its gate
        printed instead of raised: the card's, the CPU float32 step's and
        the controls' (TF32, bf16 operands) errors against the CPU float64
        step.
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
    python3 chip_diag.py packed-k8
        K8's launch order and its hot rows: K7 and K8 (CUDA events, L2
        flushed; K8's kernel alone from a profiler trace) at the flagship's
        fine pass (196,608 points, uniform and along rays) over K8's level
        groups (1, 2, 4 levels), and at its two dense levels alone (res 16
        and 50: 4,913 and 132,651 vertices), beside K5 adding the same
        cw * g updates, materialised, into the same vertex rows.
    python3 chip_diag.py encode-bwd
        Where K6 and K8 spend their time (encode_bwd): each on level ranges
        (K6 at the chair fine pass: levels 0-2, 3-6, 7-15; K8 at the packed
        one: dense level 0, dense level 1, the fine levels) on uniform
        points, points along rays and the (x, g) recorded in steps 0, 500
        and 1000 of the chair and packed main paths, over their level
        groups; the reductions each grouping leaves, counted from the
        keys; the share of zero cotangent rows and of clipped points; and
        the reduction bound (csrc/red_probe.cu: 8- and 16-byte reductions
        into random and consecutive rows of 16.8, 67 and 134 MB tables).
    python3 chip_diag.py encode-fwd
        Where K7 spends its time (encode_fwd): device ms of the kernel at
        chip_smoke.py's packed_case sets (the packed fine pass on uniform
        points, along rays and at the x of the packed path's step 40; the
        coarse pass; the flagship's culled passes at keep 0.125 and 0.5;
        tpu-quality's L8 / F4), over all levels, the dense levels alone and
        the fine levels alone, beside the distinct-row byte bound and the
        rate those bytes are read at; each held to the plain version.
    python3 chip_diag.py tv-k5
        K5 at the TV losses' own shapes (tv_k5): the zero fill alone, K5
        (its fill and kernel) and zeros().index_add_, device ms from a
        trace and CUDA-event ms, in turns; K5 held to the plain version.
    python3 chip_diag.py llff-view [--states 6]
        Test view 0 of the llff phase (378 x 504 rays), card against CPU,
        at `states` trained states (the phase's schedule, each from another
        pool row): chip_smoke.py's view gate (view_gate) and, per state,
        the rays off by more than 2e-3 and 1e-4, each with the first stage
        that differs beyond rounding and the sample_pdf decisions the
        devices took apart with both margins; the rays at risk by margin;
        K2 and K3 at the held rays' sample points (llff_view).
    python3 chip_diag.py field-query
        K9 and field_raw (field_query) as chip_smoke.py holds and times
        them (phase_field_kernels), then one pass's copies at each of its
        shapes by the per-sample route they replaced and by the per-ray
        one.

Imports hashnerf_torch and chip_smoke.py (never jax); exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

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


def _llff_trainer(torch, np, work: str, offset: int = 0):
    """The llff phase's trainer and ray pool at the state its graphed
    windows start from: configs/fern.txt trained LLFF_ITERS steps on
    chip_smoke.llff_set's set under `work` (made once), then 10 pool steps
    with TV and 20 from step 1001, as phase_llff times them, from pool row
    `offset`. Returns (trainer, pool, the pool row the windows start at)."""
    import chip_smoke as cs
    from hashnerf_torch.data.llff import load_llff_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import train_loop

    data, n = os.path.join(work, "fern"), cs.LLFF_ITERS
    if not os.path.isdir(data):
        cs.llff_set(np, data)
    args = parse_args(["--config", os.path.join(ROOT, "configs", "fern.txt"), "--datadir", data,
                       "--basedir", work, "--no_reload", "--N_iters", str(n), "--i_print", "20",
                       "--i_weights", str(n), "--i_testset", "0", "--i_video", "0", "--device", "cuda"])
    tr = train_loop(args, load_llff_scene(data, factor=cs.LLFF_FACTOR), log_fn=lambda *_: None)
    pool, at = tr.build_ray_pool(), offset
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


def _st3d_trainer(torch, np, work: str, run: str):
    """The st3d phase's trainer of `run` (of chip_smoke.ST3D_ITERS) and its
    column pool at the state its graphed windows start from: run_nerf.main
    on chip_smoke.st3d_set's set under `work` (made once), the pool rebuilt
    from the loader's rays (st3d_pool), then the phase's 10 eager pool
    steps. Returns (trainer, pool, the pool row the windows start at)."""
    import chip_smoke as cs
    from hashnerf_torch.data.st3d import load_st3d_data
    from hashnerf_torch.run_nerf import main as run_nerf

    data = os.path.join(work, "pano", cs.ST3D_NAME)
    if not os.path.isdir(data):
        cs.st3d_set(np, data)
    tr, _ = cs._run(run_nerf, cs.st3d_argv(data, os.path.join(work, "logs"), run))
    pool = cs.st3d_pool(np, tr, load_st3d_data(data)[0])
    n_rand = tr.args.N_rand
    for k in range(10):
        tr.step(tr.sample_pool(pool, k * n_rand, n_rand))
    return tr, pool, 10 * n_rand


def _st3d_windows(torch, np, reps: int):
    """The st3d phase's graphed pool windows of its hash run, `reps` times
    on one trainer (_st3d_trainer); yields (rep, window, record)."""
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix="chip_diag_st3d_")
    try:
        tr, pool, at = _st3d_trainer(torch, np, work, "hash")
        for rep in range(reps):
            for window, start in (("tv", cs.ST3D_GRAPH_TV_START), ("no_tv", cs.GRAPH_NO_TV_START)):
                yield rep, window, cs.graphed_window(torch, tr, "st3d", start, window, False,
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
    elif path == "st3d":
        runs = _st3d_windows(torch, np, reps)
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


def _columns_shifted(first: str):
    """A column layout off by one inside the captured pool blocks: while a
    block is built (its step captured), each pool row's floats from column
    `first` on are read one later, the row's last wrapping to `first`'s
    place; eager steps read the pool right."""
    def plant(torch, tr):
        from hashnerf_torch.train.driver import POOL_COLUMNS, POOL_LAYOUTS, Trainer

        build, pool_batch = Trainer._build_block, Trainer._pool_batch

        def shifted(self, rows):
            flat = rows.reshape(rows.shape[0], -1)
            names = POOL_LAYOUTS[flat.shape[1]]
            at = 0
            for name, w in POOL_COLUMNS:
                if name == first:
                    break
                at += w if name in names else 0
            return pool_batch(self, torch.cat([flat[:, :at], flat[:, at + 1:], flat[:, at:at + 1]], 1))

        def faulty(self, *a, **k):
            Trainer._pool_batch = shifted
            try:
                return build(self, *a, **k)
            finally:
                Trainer._pool_batch = pool_batch

        Trainer._build_block = faulty

        def undo():
            Trainer._build_block = build
        return undo
    return plant


POOL_FAULTS = {
    "llff": (("offset_frozen", _offset_frozen), ("pool_rebound", _pool_rebound)),
    # (fault, the st3d run it is planted on)
    "st3d": (("target_shifted", _columns_shifted("target"), "hash"),
             ("depth_grad_shifted", _columns_shifted("target_depth"), "omninerf")),
}


def pool_faults(torch, np, path: str) -> bool:
    """Each pool fault of POOL_FAULTS[path] planted in turn, then the
    path's window without TV run under the graph gate: llff's on the llff
    trainer (_llff_trainer), from GRAPH_NO_TV_START; st3d's on its run's
    trainer (_st3d_trainer), the hash run's from GRAPH_NO_TV_START and
    OmniNeRF's from its last step, as phase_st3d runs them. Each must stop
    there (chip_smoke.CheckFailed naming the window). Prints one JSON line
    per fault; returns whether all stopped."""
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix=f"chip_diag_{path}_")
    faults, rejected, trainers = POOL_FAULTS[path], 0, {}
    try:
        for name, plant, *run in faults:
            run = run[0] if run else "llff"
            if run not in trainers:
                trainers.clear()
                torch.cuda.empty_cache()
                trainers[run] = (_llff_trainer(torch, np, work) if run == "llff"
                                 else _st3d_trainer(torch, np, work, run))
            tr, pool, at = trainers[run]
            start = tr.global_step if run == "omninerf" else cs.GRAPH_NO_TV_START
            undo = plant(torch, tr)
            try:
                cs.graphed_window(torch, tr, path, start, "no_tv", False, pool=pool, offset=at)
                msg = None
            except cs.CheckFailed as e:
                msg = str(e)
            finally:
                undo()
            hit = msg is not None and msg.startswith("graphed block from step")
            print(json.dumps({"fault": name, "path": path, "run": run, "rejected": hit,
                              "message": None if msg is None else msg[:4000]}), flush=True)
            rejected += hit
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rejected == len(faults)


def st3d_step(torch, np, reps: int) -> None:
    """chip_smoke.st3d_step_card_vs_cpu on `reps` pool batches of the st3d
    phase's OmniNeRF trainer, its gate printed instead of raised."""
    import chip_smoke as cs

    fails = []
    cs.require = lambda cond, what: cond or fails.append(what)
    work = tempfile.mkdtemp(prefix="chip_diag_st3d_")
    try:
        tr, pool, at = _st3d_trainer(torch, np, work, "omninerf")
        n_rand = tr.args.N_rand
        for rep in range(reps):
            seen = len(fails)
            rec = cs.st3d_step_card_vs_cpu(torch, np, tr, tr.sample_pool(pool, at + rep * n_rand, n_rand))
            print(json.dumps({"rep": rep, "step": rec, "gates_failed": fails[seen:]}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


def packed_k8(torch, np) -> None:
    import chip_smoke as cs
    from hashnerf_torch.kernels import packed_encode as pe
    from hashnerf_torch.kernels.segment_accum import segment_accumulate_k5
    from hashnerf_torch.ops.packed_grid import PackedGridConfig, init_packed_tables

    dev = cs.DEV
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    widths = dict(n_features_per_level=cs.PACKED_F, log2_hashmap_size=cs.LOG2_T,
                  log2_blocks=cs.PACKED_LOG2_BLOCKS)
    cfgs = {"flagship": PackedGridConfig(n_levels=cs.PACKED_L, **widths),
            "dense_16_50": PackedGridConfig(n_levels=2, finest_resolution=50, **widths)}
    bmin, bmax = torch.full((3,), -1.6, device=dev), torch.full((3,), 1.6, device=dev)
    for cname, pcfg in cfgs.items():
        tables = {k: v * 1e4 for k, v in init_packed_tables(pcfg, gen, dev).items()}
        points = {"uniform": cs.chair_points(np, cs.N_POINTS, -1.6, 1.6, pcfg.resolutions, seed=1),
                  "rays": cs.ray_points(np, 1024, 192, seed=3)}
        for pname, xs in points.items():
            x = torch.as_tensor(xs, device=dev)
            g = torch.randn((x.shape[0], pcfg.out_dim), generator=gen, device=dev)
            rec = {"config": cname, "points": pname, "N": x.shape[0],
                   "resolutions": list(pcfg.resolutions),
                   "k7_ms": cs.cuda_ms(torch, lambda: pe.packed_encode_fwd(
                       tables.get("dense"), tables.get("fine"), x, bmin, bmax, pcfg))}
            default = pe._K8_GROUP_LEVELS
            try:
                for gl in (1, 2, 4):
                    pe._K8_GROUP_LEVELS = gl
                    k8 = lambda: pe.packed_encode_bwd(x, bmin, bmax, g, pcfg)
                    rec[f"k8_gl{gl}_ms"] = cs.cuda_ms(torch, k8)
                    rec[f"k8_gl{gl}_kernel_device_ms"] = _kernel_device_ms(
                        torch, k8, "packed_encode_bwd", reps=5)
            finally:
                pe._K8_GROUP_LEVELS = default
            if cname.startswith("dense"):
                # the same updates as K8's dense levels, materialised for K5
                _, levels = pe.corner_rows(x, bmin, bmax, pcfg)
                F = pcfg.n_features_per_level
                ids = torch.cat([r.reshape(-1) for _, r, _ in levels])
                vals = torch.cat([(cw[..., None] * g[:, None, li * F:(li + 1) * F]).reshape(-1, F)
                                  for li, (_, _, cw) in enumerate(levels)])
                V = pcfg.dense_offsets[-1]
                rec.update({"k5_updates": ids.numel(), "unique_vertices": int(ids.unique().numel()),
                            "k5_same_updates_ms": cs.cuda_ms(
                                torch, lambda: segment_accumulate_k5(ids, vals, V))})
                level0 = levels[0][1].reshape(-1)
                rec["level0_updates_per_vertex_max"] = int(torch.bincount(level0).max())
                del levels, ids, vals
            print(json.dumps(rec), flush=True)
        del tables
        torch.cuda.empty_cache()


@dataclasses.dataclass(frozen=True)
class PackedLevels:
    """Levels of a packed config as a config of their own, with their own
    tables (the dense levels' vertices from row 0, the fine levels' slabs
    from block row 0): what packed_encode_bwd needs to run K8 on a range of
    levels alone."""
    resolutions: tuple
    dense_level_count: int
    n_features_per_level: int
    log2_blocks: int

    @classmethod
    def of(cls, pcfg, a: int, b: int):
        return cls(tuple(pcfg.resolutions[a:b]), max(0, min(b, pcfg.dense_level_count) - a),
                   pcfg.n_features_per_level, pcfg.log2_blocks)

    n_levels = property(lambda self: len(self.resolutions))
    out_dim = property(lambda self: self.n_levels * self.n_features_per_level)
    fine_resolutions = property(lambda self: self.resolutions[self.dense_level_count:])
    n_block_rows = property(lambda self: 1 << self.log2_blocks)
    dense_offsets = property(lambda self: tuple(itertools.accumulate(
        ((r + 1) ** 3 for r in self.resolutions[:self.dense_level_count]), initial=0)))


def reduction_counts(torch, keys, nonzero, runs_levels=None):
    """What one level range's corner updates cost in reductions, counted
    from the keys. keys (Lr, N, 8) int64: the row each (level, point,
    corner) adds to (one key space a level); nonzero (Lr, N): the (point,
    level) cotangent rows that are not all zero; runs_levels (Lr,) bool:
    the levels the kernel groups by runs (default none). The kernels' warps
    take 32 points of one level in order (point-fastest), one call of the
    grouping a corner. Returns
      updates, updates_nonzero: corner updates of every lane, of the
        nonzero lanes;
      match: distinct (level, warp, corner, key) over every lane: the
        reductions __match_any_sync's grouping issues when every lane adds;
      match_nonzero: the same over the nonzero lanes (zero lanes skipped);
      runs_nonzero: runs of one key in neighbouring lanes, zero lanes
        breaking runs: what the run grouping issues;
      issued: what the kernel issues, zero lanes skipped: runs_nonzero at
        runs_levels, match_nonzero at the others."""
    Lr, N, _ = keys.shape
    Np = -(-N // 32) * 32
    k = torch.full((Lr, Np, 8), -1, dtype=torch.int64, device=keys.device)
    k[:, :N] = keys
    nz = torch.zeros((Lr, Np), dtype=torch.bool, device=keys.device)
    nz[:, :N] = nonzero
    knz = torch.where(nz[..., None], k, torch.full_like(k, -1))

    def distinct(kk):  # per level: keys >= 0 told apart in each (warp, corner)
        s = kk.reshape(Lr, Np // 32, 32, 8).transpose(-1, -2).sort(dim=-1).values
        return (((s[..., 1:] != s[..., :-1]) & (s[..., 1:] >= 0)).sum(dim=(1, 2, 3))
                + (s[..., 0] >= 0).sum(dim=(1, 2)))

    w = knz.reshape(Lr, Np // 32, 32, 8)
    head = w != torch.roll(w, 1, dims=2)
    head[:, :, 0] = True
    match, match_nz = distinct(k), distinct(knz)
    runs_nz = (head & (w >= 0)).sum(dim=(1, 2, 3))
    runs = torch.zeros(Lr, dtype=torch.bool, device=keys.device) if runs_levels is None else \
        torch.as_tensor(runs_levels, device=keys.device)
    return {"updates": Lr * N * 8, "updates_nonzero": int(nonzero.sum()) * 8,
            "match": int(match.sum()), "match_nonzero": int(match_nz.sum()),
            "runs_nonzero": int(runs_nz.sum()),
            "issued": int(torch.where(runs, runs_nz, match_nz).sum())}


def _kernel_device_ms(torch, fn, marker: str, reps: int = 10) -> float:
    """Device ms of one fn() in the kernels whose names hold `marker`, from
    a profiler trace, each call after chip_smoke's L2 flush (zero fills
    and other kernels left out)."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    cs.cuda_ms(torch, fn, reps=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            cs._L2_FLUSH[0].zero_()
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in cs.kernel_times(p) if marker in r[1]) / 1e3 / reps


# K6's reductions at the chair fine pass (196,608 points x 16 levels x 8
# corners, 8 bytes) and K8's at the packed one (196,608 x 4 x 8 corners x 2
# vectors of 16 bytes)
FULL_PROBE_COUNTS = {8: 196_608 * 16 * 8, 16: 196_608 * 4 * 8 * 2}


def red_probe(torch, reps: int = 10):
    """The reduction bound: csrc/red_probe.cu's reductions of 8 and 16
    bytes, as many as K6 issues at the chair fine pass (196,608 points x 16
    levels x 8 corners) and K8 at the packed one (196,608 x 4 x 8 corners
    x 2 vectors of 16 bytes), into random rows (and consecutive rows) of
    tables of 67 MB (the chair table), 16.8 MB (one level group of it) and
    134 MB, and half as many, CUDA events with the L2 flushed."""
    import ctypes

    import chip_smoke as cs
    from hashnerf_torch.kernels import build

    fn = build.load("red_probe").red_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    table = torch.zeros(1 << 25, device=cs.DEV)  # 134 MB
    k6_count, k8_count = FULL_PROBE_COUNTS[8], FULL_PROBE_COUNTS[16]
    out = []
    for vw, count in ((2, k6_count), (4, k8_count)):
        for mb in (16.8, 67, 134):
            rows = (1 << 25 if mb == 134 else 1 << 24 if mb == 67 else 1 << 22) // vw
            for scattered in (1, 0):
                for m in (count, count // 2):
                    call = lambda: build.check(fn(table.data_ptr(), rows, m, vw, scattered, sms,
                                                  torch.cuda.current_stream().cuda_stream), "red_probe")
                    ms = cs.cuda_ms(torch, call, reps=reps)
                    out.append({"probe": "red", "bytes": 4 * vw, "count": m, "table_mb": mb,
                                "rows": rows, "scattered": bool(scattered), "ms": ms,
                                "reds_per_ns": m / ms / 1e6})
                    print(json.dumps(out[-1]), flush=True)
    del table
    return out


# The launch orders encode-bwd times, as the wrappers' constants: K6's and
# K8's level groups (default 4 levels).
ENCODE_BWD_VARIANTS = {
    "default": {"K6": {}, "K8": {}},
    **{f"gl{n}": {"K6": {"_K6_GROUP_LEVELS": n}, "K8": {"_K8_GROUP_LEVELS": n}} for n in (1, 2, 8)},
}


def encode_bwd(torch, np, variants=None) -> None:
    """Where K6 and K8 spend their time: each timed on level ranges (CUDA
    events with the L2 flushed, the wrapper's zero fill included, and the
    kernel's device ms from a trace) at the chair's and the packed path's
    fine pass, on uniform points (chip_smoke.chair_points), points along
    rays (ray_points) and the (x, g) that reach them in real steps 0, 500
    and 1000 of the chair and packed main paths
    (chip_smoke.recorded_encode_inputs); beside each, the reductions
    counted from the keys (reduction_counts), the share of exactly-zero
    cotangent rows and of points clipped onto the bbox; each range held to
    the plain version by the row gate. `variants` {name: {"K6" / "K8":
    {wrapper constant: value}}} (default ENCODE_BWD_VARIANTS) times each
    range with the wrappers' constants set so. Then the reduction bound
    (red_probe)."""
    import chip_smoke as cs
    from hashnerf_torch.kernels import hash_encode as he
    from hashnerf_torch.kernels import packed_encode as pe
    from hashnerf_torch.ops.hash_encoding import HashGridConfig, corner_geometry
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    # the reduction rate into a slice the L2 holds, 8 and 16 bytes
    rate = {r["bytes"]: r["reds_per_ns"] for r in red_probe(torch)
            if r["scattered"] and r["table_mb"] == 16.8 and r["count"] == FULL_PROBE_COUNTS[r["bytes"]]}
    dev = cs.DEV
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    variants = variants or ENCODE_BWD_VARIANTS
    modules = {"K6": he, "K8": pe}
    hcfg = HashGridConfig(n_levels=cs.HASH_L, n_features_per_level=cs.HASH_F,
                          log2_hashmap_size=cs.LOG2_T)
    pcfg = PackedGridConfig(n_levels=cs.PACKED_L, n_features_per_level=cs.PACKED_F,
                            log2_hashmap_size=cs.LOG2_T, log2_blocks=cs.PACKED_LOG2_BLOCKS)
    box = (torch.full((3,), -1.6, device=dev), torch.full((3,), 1.6, device=dev))
    T = hcfg.table_size
    sets = {"K6": {}, "K8": {}}
    for kern, cfg, res_of in (("K6", hcfg, hcfg.resolutions), ("K8", pcfg, pcfg.resolutions)):
        F = cfg.n_features_per_level
        for name, xs in (("uniform", cs.chair_points(np, cs.N_POINTS, -1.6, 1.6, res_of, seed=1)),
                         ("rays", cs.ray_points(np, 1024, 192, seed=2))):
            x = torch.as_tensor(xs, device=dev)
            sets[kern][name] = (x, torch.randn((x.shape[0], cfg.n_levels * F), generator=gen,
                                               device=dev), *box)
    for kern, path in (("K6", "chair"), ("K8", "packed")):
        t0 = time.perf_counter()
        rec = cs.recorded_encode_inputs(torch, path, (0, 500, 1000))
        for step, passes in rec.items():
            for pname, r in zip(("coarse", "fine"), passes):
                sets[kern][f"recorded_{pname}_{step}"] = (r["x"], r["g"], r["saved"][0], r["saved"][1])
        print(json.dumps({"recorded": path, "steps": sorted(rec), "seconds": time.perf_counter() - t0}),
              flush=True)
        del rec
    ranges = {"K6": ((0, 3), (3, 7), (7, 16), (0, 16)), "K8": ((0, 1), (1, 2), (2, 4), (0, 4))}
    for kern in ("K6", "K8"):
        cfg = hcfg if kern == "K6" else pcfg
        F, L = cfg.n_features_per_level, cfg.n_levels
        for sname, (x, g, bmin, bmax) in sets[kern].items():
            N = x.shape[0]
            nz = (g.reshape(N, L, F) != 0).any(dim=-1).T  # (L, N)
            clipped = float(1 - ((x >= bmin) & (x <= bmax)).all(dim=-1).float().mean())
            if kern == "K6":
                res = hcfg.resolutions_tensor(dev)
                keys = corner_geometry(x, bmin, bmax, res, cs.LOG2_T)[0]
            else:
                _, levels = pe.corner_rows(x, bmin, bmax, pcfg)
                keys = torch.stack([r for _, r, _ in levels])
            for a, b in ranges[kern]:
                gs = g[:, a * F:b * F].contiguous()
                if kern == "K6":
                    r = res[a:b].contiguous()
                    call = lambda: he.hash_encode_bwd(x, bmin, bmax, r, gs, T)
                    marker = "hash_encode_bwd"
                else:
                    sub = PackedLevels.of(pcfg, a, b)
                    call = lambda: pe.packed_encode_bwd(x, bmin, bmax, gs, sub)
                    marker = "packed_encode_bwd"
                res_ab = cfg.resolutions[a:b]
                # K6 groups a hashed level (more vertices than table rows) by runs
                runs = [kern == "K6" and (r_ + 1) ** 3 > T for r_ in res_ab]
                counts = reduction_counts(torch, keys[a:b], nz[a:b], runs)
                # a reduction adds 4 floats at most: F = 8 takes two a corner
                width = 4 * min(F, 4)
                reds = counts["issued"] * F * 4 // width
                # x and g read once, the gradient tables written once
                tables = [((b - a) * T, F)] if kern == "K6" else \
                    [s_ for s_ in pe.table_shapes(PackedLevels.of(pcfg, a, b)) if s_]
                n_bytes = N * 12 + N * (b - a) * F * 4 + sum(r_ * c_ * 4 for r_, c_ in tables)
                line = {"kernel": kern, "points": sname, "N": N, "levels": [a, b],
                        "resolutions": list(res_ab),
                        "zero_row_share": float(1 - nz[a:b].float().mean()),
                        "clipped_share": clipped, "counts": counts, "reductions": reds,
                        "reduction_bound_ms": reds / rate[width] / 1e6,
                        "byte_bound_ms": n_bytes / cs.PEAK_BYTES_PER_S * 1e3}
                if kern == "K6":
                    want = [he.hash_encode_bwd_plain(x, bmin, bmax, r, gs, T)]
                    abs_sum = [he.hash_encode_bwd_plain(x, bmin, bmax, r, gs.abs(), T)]
                else:
                    want = pe.packed_encode_bwd_plain(x, bmin, bmax, gs, sub)
                    abs_sum = pe.packed_encode_bwd_plain(x, bmin, bmax, gs.abs(), sub)
                mod = modules[kern]
                for vname, by_kernel in variants.items():
                    consts = by_kernel[kern]
                    old = {k: getattr(mod, k) for k in consts}
                    try:
                        for k, v in consts.items():
                            setattr(mod, k, v)
                        got = call()
                        got = got if isinstance(got, tuple) else [got]
                        line[f"{vname}_ok"] = all(
                            (gt is None and w is None) or cs.row_abs_ok(gt, w, s)
                            for gt, w, s in zip(got, want, abs_sum))
                        line[f"{vname}_ms"] = cs.cuda_ms(torch, call)
                        line[f"{vname}_kernel_device_ms"] = _kernel_device_ms(torch, call, marker)
                    finally:
                        for k, v in old.items():
                            setattr(mod, k, v)
                print(json.dumps(line), flush=True)
                del want, abs_sum
            del keys
        torch.cuda.empty_cache()


def culled_points(torch, np, keep: float):
    """The points the flagship's fine cull keeps at `keep`, as
    chip_smoke.phase_occupancy draws them: 1024 rays of 192 samples (seed
    4) scored on its occupancy grid, blocks of OCC_BLOCK by their max."""
    import chip_smoke as cs
    from hashnerf_torch.render import occupancy as occ
    from hashnerf_torch.render.renderer import keep_k

    pts = torch.as_tensor(cs.ray_points(np, 1024, 192, seed=4), device=cs.DEV)
    grid = torch.as_tensor(cs.occupancy_grid(np), device=cs.DEV)
    bbox = torch.tensor([[-1.6] * 3, [1.6] * 3], device=cs.DEV)
    cfg = occ.OccupancyConfig(resolution=cs.OCC_R, block=cs.OCC_BLOCK)
    bs = occ.occupancy_scores(grid, pts, bbox, cfg).reshape(-1, cs.OCC_BLOCK).amax(-1)
    kept = occ.cull_points(bs, keep_k(bs.numel() * cs.OCC_BLOCK, keep) // cs.OCC_BLOCK)[0]
    return pts.reshape(-1, cs.OCC_BLOCK, 3)[kept].reshape(-1, 3).contiguous()


def encode_fwd_sets(torch, np):
    """[(name, pcfg, x, bmin, bmax)]: the shapes chip_smoke's packed_case
    runs K7 at (the packed fine pass on uniform points, along rays and at
    the x the packed path's step RECORDED_STEP encodes; the coarse pass;
    the flagship's culled pass at keep 0.125 and 0.5; tpu-quality's L8 / F4
    fine pass)."""
    import chip_smoke as cs
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    box = (torch.full((3,), -1.6, device=cs.DEV), torch.full((3,), 1.6, device=cs.DEV))
    out = []
    for widths, (L, F) in cs.PACKED_WIDTHS.items():
        pcfg = PackedGridConfig(n_levels=L, n_features_per_level=F, log2_hashmap_size=cs.LOG2_T,
                                log2_blocks=cs.PACKED_LOG2_BLOCKS)
        x_all = torch.as_tensor(cs.chair_points(np, cs.N_POINTS, -1.6, 1.6, pcfg.resolutions,
                                                seed=1), device=cs.DEV)
        if widths != "flagship":
            out.append(("quality_fine", pcfg, x_all, *box))
            continue
        rec = cs.recorded_encode_inputs(torch, "packed", (cs.RECORDED_STEP,))[cs.RECORDED_STEP][-1]
        out += [("fine", pcfg, x_all, *box),
                ("fine_rays", pcfg, torch.as_tensor(cs.ray_points(np, 1024, 192, seed=3),
                                                    device=cs.DEV), *box),
                ("fine_recorded", rec["ctx_attrs"], rec["x"], *rec["saved"]),
                ("coarse", pcfg, x_all[:cs.N_COARSE].contiguous(), *box),
                ("culled", pcfg, culled_points(torch, np, cs.FLAGSHIP_KEEP[0]), *box),
                ("keep_0.5", pcfg, culled_points(torch, np, 0.5), *box)]
    return out


def encode_fwd(torch, np) -> None:
    """Where K7 spends its time: device ms of the kernel from a trace (L2
    flushed) and CUDA-event ms of the wrapper at every set of
    encode_fwd_sets, over all levels, the dense levels alone and the fine
    levels alone (each a level config of one kind over the same tables,
    PackedLevels), beside the distinct-row byte bound and the rate it
    reads those bytes at; each held to the plain version (keep bit-equal,
    features within BLEND_ORDER_RTOL of their blend's absolute sum)."""
    import chip_smoke as cs
    from hashnerf_torch.kernels import packed_encode as pe
    from hashnerf_torch.ops.packed_grid import init_packed_tables

    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(15)
    for sname, pcfg, x, bmin, bmax in encode_fwd_sets(torch, np):
        tables = {k: v * 1e4 for k, v in init_packed_tables(pcfg, gen, cs.DEV).items()}
        Ld, L, N = pcfg.dense_level_count, pcfg.n_levels, x.shape[0]
        for part, (a, b) in (("all", (0, L)), ("dense", (0, Ld)), ("fine", (Ld, L))):
            if a == b:
                continue
            sub = pcfg if part == "all" else PackedLevels.of(pcfg, a, b)
            dense = tables.get("dense") if sub.dense_level_count else None
            fine = tables.get("fine") if sub.fine_resolutions else None
            call = lambda: pe.packed_encode_fwd(dense, fine, x, bmin, bmax, sub)
            want, want_keep = pe.packed_encode_fwd_plain(dense, fine, x, bmin, bmax, sub)
            abs_sum, _ = pe.packed_encode_fwd_plain(None if dense is None else dense.abs(),
                                                    None if fine is None else fine.abs(),
                                                    x, bmin, bmax, sub)
            _, levels = pe.corner_rows(x, bmin, bmax, sub)
            F = sub.n_features_per_level
            touched = sum(torch.unique(torch.cat([r.reshape(-1) for k, r, _ in levels if k == kind]))
                          .numel() for kind in ("dense", "fine") if any(k == kind for k, _, _ in levels))
            del levels
            row_bytes = touched * F * 4
            n_bytes = N * 12 + 24 + row_bytes + N * sub.n_levels * F * 4 + N
            bnd = cs.bound(n_bytes, N * sub.n_levels * (cs.PACKED_GEOM_OPS + 16 * F))
            feats, keep = call()
            torch.cuda.synchronize()
            ratio = float(((feats - want).abs() / abs_sum.clamp_min(1e-30)).max())
            line = {"kernel": "K7", "points": sname, "N": N, "levels": [a, b], "part": part,
                    "resolutions": list(sub.resolutions), "F": F, "touched_rows": touched,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "ok": bool(torch.equal(keep, want_keep)) and ratio <= cs.BLEND_ORDER_RTOL,
                    "ms": cs.cuda_ms(torch, call),
                    "kernel_device_ms": _kernel_device_ms(torch, call, "packed_encode_fwd")}
            dms = line["kernel_device_ms"]
            if dms > 0:  # a trace that caught no kernel gives 0
                line["distinct_row_tb_per_s"] = row_bytes / dms / 1e9
                line["bound_share"] = bnd[0] / dms
            print(json.dumps(line), flush=True)
            del feats, keep, want, want_keep, abs_sum
        del tables
        torch.cuda.empty_cache()


def tv_k5(torch, np, rounds: int = 3) -> None:
    """K5 at the TV losses' own shapes (chip_smoke.tv_rows): the zero fill
    (torch.zeros of the gradient table) alone, K5 (fill and kernel) and
    zeros().index_add_, each as device ms from a trace (L2 flushed) and by
    CUDA events, in `rounds` rounds of turns; K5's kernel alone from the
    trace. K5 is held to the plain version run on the CPU by the row gate."""
    import chip_smoke as cs
    from hashnerf_torch.kernels import segment_accum as sa

    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(12)
    for name, ((T, F), idx) in cs.tv_rows(torch, cs.DEV).items():
        M = idx.numel()
        vals = torch.randn((M, F), generator=gen, device=cs.DEV)
        want = sa.segment_accumulate_k5_plain(idx.cpu(), vals.cpu(), T)
        abs_sum = sa.segment_accumulate_k5_plain(idx.cpu(), vals.cpu().abs(), T)
        got = sa.segment_accumulate_k5(idx, vals, T).cpu()
        line = {"shape": name, "M": M, "F": F, "num_rows": T, "id_bytes": idx.element_size(),
                "ok": cs.row_abs_ok(got, want, abs_sum),
                "fill_bound_ms": T * F * 4 / cs.PEAK_BYTES_PER_S * 1e3,
                "bound_ms": cs.bound(cs.seg_bytes(M, F, T), M * F)[0]}
        del got, want, abs_sum
        timed = {"fill": lambda: torch.zeros((T, F), device=cs.DEV),
                 "k5": lambda: sa.segment_accumulate_k5(idx, vals, T),
                 "library": lambda: torch.zeros((T, F), device=cs.DEV).index_add_(0, idx, vals)}
        for r in range(rounds):
            for what, fn in (list(timed.items()) if r % 2 == 0 else list(timed.items())[::-1]):
                line.setdefault(f"{what}_ms", []).append(cs.cuda_ms(torch, fn))
                line.setdefault(f"{what}_device_ms", []).append(cs.device_ms(torch, fn, reps=5))
                if what == "k5":
                    line.setdefault("k5_kernel_device_ms", []).append(
                        _kernel_device_ms(torch, fn, "scatter_", reps=5))
        line["k5_slower_than_library_beyond_spread"] = min(line["k5_ms"]) > max(line["library_ms"])
        print(json.dumps(line), flush=True)


def field_query(torch, rounds: int = 2) -> None:
    """K9 and field_raw at the field query's shapes: chip_smoke's check and
    timing of each kernel against its plain version (phase_field_kernels),
    then one pass's copies by the per-sample route they replaced (the
    directions expanded and SH-encoded on every sample, the features',
    colour input's and raw's concatenations and the keep mask's where) and
    by the per-ray one (SH on the rays, K9, field_raw), in `rounds` rounds
    of turns: CUDA-event ms (L2 flushed) and device ms from a trace."""
    import chip_smoke as cs
    from hashnerf_torch.kernels import field_query as fq
    from hashnerf_torch.ops.sh_encoding import sh_encode

    cs.phase_field_kernels(torch)
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(21)
    for name, (R, S) in cs.FIELD_SHAPES.items():
        t = cs.field_inputs(torch, R, S, gen)
        d, feats, h, rgb, keep = (t[k] for k in ("d", "feats", "h", "rgb", "keep"))

        def per_sample():
            dirs = sh_encode(d[:, None, :].expand(R, S, 3).reshape(-1, 3))
            x = torch.cat([feats, dirs], dim=-1)
            c = torch.cat([x[:, 32:48], h[:, 1:]], dim=-1)
            raw = torch.cat([rgb, h[:, :1]], dim=-1)
            sigma = torch.where(keep, raw[:, 3], torch.zeros_like(raw[:, 3]))
            return c, torch.cat([raw[:, :3], sigma[:, None], raw[:, 4:]], dim=-1)

        timed = {"per_ray_route": lambda: (fq.field_colour_input_fwd(sh_encode(d), h, S),
                                           fq.field_raw_fwd(rgb, h, keep)),
                 "per_sample_route": per_sample}
        line = {"shape": name, "R": R, "S": S, "N": R * S}
        for r in range(rounds):
            for what, fn in (list(timed.items()) if r % 2 == 0 else list(timed.items())[::-1]):
                line.setdefault(f"{what}_ms", []).append(cs.cuda_ms(torch, fn))
                line.setdefault(f"{what}_device_ms", []).append(cs.device_ms(torch, fn, reps=5))
        print(json.dumps(line), flush=True)
        del t, d, feats, h, rgb, keep
        torch.cuda.empty_cache()


LLFF_VIEW_STATES = 6
LLFF_VIEW_REPORT_RAYS = 40  # the worst rays reported of each state
VIEW_STAGES = ("coarse_raw", "coarse_weights", "sample_pdf", "fine_z", "fine_raw", "fine_weights",
               "rgb")


def view_stage_excess(torch, card, cpu):
    """Per ray and stage, in render order (VIEW_STAGES), the largest
    difference of the two renders over its tolerance (> 1 beyond
    rounding): the coarse pass at chip_smoke.VIEW_COARSE_TOL; sample_pdf
    inf where a decision flipped (chip_smoke.pdf_flips); the samples z over
    chip_smoke.placement_tolerance; the fine pass at VIEW_FINE_TOL; rgb in
    units of 1e-4."""
    import chip_smoke as cs

    flipped, _, _ = cs.pdf_flips(torch, card, cpu)
    dz = (card["sample_pdf"]["z"] - cpu["sample_pdf"]["z"]).abs()
    zeros = torch.zeros(flipped.shape[0])
    return {
        "coarse_raw": cs._close(torch, card["coarse"]["raw"], cpu["coarse"]["raw"], cs.VIEW_COARSE_TOL),
        "coarse_weights": cs._close(torch, card["coarse"]["weights"], cpu["coarse"]["weights"],
                                    cs.VIEW_COARSE_TOL),
        "sample_pdf": torch.where(flipped.any(dim=-1), zeros + float("inf"), zeros),
        "fine_z": (dz / cs.placement_tolerance(torch, card, cpu)).amax(dim=-1),
        "fine_raw": cs._close(torch, card["fine"]["raw"], cpu["fine"]["raw"], cs.VIEW_FINE_TOL),
        "fine_weights": cs._close(torch, card["fine"]["weights"], cpu["fine"]["weights"],
                                  cs.VIEW_FINE_TOL),
        "rgb": (card["fine"]["rgb"] - cpu["fine"]["rgb"]).abs().amax(dim=-1) / 1e-4,
    }


def _k2_at_points(torch, state, pts, bbox, chunk: int = 1 << 16):
    """K2 at a view's sample points against its plain version (each feature
    within BLEND_ORDER_RTOL of its blend's absolute sum, keep equal), and
    the corner rows and weights of K3 (which shares K2's geometry in
    csrc/hash_encode.cu) against corner_geometry's, all on the card."""
    import chip_smoke as cs
    from hashnerf_torch.kernels.hash_encode import (
        hash_encode_bwd_expand, hash_encode_fwd, hash_encode_fwd_plain,
    )
    from hashnerf_torch.ops.hash_encoding import corner_geometry

    table = state.hash_table.detach()
    L, T, F = table.shape
    bmin, bmax, res = bbox[0].contiguous(), bbox[1].contiguous(), state.resolutions
    out = {"points": int(pts.shape[0]), "k2_max_err_over_abs_sum": 0.0, "keep_diffs": 0,
           "k3_row_diffs": 0, "k3_weight_max_abs_err": 0.0}
    for x in pts.split(chunk):
        x = x.contiguous()
        feats, keep = hash_encode_fwd(table, x, bmin, bmax, res)
        fp, kp = hash_encode_fwd_plain(table, x, bmin, bmax, res)
        ratio = (feats - fp).abs() / cs.blend_abs_sum(torch, table, x, bmin, bmax, res).clamp_min(1e-30)
        ids, vals = hash_encode_bwd_expand(x, bmin, bmax, res, torch.ones_like(feats), T)
        idx, cw, _ = corner_geometry(x, bmin, bmax, res, T.bit_length() - 1)
        flat = (idx + (torch.arange(L, device=x.device) * T)[:, None, None]).reshape(-1)
        out["k2_max_err_over_abs_sum"] = max(out["k2_max_err_over_abs_sum"], float(ratio.max()))
        out["keep_diffs"] += int((keep != kp).sum())
        out["k3_row_diffs"] += int((ids.long() != flat).sum())
        out["k3_weight_max_abs_err"] = max(out["k3_weight_max_abs_err"],
                                           float((vals[:, 0] - cw.reshape(-1)).abs().max()))
    out["k2_within_blend_order"] = out["k2_max_err_over_abs_sum"] <= cs.BLEND_ORDER_RTOL
    return out


def _view_ray_report(torch, parts, excess, pos, W):
    """One held ray (`pos` among the rays held): where it lies, its error,
    the first stage beyond rounding, each stage's excess, and each
    decision of sample_pdf the devices took apart, with both margins."""
    import chip_smoke as cs

    card, cpu, at_card = parts["card"], parts["cpu"], parts["at_card"]
    view = int(parts["sel"][pos])
    flipped, m_card, m_cpu = cs.pdf_flips(torch, {k: {n: t[pos:pos + 1] for n, t in v.items()}
                                                  for k, v in card.items()},
                                          {k: {n: t[pos:pos + 1] for n, t in v.items()}
                                           for k, v in cpu.items()})
    a, b = card["sample_pdf"], cpu["sample_pdf"]
    flips = []
    for s in flipped[0].nonzero().flatten().tolist():
        flips.append({"u_index": s, "u": float(a["u"][pos, s]),
                      "decision": "count" if int(a["inds"][pos, s]) != int(b["inds"][pos, s])
                      else "switch",
                      "inds": [int(a["inds"][pos, s]), int(b["inds"][pos, s])],
                      "denom": [float(a["denom"][pos, s]), float(b["denom"][pos, s])],
                      "cdf_end": [float(a["cdf"][pos, -1]), float(b["cdf"][pos, -1])],
                      "margin_ulps": [float(m_card[0, s]), float(m_cpu[0, s])],
                      "z": [float(a["z"][pos, s]), float(b["z"][pos, s])]})
    w_fine = card["fine"]["weights"][pos]
    first = next((k for k in VIEW_STAGES if float(excess[k][pos]) > 1), None)
    return {
        "ray": view, "row": view // W, "col": view % W,
        "rgb_err": float((card["fine"]["rgb"][pos] - cpu["fine"]["rgb"][pos]).abs().max()),
        "rgb_err_at_card_z": float((at_card["fine"]["rgb"][pos] - card["fine"]["rgb"][pos]).abs().max()),
        "first_stage": first, "excess": {k: float(v[pos]) for k, v in excess.items()},
        "least_margin_ulps": float(parts["margins"]["least"][view]),
        "coarse_acc": float(card["coarse"]["weights"][pos].sum()),
        "fine_acc": float(w_fine.sum()),
        "fine_transmittance_at_last_sample": float(1 - w_fine[:-1].sum()),
        "flips": flips[:6],
    }


def llff_view(torch, np, states: int) -> None:
    """Test view 0 of the llff phase, card against CPU, over `states`
    trained states (_llff_trainer, from pool row k * 30 * N_rand for state
    k): chip_smoke.view_gate's render and hold, its record printed; then
    the rays held that are off by more than 2e-3 and by more than 1e-4,
    each with the first stage beyond rounding and the decisions flipped
    (view_stage_excess, _view_ray_report); the at-risk counts; the largest
    cdf difference in ulps; K2 and K3 at the held rays' points
    (_k2_at_points). A failing state's file goes to
    chiprun_out/llff_view_state<k>.pt (chip_smoke.save_view_failure)."""
    import subprocess

    import chip_smoke as cs
    from hashnerf_torch.ops.rays import get_ndc_rays, get_rays

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    work = tempfile.mkdtemp(prefix="chip_diag_llff_view_")
    try:
        for k in range(states):
            t0 = time.perf_counter()
            tr, pool, _ = _llff_trainer(torch, np, work, offset=k * 30 * 1024)
            del pool
            train_s = time.perf_counter() - t0
            sc, args = tr.scene, tr.args
            c2w = sc.poses[sc.i_test[0]]
            cfg = tr.render_cfg.eval_mode()
            ro, rd = get_rays(sc.H, sc.W, torch.as_tensor(sc.K), torch.as_tensor(c2w[:3, :4]))
            ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            rays = (*get_ndc_rays(sc.H, sc.W, sc.focal, 1.0, ro, rd), vd)
            strided = (torch.arange(0, sc.H, cs.LLFF_CPU_ROW_STRIDE)[:, None] * sc.W
                       + torch.arange(sc.W)).flatten()
            ok, rec, parts = cs.view_gate(
                torch, np, tr.state, rays, tr.bbox, cfg, sc.near, sc.far, args.chunk, strided,
                save_to=os.path.join(ROOT, "chiprun_out", f"llff_view_state{k}.pt"))
            card, cpu = parts["card"], parts["cpu"]
            excess = view_stage_excess(torch, card, cpu)
            err = excess["rgb"] * 1e-4
            worst = torch.argsort(err, descending=True)
            off_1e4 = int((err > 1e-4).sum())
            rays_out = [_view_ray_report(torch, parts, excess, int(p), sc.W)
                        for p in worst[:min(off_1e4, LLFF_VIEW_REPORT_RAYS)]]
            in_strided = torch.isin(parts["sel"], strided)
            dcdf = (card["sample_pdf"]["cdf"] - cpu["sample_pdf"]["cdf"]).abs() / cs.VIEW_CDF_ULP
            least = parts["margins"]["least"].cpu()
            o, d = rays[0][parts["sel"]].to(tr.device), rays[1][parts["sel"]].to(tr.device)
            z = torch.cat([card["coarse"]["z"], card["fine"]["z"]], -1).to(tr.device)
            pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
            k2 = _k2_at_points(torch, tr.state, pts, tr.bbox)
            del pts, o, d, z
            line = {
                "llff_view_state": k, "card": smi, "pool_offset": k * 30 * 1024,
                "train_s": train_s, "gate_ok": ok,
                "off_2e-3": int((err > 2e-3).sum()), "off_1e-4": off_1e4,
                "strided_off_2e-3": int((err[in_strided] > 2e-3).sum()),
                "strided_off_1e-4": int((err[in_strided] > 1e-4).sum()),
                "first_stage_counts": {s: sum(r["first_stage"] == s for r in rays_out)
                                       for s in VIEW_STAGES},
                "at_risk_by_ulps": {str(u): int((least <= u).sum()) for u in (1, 4, 16, 64, 256)},
                "cdf_diff_ulps": {"max": float(dcdf.max()),
                                  "p99": float(torch.quantile(dcdf.flatten(), 0.99))},
                "k2_at_view_points": k2, "rays": rays_out,
                "gate": {**rec, "explained": {n: v[:64] for n, v in rec["explained"].items()}},
            }
            print(json.dumps(line), flush=True)
            del tr, parts, card, cpu
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("gate-spread", "pool-faults", "st3d-step", "spread-why",
                                     "one-step", "blender-step", "packed-k8", "encode-bwd",
                                     "encode-fwd", "tv-k5", "llff-view", "field-query"))
    ap.add_argument("--path", default=None,
                    choices=("chair", "packed", "flagship", "llff", "st3d"),
                    help="gate-spread's path (default flagship); pool-faults' (llff or st3d, "
                         "default llff)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--states", type=int, default=LLFF_VIEW_STATES, help="llff-view's trained states")
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hashnerf_torch.kernels import build

    logs = build.build_all()["logs"]
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "ptxas": [ln.strip() for log in logs.values() for ln in log.splitlines()
                                if "registers" in ln or "Compiling entry" in ln or "spill" in ln]}),
          flush=True)
    if opts.what == "gate-spread":
        gate_spread(torch, np, opts.path or "flagship", opts.reps)
    elif opts.what == "pool-faults":
        path = opts.path or "llff"
        if path not in POOL_FAULTS:
            ap.error(f"pool-faults takes --path llff or st3d, not {path}")
        return 0 if pool_faults(torch, np, path) else 1
    elif opts.what == "st3d-step":
        st3d_step(torch, np, opts.reps)
    elif opts.what == "spread-why":
        spread_why(torch, np, opts.reps)
    elif opts.what == "one-step":
        one_step(torch)
    elif opts.what == "packed-k8":
        packed_k8(torch, np)
    elif opts.what == "encode-bwd":
        encode_bwd(torch, np)
    elif opts.what == "encode-fwd":
        encode_fwd(torch, np)
    elif opts.what == "tv-k5":
        tv_k5(torch, np)
    elif opts.what == "llff-view":
        llff_view(torch, np, opts.states)
    elif opts.what == "field-query":
        field_query(torch)
    else:
        blender_step(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

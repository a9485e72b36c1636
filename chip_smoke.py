#!/usr/bin/env python3
"""Smoke test and kernel measurement of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out FILE]

Imports hashnerf_torch (never jax or hashnerf_tpu) and, on one CUDA card:

 1. device: prints the card's name and power limit (nvidia-smi), builds every
    kernel of the port from hashnerf_torch/csrc (all nvcc runs at once) and
    prints the build seconds and ptxas' register report;
 2. kernels: holds each CUDA kernel against its plain PyTorch version on the
    card and times kernel, plain version, library call and the sort with
    CUDA events:
    - K1, K2, K3, K6 on the five cases of tests/test_kernels.py (K1) and at
      the chair shapes of the reference-exact path (N = 196,608 points =
      1024 rays x 192 samples, L = 16, T = 2^19, F = 2, so M = 25,165,824
      corner updates; the coarse pass has 65,536 points): K6, the fused
      encode backward, against its plain version, against autograd of the
      plain encode and beside the K3 + K5 route it replaced; K2 and K6 on
      uniform points and on points ordered along rays, and over their
      level groups, each checked against its plain version (K2 there by
      the bound on the blend's summation order, BLEND_ORDER_RTOL);
    - K5, the sort-free scatter-add, on the same five cases and three at
      F = 216, each with its ids shuffled and sorted, on ids outside the
      table and on one hot row at each width; then at the chair shape and
      at every packed shape below, beside the sort + K1/K4 route it
      replaces and `index_add_`, and over its wide-row chunk sizes;
    - K4 on the wide case of tests/test_kernels.py, at F = 16 ... 216 into
      131,072 rows, on one hot row and on a large same-sign sum against a
      float64 oracle; then at the packed path's shapes (fine and coarse
      slabs, dense voxel rows, TV rows), beside K1 at F = 8, 16 and 64 and
      over a range of window sizes;
    - the packed row-id gate: the dense and fine rows that packed_encode
      picks for 196,608 points on the card equal those it picks on the CPU;
    - occupancy: 196,608 points along 1024 rays of 192 samples scored on a
      128^3 grid of few values; the card must give the CPU's cell indices
      and scores, (kept_idx, order, inv_perm) from the sort1, sort2 and
      cumsum partitions at block 1 and 8, and per-ray indices, with 0
      differences; then the flagship's cull (block scores, partition,
      permute_rows forward and backward) is timed at the fine and coarse
      passes' shapes, with CUDA events and as device time from a profiler
      trace, and K5 at the shapes of the kept points (24,576 a pass at
      keep 0.125, 98,304 at the fine pass's 0.5), beside `index_add_`;
 3. main paths, each at the width of configs/chair.txt on the procedural
    scene (128 x 128, 8 train views) through
    hashnerf_torch.train.driver.train_loop (40 steps with TV, a checkpoint,
    a test-set render), then 10 timed steps with TV and 20 without, a
    checkpoint restored bit for bit and one test view rendered:
    - chair: the reference-exact hash-grid step (K2, K6; K5 from the TV
      loss only);
    - packed: the same with --n_levels 4 --n_features_per_level 8
      --packed_layout --share_fine --compute_dtype bfloat16 --aabb_clip
      (K5);
    - flagship: packed with the occupancy culling of the JAX package's
      tpu-fast preset (global block-8 culling, coarse keep 0.375, fine keep
      annealed 0.5 / 0.25 / 0.125 from steps 0 / 512 / 1024, adaptive grid
      updates every 16 steps, warmup 256), all but --steps_per_dispatch.
      Its 10 steps with TV start at global_step 256, where the warmup
      ends, so each must run culled at keep 0.5 (fine) and 0.375 (coarse);
      its 20 without TV start at 1024, each culled at 0.125 and 0.375, and
      K5 must launch in them; the test view is rendered exact and culled
      (--occ_keep_eval 0.75 --occ_eval_transmittance);
    then each path's two windows again as Trainer.run_steps blocks of 16
    steps, replayed from CUDA graphs (--steps_per_dispatch): with TV (from
    step 48, the flagship from 256) and without (from 1024). The first
    block of each must equal 16 eager steps from the same state and
    generator state, its tables, MLP weights and grid each within the
    spread of two eager runs (GATE_*), then 3-4 blocks are
    timed; the flagship's graphed steps must cull at their budgets, and
    the kernels must launch in the replays (counted per replay).
    PATHS holds what each path runs and must show. The launch counts are
    set to 0 before each path and read after it; each kernel of a path
    must have been launched there, and K1, K3 and K4 on no path;
 4. bench: the line of `python -m hashnerf_torch.bench` for the flagship
    and for BENCH_PARITY=1;
 5. prints one line {"kernels": [...]} with each kernel's launches on the
    main paths (graph replays included), error, times and bound, and as the
    last line {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line. It exits non-zero at once when no CUDA device is present or when
hashnerf_torch cannot be imported (a directory holding only this script).
`--profile` adds a torch.profiler breakdown of three eager steps without TV
of each path, and of one graphed block of each window.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores. A card below its 700 W limit runs slower.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Chair main-path shapes (configs/chair.txt): fine pass of 1024 rays x
# (64 + 128) samples; hash grid L=16, F=2, T=2^19.
N_POINTS = 1024 * 192
HASH_L, HASH_F, LOG2_T = 16, 2, 19

# Arithmetic of one (point, level) thread, counted from csrc/hash_encode.cu:
# geometry 12 ops x 3 axes, 8 corner weights (3 subtractions + 16 products),
# 8 hashes (3 adds, 2 multiplies, 2 xors, 1 and), then the blend (K2:
# 8 x F multiply-adds), the expansion (K3: 8 x F products + 8 level adds)
# or the reduction (K6: the same and 8 x F adds into the table).
GEOM_OPS = 36 + 19 + 64
K2_OPS = GEOM_OPS + 16 * HASH_F
K3_OPS = GEOM_OPS + 8 * HASH_F + 8
K6_OPS = K3_OPS + 8 * HASH_F

# Packed path (--n_levels 4 --n_features_per_level 8 --packed_layout at the
# chair widths): 2 dense levels (res 16, 50) and 2 fine levels of 2^16 block
# rows; a fine slab is 27 * 8 = 216 floats, a dense voxel row 8 * 8 = 64.
PACKED_FLAGS = ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout",
                "--share_fine", "--compute_dtype", "bfloat16", "--aabb_clip"]
PACKED_L, PACKED_F, PACKED_LOG2_BLOCKS = 4, 8, 16
N_COARSE = 1024 * 64
# The flagship: tpu-fast (hashnerf_tpu/train/config.py:244-258) without
# --steps_per_dispatch. Its no-TV steps start at the last schedule step.
FLAGSHIP_FLAGS = PACKED_FLAGS + [
    "--use_occupancy", "--occ_keep_fraction", "0.125", "--occ_keep_coarse", "0.375",
    "--occ_keep_schedule", "0:0.5,512:0.25,1024:0.125", "--occ_block", "8",
    "--occ_adaptive_update"]
FLAGSHIP_KEEP = (0.125, 0.375)  # (fine, coarse) from step 1024 on
EVAL_CULL_FLAGS = ["--occ_keep_eval", "0.75", "--occ_eval_transmittance"]
OCC_R, OCC_BLOCK = 128, 8

KERNEL_INFO = {
    "segment_accumulate_k1": {
        "source": "hashnerf_torch/csrc/segment_accum.cu",
        "replaces": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    },
    "hash_encode_fwd": {
        "source": "hashnerf_torch/csrc/hash_encode.cu",
        "replaces": "hashnerf_tpu/kernels/hash_encode_vjp.py:63",
    },
    "hash_encode_bwd_expand": {
        "source": "hashnerf_torch/csrc/hash_encode.cu",
        "replaces": "hashnerf_tpu/kernels/hash_encode_vjp.py:82",
    },
    "segment_accumulate_k4": {
        "source": "hashnerf_torch/csrc/segment_accum.cu",
        "replaces": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    },
    "segment_accumulate_k5": {
        "source": "hashnerf_torch/csrc/scatter_add.cu",
        "replaces": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    },
    "hash_encode_bwd": {
        "source": "hashnerf_torch/csrc/hash_encode.cu",
        "replaces": "hashnerf_tpu/kernels/hash_encode_vjp.py:82",
    },
}
# What phase_main_path runs and requires of each main path:
# - flags: added to configs/chair.txt;
# - kernels: each must launch on the path (K1 and K4 keep the sorted
#   contract, which no path calls since K5; K3 is on no path since K6:
#   OFF_PATH must show 0 launches on every path);
# - tv_start, no_tv_start: the global_step its 10 steps with TV and its 20
#   without start at (tv_start None: right after train_loop's 40 steps);
#   the flagship's TV steps start where the occupancy warmup ends, its
#   steps without TV at the last keep-schedule step;
# - keeps_tv, keeps_no_tv: the (fine, coarse) keep fractions every step of
#   that window must cull at (None: no step culls);
# - k5_no_tv: whether K5 must launch (True) or must not (False) in the
#   steps without TV (the chair path's K5 comes from the TV loss only:
#   K6 reduces the encode's gradient);
# - eval_cull: the flags of a second test-view render, culled on the
#   trained grid (None: none);
# - graph_tv_start: the global_step of the graphed window with TV; the one
#   without TV starts at GRAPH_NO_TV_START. Each graphed window runs
#   Trainer.run_steps blocks of GRAPH_BLOCK steps (CUDA graph replays), must
#   keep the eager window's keeps and K5 rule and launch the path's kernels,
#   and its first block must equal GRAPH_BLOCK eager steps from the same
#   state and draws within the runs' own spread (GATE_*).
PATHS = {
    "chair": {"flags": [], "kernels": ("hash_encode_fwd", "hash_encode_bwd",
                                       "segment_accumulate_k5"),
              "tv_start": None, "no_tv_start": 1001, "keeps_tv": None, "keeps_no_tv": None,
              "k5_no_tv": False, "eval_cull": None, "graph_tv_start": 48},
    "packed": {"flags": PACKED_FLAGS, "kernels": ("segment_accumulate_k5",),
               "tv_start": None, "no_tv_start": 1001, "keeps_tv": None, "keeps_no_tv": None,
               "k5_no_tv": True, "eval_cull": None, "graph_tv_start": 48},
    "flagship": {"flags": FLAGSHIP_FLAGS, "kernels": ("segment_accumulate_k5",),
                 "tv_start": 256, "no_tv_start": 1024, "keeps_tv": (0.5, 0.375),
                 "keeps_no_tv": FLAGSHIP_KEEP, "k5_no_tv": True, "eval_cull": EVAL_CULL_FLAGS,
                 "graph_tv_start": 256},
}
GRAPH_BLOCK = 16  # the flagship preset's --steps_per_dispatch
GRAPH_NO_TV_START = 1024  # the last keep-schedule step; on the update grid
GRAPH_TIMED_BLOCKS = {"tv": 3, "no_tv": 4}
OFF_PATH = ("segment_accumulate_k1", "segment_accumulate_k4", "hash_encode_bwd_expand")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def row_abs_ok(got, want, abs_sum) -> bool:
    """Atomics add in an order that changes from run to run: each entry may
    differ from the plain version by 2e-5 of its row's absolute sum."""
    return bool(((got - want).abs() <= 2e-5 * abs_sum + 1e-6).all())


# K2 and its plain version sum the same 8 float32 products (cw_c * row_c) in
# other orders. Each float32 sum of 8 terms is within gamma_7 = 7u / (1 - 7u)
# (u = 2^-24) of the terms' absolute sum from the exact sum, so the two
# differ by at most twice that.
BLEND_ORDER_RTOL = 2 * 7 * 2.0**-24 / (1 - 7 * 2.0**-24)


def blend_abs_sum(torch, table, xs, bmin, bmax, res):
    """(N, L*F): sum over the 8 corners of |cw_c * row_c|, the scale of the
    rounding of each blended feature."""
    from hashnerf_torch.ops.hash_encoding import corner_geometry

    L, T, F = table.shape
    idx, cw, _ = corner_geometry(xs, bmin, bmax, res, T.bit_length() - 1)
    flat = idx + (torch.arange(L, device=xs.device) * T)[:, None, None]
    emb = table.reshape(L * T, F)[flat.reshape(-1)].reshape(L, -1, 8, F)
    return (cw[..., None] * emb).abs().sum(dim=2).permute(1, 0, 2).reshape(xs.shape[0], L * F)


def check_encode(torch, what: str, ref, k2_out, d_k6):
    """K2's (feats, keep) and K6's d_table against their plain versions in
    ref: keep equal, each feature within BLEND_ORDER_RTOL of its blend's
    absolute sum, the table gradient within row_abs_ok. Returns the max
    errors and the count of features outside the uniform gate's rtol 1e-5 /
    atol 1e-7, which a sum that cancels can leave."""
    feats, keep = k2_out
    feats_p, keep_p = ref["k2"]
    torch.cuda.synchronize()
    require(bool(torch.equal(keep, keep_p)), f"K2 keep mask differs ({what})")
    err = (feats - feats_p).abs()
    ratio = float((err / ref["k2_abs_sum"].clamp_min(1e-30)).max())
    require(ratio <= BLEND_ORDER_RTOL,
            f"K2 ({what}): a feature differs by {ratio} of its blend's absolute sum")
    k6_err = float((d_k6 - ref["k6"]).abs().max())
    require(row_abs_ok(d_k6, ref["k6"], ref["k6_abs_sum"]),
            f"K6 vs its plain version ({what}): max_abs_err {k6_err}")
    return {"k2_max_abs_err": float(err.max()), "k2_max_err_over_abs_sum": ratio,
            "k2_outside_rtol_1e-5_atol_1e-7": int((err > 1e-7 + 1e-5 * feats_p.abs()).sum()),
            "k6_max_abs_err": k6_err}


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes / bandwidth and ops / rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Phase 1
# --------------------------------------------------------------------------- #

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi[0]}", flush=True)

    from hashnerf_torch.kernels import build

    res = build.build_all()
    ptxas = [
        ln.strip() for log in res["logs"].values() for ln in log.splitlines()
        if "registers" in ln or "Compiling entry" in ln
    ]
    emit({"phase": "device", "nvidia_smi": smi[0], "torch_name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": res["seconds"], "ptxas": ptxas})
    return {"name": name, "smi": smi[0]}


# --------------------------------------------------------------------------- #
# Phase 2
# --------------------------------------------------------------------------- #

_L2_FLUSH = []


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` CUDA-event timings, each
    after overwriting a 256 MB buffer so that the 50 MB L2 starts cold."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.float32, device=DEV))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        _L2_FLUSH[0].zero_()
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def kernel_times(prof):
    """[(device us, name, calls)] of each kernel in a finished profiler run,
    largest first: device-side events only, so the operator and
    record_function ranges mirrored onto the device timeline, which span
    the kernels they launch, are not counted twice."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device milliseconds of one fn(): the summed time of its kernels in a
    profiler trace, each call after cuda_ms' L2 flush, less a trace of the
    flushes alone. CUDA events around a chain of small launches also time
    the host between them; this does not."""
    from torch.profiler import ProfilerActivity, profile

    cuda_ms(torch, fn, reps=1)  # warm up, and allocate the flush buffer

    def traced(call: bool) -> float:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                _L2_FLUSH[0].zero_()
                if call:
                    fn()
            torch.cuda.synchronize()
        return sum(r[0] for r in kernel_times(p)) / 1e3

    return (traced(True) - traced(False)) / reps


def phase_k1_cases(torch, np):
    """The five cases of tests/test_kernels.py on the card."""
    from hashnerf_torch.kernels.segment_accum import (
        segment_accumulate_k1, segment_accumulate_sorted_plain, sort_segments,
    )

    rng = np.random.default_rng(0)
    dev = DEV
    cases = []

    def run(name, idx, vals, T, check):
        i, v = sort_segments(torch.as_tensor(idx, device=dev), torch.as_tensor(vals, device=dev))
        got = segment_accumulate_k1(i, v, T)
        want = segment_accumulate_sorted_plain(i, v, T)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = check(got, want)
        cases.append({"case": name, "M": int(idx.shape[0]), "F": int(vals.shape[1]),
                      "num_rows": T, "max_abs_err": err, "ok": bool(ok)})
        require(ok, f"K1 case {name}: max_abs_err {err}")

    close = lambda g, w: bool(torch.allclose(g, w, rtol=1e-4, atol=1e-5))
    run("dense", rng.integers(0, 2048, 5000).astype(np.int32),
        rng.normal(size=(5000, 2)).astype(np.float32), 2048, close)
    run("single_hot_row", np.full(100, 2500, np.int32), np.ones((100, 2), np.float32), 4096,
        lambda g, w: float(g[2500, 0]) == 100.0 and float(g.abs().sum()) == 200.0)
    run("sparse", rng.integers(0, 1 << 16, 3000).astype(np.int32),
        rng.normal(size=(3000, 2)).astype(np.float32), 1 << 16, close)
    idx = rng.integers(0, 1024, 200_000).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=(200_000, 1)).astype(np.float32)
    oracle = np.zeros((1024, 1), np.float64)
    np.add.at(oracle, idx, vals.astype(np.float64))
    oracle_t = torch.as_tensor(oracle.astype(np.float32), device=dev)
    # float64 oracle at rtol 2e-5: same-sign values must not lose small rows
    run("large_m_same_sign", idx, vals, 1024,
        lambda g, w: bool(torch.allclose(g, oracle_t, rtol=2e-5, atol=0.0)))
    run("wide_f8", rng.integers(0, 2048, 4000).astype(np.int32),
        rng.normal(size=(4000, 8)).astype(np.float32), 2048, close)
    torch.cuda.synchronize()
    emit({"phase": "k1_cases", "cases": cases})


def phase_k5_cases(torch, np):
    """K5 against its plain version (sort + index_add_) on the five cases of
    tests/test_kernels.py and three at F = 216, each with its ids shuffled
    and sorted; on ids outside the table (dropped); and on one hot row at
    each of its two kernels' widths, timed."""
    from hashnerf_torch.kernels.segment_accum import (
        segment_accumulate_k5, segment_accumulate_k5_plain, sort_segments,
    )

    dev = DEV
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    t = lambda a: torch.as_tensor(a, device=dev)
    randn = lambda m, f: torch.randn((m, f), generator=gen, device=dev)
    randint = lambda hi, m: torch.randint(0, hi, (m,), generator=gen, device=dev)
    cases = {
        "dense": (t(rng.integers(0, 2048, 5000).astype(np.int32)),
                  t(rng.normal(size=(5000, 2)).astype(np.float32)), 2048),
        "single_hot_row": (t(np.full(100, 2500, np.int32)), t(np.ones((100, 2), np.float32)), 4096),
        "sparse": (t(rng.integers(0, 1 << 16, 3000).astype(np.int32)),
                   t(rng.normal(size=(3000, 2)).astype(np.float32)), 1 << 16),
        "large_m_same_sign": (t(rng.integers(0, 1024, 200_000).astype(np.int32)),
                              t(rng.uniform(0.5, 1.5, (200_000, 1)).astype(np.float32)), 1024),
        "wide_f8": (t(rng.integers(0, 2048, 4000).astype(np.int32)),
                    t(rng.normal(size=(4000, 8)).astype(np.float32)), 2048),
        "f216": (randint(1 << 14, 50_000), randn(50_000, 216), 1 << 14),
        "f216_hot_row": (torch.full((20_000,), 77, device=dev), torch.ones((20_000, 216), device=dev),
                         1 << 14),
        "f216_same_sign": (randint(512, 100_000), randn(100_000, 216).abs() + 0.5, 1 << 14),
    }
    recs = []
    for name, (idx, vals, T) in cases.items():
        for order in ("shuffled", "sorted"):
            i, v = (idx, vals) if order == "shuffled" else sort_segments(idx, vals)
            got = segment_accumulate_k5(i, v, T)
            want = segment_accumulate_k5_plain(i, v, T)
            if "same_sign" in name:
                # float64 oracle at rtol 2e-5: same-sign values must not lose small rows
                want = torch.zeros(got.shape, dtype=torch.float64, device=dev).index_add_(
                    0, i.long(), v.double())
                ok = bool(torch.allclose(got.double(), want, rtol=2e-5, atol=0.0))
            elif "hot_row" in name:
                ok = bool(torch.equal(got, want)) and float(got.sum()) == v.numel()
            else:
                ok = row_abs_ok(got, want, segment_accumulate_k5_plain(i, v.abs(), T))
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            recs.append({"case": name, "order": order, "M": int(i.numel()), "F": int(v.shape[1]),
                         "id_dtype": str(i.dtype), "num_rows": T, "max_abs_err": err, "ok": ok})
            require(ok, f"K5 case {name} ({order}): max_abs_err {err}")

    # ids outside [0, num_rows) are dropped, not written
    T = 1000
    idx = torch.randint(-50, T + 50, (30_000,), generator=gen, device=dev)
    idx[::97] = 2**31 - 1
    inside = (idx >= 0) & (idx < T)
    for F in (2, 216):
        vals = randn(30_000, F)
        for ids in (idx, idx.int()):
            got = segment_accumulate_k5(ids, vals, T)
            torch.cuda.synchronize()  # a write out of bounds would fault here
            want = segment_accumulate_k5_plain(idx[inside], vals[inside], T)
            ok = row_abs_ok(got, want, segment_accumulate_k5_plain(idx[inside], vals[inside].abs(), T))
            recs.append({"case": "out_of_range_ids", "F": F, "id_dtype": str(ids.dtype),
                         "dropped": int((~inside).sum()), "ok": ok})
            require(ok, f"K5 with ids outside the table, F = {F}, {ids.dtype}")

    # every update into one row, at each kernel's width: exact
    hot = {}
    for F, m, T in ((2, 1 << 20, HASH_L << LOG2_T), (216, 1 << 16, 2 << PACKED_LOG2_BLOCKS)):
        hidx = torch.full((m,), 12345, dtype=torch.int32, device=dev)
        hvals = torch.ones((m, F), device=dev)
        got = segment_accumulate_k5(hidx, hvals, T)
        require(bool((got[12345] == m).all()) and float(got.abs().sum()) == m * F,
                f"K5 hot row at F = {F}: wrong sum")
        h64 = hidx.long()
        hot[F] = {
            "M": m, "F": F, "num_rows": T,
            "kernel_ms": cuda_ms(torch, lambda: segment_accumulate_k5(hidx, hvals, T)),
            "plain_ms": cuda_ms(torch, lambda: segment_accumulate_k5_plain(hidx, hvals, T)),
            "library_ms": cuda_ms(torch, lambda: torch.zeros((T, F), device=dev).index_add_(
                0, h64, hvals)),
        }
    del hidx, hvals, h64, got
    emit({"phase": "k5_cases", "cases": recs, "hot_rows": hot})
    return hot


def chair_points(np, n: int, bmin: float, bmax: float, resolutions, seed: int = 0):
    """n points uniform in the bbox grown by 10% (about a quarter fall
    outside, as sample points off the object do), with 1% snapped onto grid
    vertices of a random level (float32, in the encoder's own arithmetic)
    to exercise floor() at cell boundaries."""
    rng = np.random.default_rng(seed)
    half = 1.1 * (bmax - bmin) / 2
    mid = (bmax + bmin) / 2
    x = rng.uniform(mid - half, mid + half, (n, 3)).astype(np.float32)
    snap = rng.random(n) < 0.01
    lev = rng.integers(0, len(resolutions), n)
    res = np.asarray(resolutions, np.float32)[lev]
    grid = (np.float32(bmax) - np.float32(bmin)) / res
    k = np.floor(rng.uniform(0, 1, (n, 3)) * res[:, None]).astype(np.float32)
    xs = (k * grid[:, None] + np.float32(bmin)).astype(np.float32)
    x[snap] = xs[snap]
    return x


def ray_points(np, n_rays: int, n_samples: int, seed: int):
    """Sample points in the order the renderer encodes them: n_rays rays
    from a sphere of radius 4 through the middle of the scene, each with
    n_samples sorted depths in [2, 6] (the chair's near and far), so that
    neighbouring points share voxels at the coarse levels."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -4.0 * d + rng.uniform(-0.5, 0.5, (n_rays, 3))
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, n_samples)), axis=1)
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).astype(np.float32)


def phase_hash_kernels(torch, np):
    """K2, K6, K3 and K1 at the chair shapes, against their plain versions."""
    from hashnerf_torch.kernels import hash_encode as he
    from hashnerf_torch.kernels.hash_encode import (
        hash_encode_bwd, hash_encode_bwd_expand, hash_encode_bwd_expand_plain,
        hash_encode_bwd_plain, hash_encode_fwd, hash_encode_fwd_plain,
    )
    from hashnerf_torch.kernels.segment_accum import (
        segment_accumulate_k1, segment_accumulate_k5, segment_accumulate_k5_plain,
        segment_accumulate_sorted_plain, sort_segments,
    )
    from hashnerf_torch.ops.hash_encoding import HashGridConfig, encode_with_resolutions

    dev = DEV
    cfg = HashGridConfig(n_levels=HASH_L, n_features_per_level=HASH_F, log2_hashmap_size=LOG2_T)
    L, T, F, N = HASH_L, cfg.table_size, HASH_F, N_POINTS
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((L, T, F), generator=gen, device=dev)
    x = torch.as_tensor(chair_points(np, N, -1.6, 1.6, cfg.resolutions), device=dev)
    bmin = torch.full((3,), -1.6, device=dev)
    bmax = torch.full((3,), 1.6, device=dev)
    res = cfg.resolutions_tensor(dev)
    g = torch.randn((N, L * F), generator=gen, device=dev)

    # K2 forward
    feats, keep = hash_encode_fwd(table, x, bmin, bmax, res)
    feats_p, keep_p = hash_encode_fwd_plain(table, x, bmin, bmax, res)
    torch.cuda.synchronize()
    k2_err = float((feats - feats_p).abs().max())
    tol = 1e-7 + 1e-5 * feats_p.abs()
    feat_bad = int(((feats - feats_p).abs() > tol).any(dim=1).sum())
    keep_equal = bool(torch.equal(keep, keep_p))

    # K3 expansion; corner ids are compared exactly
    flat_idx, vals = hash_encode_bwd_expand(x, bmin, bmax, res, g, T)
    flat_idx_p, vals_p = hash_encode_bwd_expand_plain(x, bmin, bmax, res, g, T)
    torch.cuda.synchronize()
    corner_bad = int((flat_idx != flat_idx_p).reshape(L, N, 8).any(dim=2).any(dim=0).sum())
    k3_val_err = float((vals - vals_p).abs().max())
    M = flat_idx.numel()

    # K1 at the fine-backward shape, on K3's own output
    sidx, svals = sort_segments(flat_idx, vals)
    d_table = segment_accumulate_k1(sidx, svals, L * T)
    d_plain = segment_accumulate_sorted_plain(sidx, svals, L * T)
    torch.cuda.synchronize()
    k1_err = float((d_table - d_plain).abs().max())
    unique_rows = int((sidx[1:] != sidx[:-1]).sum()) + 1
    # K5 on K3's output as it comes: the route K6 replaced
    d_k5 = segment_accumulate_k5(flat_idx, vals, L * T)
    torch.cuda.synchronize()
    k5_err = float((d_k5 - d_plain).abs().max())

    # K3 + K1 and K3 + K5 (the encode backward's routes before K6) against
    # autograd of the plain encode
    t_req = table.clone().requires_grad_(True)
    fp, _ = encode_with_resolutions(t_req, x, bmin, bmax, res, LOG2_T)
    (fp * g).sum().backward()
    auto = t_req.grad.reshape(L * T, F)
    abs_sum = segment_accumulate_sorted_plain(flat_idx_p, vals_p.abs(), L * T)
    bwd_err = (d_table - auto).abs()
    # float32 sums of up to a few hundred terms in two orders: bound the
    # difference by the row's absolute sum
    bwd_ok = bool((bwd_err <= 2e-5 * abs_sum + 1e-6).all())
    bwd_err_max = float(bwd_err.max())
    k5_ok = row_abs_ok(d_k5, d_plain, abs_sum)
    bwd5_ok = row_abs_ok(d_k5, auto, abs_sum)
    bwd5_err_max = float((d_k5 - auto).abs().max())
    # K6, the fused backward, as HashEncode.backward calls it
    d_k6 = hash_encode_bwd(x, bmin, bmax, res, g, T).reshape(L * T, F)
    d_k6_plain = hash_encode_bwd_plain(x, bmin, bmax, res, g, T).reshape(L * T, F)
    torch.cuda.synchronize()
    k6_err = float((d_k6 - d_k6_plain).abs().max())
    k6_ok = row_abs_ok(d_k6, d_k6_plain, abs_sum)
    k6_auto_ok = row_abs_ok(d_k6, auto, abs_sum)
    k6_auto_err = float((d_k6 - auto).abs().max())
    del t_req, fp, auto, abs_sum, bwd_err, d_k6, d_k6_plain

    require(keep_equal, "K2 keep mask differs from the plain version")
    require(feat_bad == 0, f"K2: {feat_bad} points outside rtol 1e-5 / atol 1e-7")
    require(corner_bad == 0, f"K3: {corner_bad} points hash to other corners")
    require(bool(torch.allclose(vals, vals_p, rtol=1e-6, atol=0.0)), "K3 values differ")
    require(bool(torch.allclose(d_table, d_plain, rtol=1e-4, atol=1e-4)),
            f"K1 chair shape: max_abs_err {k1_err}")
    require(bwd_ok, f"K3+K1 vs autograd: max_abs_err {bwd_err_max}")
    require(k5_ok, f"K5 chair shape: max_abs_err {k5_err}")
    require(bwd5_ok, f"K3+K5 vs autograd: max_abs_err {bwd5_err_max}")
    require(k6_ok, f"K6 vs its plain version: max_abs_err {k6_err}")
    require(k6_auto_ok, f"K6 vs autograd: max_abs_err {k6_auto_err}")

    # timings (median of CUDA events)
    k3_ms = cuda_ms(torch, lambda: hash_encode_bwd_expand(x, bmin, bmax, res, g, T))
    k3_plain_ms = cuda_ms(
        torch, lambda: hash_encode_bwd_expand_plain(x, bmin, bmax, res, g, T), reps=5)
    k1_ms = cuda_ms(torch, lambda: segment_accumulate_k1(sidx, svals, L * T))
    k1_plain_ms = cuda_ms(torch, lambda: segment_accumulate_sorted_plain(sidx, svals, L * T))
    idx64 = flat_idx.to(torch.int64)
    k1_library_ms = cuda_ms(torch, lambda: torch.zeros(
        (L * T, F), device=dev).index_add_(0, idx64, vals))
    sort_ms = cuda_ms(torch, lambda: sort_segments(flat_idx, vals))
    k5_ms = cuda_ms(torch, lambda: segment_accumulate_k5(flat_idx, vals, L * T))
    k5_plain_ms = cuda_ms(torch, lambda: segment_accumulate_k5_plain(flat_idx, vals, L * T))
    route_ms = cuda_ms(torch, lambda: segment_accumulate_k1(*sort_segments(flat_idx, vals), L * T))

    # the worst case of the ownership scheme: every update into one row,
    # so one block walks them all
    m_hot = 1 << 20
    hot_idx = torch.full((m_hot,), 12345, dtype=torch.int32, device=dev)
    hot_vals = torch.ones((m_hot, F), device=dev)
    hot = segment_accumulate_k1(hot_idx, hot_vals, L * T)
    require(float(hot[12345, 0]) == m_hot and float(hot.abs().sum()) == m_hot * F,
            "K1 hot row: wrong sum")
    hot_rec = {
        "M": m_hot, "kernel_ms": cuda_ms(torch, lambda: segment_accumulate_k1(
            hot_idx, hot_vals, L * T)),
        "plain_ms": cuda_ms(torch, lambda: segment_accumulate_sorted_plain(
            hot_idx, hot_vals, L * T)),
    }
    del hot_idx, hot_vals, hot

    k1_bound = bound(M * 4 + M * F * 4 + L * T * F * 4, M * F)
    k3_bound = bound(N * 12 + N * L * F * 4 + M * 4 + M * F * 4 + 24 + L * 4,
                     N * L * K3_OPS)

    # K2 and K6 at the fine and coarse passes' shapes, on the gate's uniform
    # points and on points ordered along rays (where K6's warps group the
    # most lanes), each held against its plain version, and timed beside it
    # and the K3 + K5 route K6 replaced
    point_sets = {
        "fine": x, "coarse": x[:N_COARSE],
        "fine_rays": torch.as_tensor(ray_points(np, 1024, 192, seed=2), device=dev),
        "coarse_rays": torch.as_tensor(ray_points(np, 1024, 64, seed=3), device=dev),
    }
    shapes, refs = {}, {}
    for name, xs in point_sets.items():
        n = xs.shape[0]
        gs = g[:n]
        ids = hash_encode_bwd_expand(xs, bmin, bmax, res, gs, T)[0]
        rows = int(torch.unique(ids).numel())
        del ids
        refs[name] = {
            "k2": hash_encode_fwd_plain(table, xs, bmin, bmax, res),
            "k2_abs_sum": blend_abs_sum(torch, table, xs, bmin, bmax, res),
            "k6": hash_encode_bwd_plain(xs, bmin, bmax, res, gs, T),
            "k6_abs_sum": hash_encode_bwd_plain(xs, bmin, bmax, res, gs.abs(), T),
        }
        k2_out = hash_encode_fwd(table, xs, bmin, bmax, res)
        refs[name]["k2_kernel"] = k2_out[0]
        errs = check_encode(torch, name, refs[name], k2_out,
                            hash_encode_bwd(xs, bmin, bmax, res, gs, T))
        b2 = bound(n * 12 + rows * F * 4 + n * L * F * 4 + n + 24 + L * 4, n * L * K2_OPS)
        b6 = bound(n * 12 + n * L * F * 4 + L * T * F * 4 + 24 + L * 4, n * L * K6_OPS)
        shapes[name] = {
            "N": n, "touched_rows": rows, **errs,
            "k2_ms": cuda_ms(torch, lambda: hash_encode_fwd(table, xs, bmin, bmax, res)),
            "k2_plain_ms": cuda_ms(torch, lambda: hash_encode_fwd_plain(table, xs, bmin, bmax, res),
                                   reps=5),
            "k2_bound_ms": b2[0], "k2_bound_by": b2[1],
            "k6_ms": cuda_ms(torch, lambda: hash_encode_bwd(xs, bmin, bmax, res, gs, T)),
            "k6_plain_ms": cuda_ms(torch, lambda: hash_encode_bwd_plain(xs, bmin, bmax, res, gs, T),
                                   reps=3),
            "k3_k5_route_ms": cuda_ms(torch, lambda: segment_accumulate_k5(
                *hash_encode_bwd_expand(xs, bmin, bmax, res, gs, T), L * T)),
            "k6_bound_ms": b6[0], "k6_bound_by": b6[1],
        }
        emit({"phase": "encode_shape", "points": name, **shapes[name]})
        if name not in ("fine", "fine_rays"):
            del refs[name]

    # levels in a group, at the fine shape: each group size checked (K2's
    # features do not depend on it, bit for bit), then timed
    layouts = {"k2": {}, "k6": {}}
    saved = (he._K2_GROUP_LEVELS, he._K6_GROUP_LEVELS)
    try:
        for gl in (1, 2, 4, 8, 16):
            he._K2_GROUP_LEVELS = he._K6_GROUP_LEVELS = gl
            for pts in ("fine", "fine_rays"):
                xs = point_sets[pts]
                what = f"{pts}, {gl} levels a group"
                k2_out = hash_encode_fwd(table, xs, bmin, bmax, res)
                check_encode(torch, what, refs[pts], k2_out, hash_encode_bwd(xs, bmin, bmax, res, g, T))
                require(bool(torch.equal(k2_out[0], refs[pts]["k2_kernel"])),
                        f"K2 ({what}): features depend on the group size")
                layouts["k2"].setdefault(pts, {})[gl] = cuda_ms(
                    torch, lambda: hash_encode_fwd(table, xs, bmin, bmax, res))
                layouts["k6"].setdefault(pts, {})[gl] = cuda_ms(
                    torch, lambda: hash_encode_bwd(xs, bmin, bmax, res, g, T))
    finally:
        he._K2_GROUP_LEVELS, he._K6_GROUP_LEVELS = saved
    emit({"phase": "encode_layouts", "group_levels_default": {"k2": saved[0], "k6": saved[1]},
          "ms_by_group_levels": layouts})
    del refs
    del point_sets
    fine = shapes["fine"]
    out = {
        "hash_encode_fwd": {
            "shape": {"N": N, "L": L, "T": T, "F": F}, "keep_equal": keep_equal,
            "keep_fraction": float(keep.float().mean()),
            "feat_mismatch_points": feat_bad, "corner_mismatch_points": corner_bad,
            "max_abs_err": k2_err, "kernel_ms": fine["k2_ms"], "plain_ms": fine["k2_plain_ms"],
            "library_ms": None, "touched_rows": unique_rows,
            "bound_ms": fine["k2_bound_ms"], "bound_by": fine["k2_bound_by"],
        },
        "hash_encode_bwd": {
            "shape": {"N": N, "L": L, "T": T, "F": F}, "max_abs_err": k6_err,
            "backward_vs_autograd_max_abs_err": k6_auto_err,
            "kernel_ms": fine["k6_ms"], "plain_ms": fine["k6_plain_ms"], "library_ms": None,
            "plain": "K3's plain expansion + sort_segments + index_add_",
            "k3_k5_route_ms": fine["k3_k5_route_ms"],
            "bound_ms": fine["k6_bound_ms"], "bound_by": fine["k6_bound_by"],
        },
        "hash_encode_bwd_expand": {
            "shape": {"N": N, "L": L, "M": M, "F": F},
            "corner_mismatch_points": corner_bad, "max_abs_err": k3_val_err,
            "backward_vs_autograd_max_abs_err": bwd_err_max,
            "kernel_ms": k3_ms, "plain_ms": k3_plain_ms, "library_ms": None,
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
        },
        "segment_accumulate_k1": {
            "shape": {"M": M, "num_rows": L * T, "F": F}, "max_abs_err": k1_err,
            "kernel_ms": k1_ms, "plain_ms": k1_plain_ms, "library_ms": k1_library_ms,
            "library_call": "torch.zeros(num_rows, F).index_add_(0, idx, vals) on unsorted idx",
            "sort_ms": sort_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
            "hot_row": hot_rec,
        },
        "segment_accumulate_k5": {
            "shape": {"M": M, "num_rows": L * T, "F": F}, "max_abs_err": k5_err,
            "backward_vs_autograd_max_abs_err": bwd5_err_max,
            "kernel_ms": k5_ms, "plain_ms": k5_plain_ms, "library_ms": k1_library_ms,
            "library_call": "torch.zeros(num_rows, F).index_add_(0, idx, vals) on unsorted idx",
            "plain": "sort_segments + index_add_ on the sorted ids",
            "sort_k1_route_ms": route_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        },
    }
    for name, rec in out.items():
        emit({"phase": "kernel", "name": name, **rec})
    del table, x, g, feats, feats_p, flat_idx, vals, flat_idx_p, vals_p, sidx, svals
    del d_table, d_plain, d_k5, idx64
    torch.cuda.empty_cache()
    out["shapes"] = shapes
    out["layouts"] = layouts
    return out


def seg_bytes(M: int, F: int, rows: int) -> int:
    """Bytes a segment-sum must move: ids and values read, the table written."""
    return M * 4 + M * F * 4 + rows * F * 4


def phase_k4_cases(torch, np):
    """K4 against its plain version (index_add_) on the card."""
    from hashnerf_torch.kernels.segment_accum import (
        segment_accumulate_k4, segment_accumulate_sorted_plain, sort_segments,
    )

    dev = DEV
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []

    def run(name, idx, vals, T, want=None, rtol=1e-4, atol=1e-5):
        sidx, svals = sort_segments(idx, vals)
        got = segment_accumulate_k4(sidx, svals, T)
        if want is None:
            want = segment_accumulate_sorted_plain(sidx, svals, T)
        torch.cuda.synchronize()
        err = float((got - want.float()).abs().max())
        ok = bool(torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol))
        cases.append({"case": name, "M": int(idx.shape[0]), "F": int(vals.shape[1]),
                      "num_rows": T, "max_abs_err": err, "rtol": rtol, "atol": atol, "ok": ok})
        require(ok, f"K4 case {name}: max_abs_err {err}")

    # the wide-F case of tests/test_kernels.py
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2048, 4000).astype(np.int32)
    vals = rng.normal(size=(4000, 8)).astype(np.float32)
    run("wide_f8", torch.as_tensor(idx, device=dev), torch.as_tensor(vals, device=dev), 2048)
    # the packed widths, at the fine pass's element and row counts
    M, T = 2 * N_POINTS, 2 << PACKED_LOG2_BLOCKS
    for F in (16, 54, 64, 108, 216):
        idx = torch.randint(0, T, (M,), generator=gen, device=dev, dtype=torch.int32)
        run(f"f{F}", idx, torch.randn((M, F), generator=gen, device=dev), T)
    # every update into one row: exact
    m_hot = 1 << 16
    hot_idx = torch.full((m_hot,), 12345, dtype=torch.int32, device=dev)
    hot_vals = torch.ones((m_hot, 216), device=dev)
    got = segment_accumulate_k4(hot_idx, hot_vals, T)
    hot_ok = bool((got[12345] == m_hot).all()) and float(got.abs().sum()) == m_hot * 216
    require(hot_ok, "K4 hot row: wrong sum")
    hot = {"M": m_hot, "F": 216, "num_rows": T,
           "kernel_ms": cuda_ms(torch, lambda: segment_accumulate_k4(hot_idx, hot_vals, T)),
           "plain_ms": cuda_ms(torch, lambda: segment_accumulate_sorted_plain(hot_idx, hot_vals, T))}
    del hot_idx, hot_vals, got
    # float64 oracle at rtol 2e-5: same-sign values must not lose small rows
    M2 = 200_000
    idx = torch.randint(0, 1024, (M2,), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.rand((M2, 216), generator=gen, device=dev) + 0.5
    oracle = torch.zeros((1024, 216), dtype=torch.float64, device=dev).index_add_(
        0, idx.long(), vals.double())
    run("large_m_same_sign_f216", idx, vals, 1024, want=oracle, rtol=2e-5, atol=0.0)
    torch.cuda.synchronize()
    emit({"phase": "k4_cases", "cases": cases, "hot_row": hot})
    return hot


def packed_config():
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    return PackedGridConfig(n_levels=PACKED_L, n_features_per_level=PACKED_F,
                            log2_hashmap_size=LOG2_T, log2_blocks=PACKED_LOG2_BLOCKS)


def phase_packed_rows(torch, np):
    """Row-id gate: packed_encode's geometry on the card against the CPU for
    the same 196,608 points (1% snapped onto grid vertices)."""
    from hashnerf_torch.ops.packed_grid import packed_geometry

    pcfg = packed_config()
    x = chair_points(np, N_POINTS, -1.6, 1.6, pcfg.resolutions, seed=1)
    bmin, bmax = np.full(3, -1.6, np.float32), np.full(3, 1.6, np.float32)
    on = [torch.as_tensor(a, device=DEV) for a in (x, bmin, bmax)]
    off = [torch.as_tensor(a) for a in (x, bmin, bmax)]
    g_card = packed_geometry(*on, pcfg)
    g_cpu = packed_geometry(*off, pcfg)
    N = N_POINTS
    dense_bad = int((g_card.dense_rows.cpu() != g_cpu.dense_rows).reshape(-1, N).any(0).sum())
    fine_bad = int((g_card.fine_rows.cpu() != g_cpu.fine_rows).reshape(-1, N).any(0).sum())
    keep_bad = int((g_card.keep.cpu() != g_cpu.keep).sum())
    w_err = max(float((g_card.dense_w.cpu() - g_cpu.dense_w).abs().max()),
                float((g_card.fine_w.cpu() - g_cpu.fine_w).abs().max()))
    rec = {"phase": "packed_rows", "points": N, "resolutions": list(pcfg.resolutions),
           "dense_levels": pcfg.dense_level_count, "dense_row_mismatch_points": dense_bad,
           "fine_row_mismatch_points": fine_bad, "keep_mismatch_points": keep_bad,
           "weight_max_abs_err": w_err}
    emit(rec)
    require(dense_bad == 0 and fine_bad == 0 and keep_bad == 0,
            f"packed row ids differ between card and CPU: {rec}")
    require(w_err <= 1e-6, f"packed blend weights differ by {w_err}")
    return g_card


def phase_packed_kernels(torch, np, geo):
    """K5, and the sort + K4 (K1 where it takes the rows) route it replaced,
    at the packed path's shapes, on the row ids of the gate's points; K1
    against K4 at F = 8, 16, 64; K4's window size; K5's chunk size."""
    from hashnerf_torch.kernels import segment_accum as sa

    dev = DEV
    pcfg = packed_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n_fine_rows = len(pcfg.fine_resolutions) * pcfg.n_block_rows
    n_packed = pcfg.packed_offsets[-1]
    coarse = slice(0, N_COARSE)  # the coarse pass encodes 1024 x 64 points
    fine_rows = geo.fine_rows.reshape(-1, N_POINTS)
    dense_rows = geo.dense_rows.reshape(-1, N_POINTS)
    shapes = {
        # name: (row ids, F, num_rows)
        "fine_slabs": (fine_rows.reshape(-1), 27 * PACKED_F, n_fine_rows),
        "coarse_slabs": (fine_rows[:, coarse].reshape(-1), 27 * PACKED_F, n_fine_rows),
        "dense_voxels": (dense_rows.reshape(-1), 8 * PACKED_F, n_packed),
        "coarse_dense_voxels": (dense_rows[:, coarse].reshape(-1), 8 * PACKED_F, n_packed),
        "tv_fine_rows": (torch.randint(0, n_fine_rows, (4096,), generator=gen, device=dev),
                         27 * PACKED_F, n_fine_rows),
        "tv_dense_cube": (torch.randint(0, pcfg.dense_offsets[-1], (2 * 16**3,), generator=gen,
                                        device=dev), PACKED_F, pcfg.dense_offsets[-1]),
    }
    out = {}
    for name, (idx, F, T) in shapes.items():
        M = idx.numel()
        vals = torch.randn((M, F), generator=gen, device=dev)
        sidx, svals = sa.sort_segments(idx, vals)
        kern = sa.segment_accumulate_k4 if F >= sa.K4_MIN_F else sa.segment_accumulate_k1
        got = kern(sidx, svals, T)
        want = sa.segment_accumulate_sorted_plain(sidx, svals, T)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5)), f"{name}: max_abs_err {err}")
        k5 = sa.segment_accumulate_k5(idx, vals, T)  # as take_rows calls it: int64 ids in any order
        torch.cuda.synchronize()
        k5_err = float((k5 - want).abs().max())
        require(row_abs_ok(k5, want, sa.segment_accumulate_sorted_plain(sidx, svals.abs(), T)),
                f"K5 {name}: max_abs_err {k5_err}")
        idx64 = idx.long()
        b = bound(seg_bytes(M, F, T), M * F)
        out[name] = {
            "kernel": kern.__name__, "M": M, "F": F, "num_rows": T,
            "unique_rows": int(torch.unique(sidx).numel()), "max_abs_err": err,
            "kernel_ms": cuda_ms(torch, lambda: kern(sidx, svals, T)),
            "plain_ms": cuda_ms(torch, lambda: sa.segment_accumulate_sorted_plain(sidx, svals, T)),
            "library_ms": cuda_ms(torch, lambda: torch.zeros((T, F), device=dev).index_add_(
                0, idx64, vals)),
            "sort_ms": cuda_ms(torch, lambda: sa.sort_segments(idx, vals)),
            "route_ms": cuda_ms(torch, lambda: kern(*sa.sort_segments(idx, vals), T)),
            "k5_max_abs_err": k5_err,
            "k5_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k5(idx, vals, T)),
            "k5_plain_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k5_plain(idx, vals, T)),
            "bound_ms": b[0], "bound_by": b[1],
        }
        emit({"phase": "packed_kernel", "shape": name, **out[name]})
    del got, want, vals, svals, k5

    # the F threshold: both kernels at M = 393,216 into 131,072 rows, and on
    # the dense voxel rows of the gate's points (skewed: level 0 has 4,096)
    threshold = {}
    M, T = 2 * N_POINTS, n_fine_rows
    idx = torch.randint(0, T, (M,), generator=gen, device=dev, dtype=torch.int32)
    cases = [(F, idx, T) for F in (8, 16, 64)]
    cases.append(("64_dense_voxels", shapes["dense_voxels"][0], n_packed))
    for F, ids, rows in cases:
        f = 64 if isinstance(F, str) else F
        sidx, svals = sa.sort_segments(ids, torch.randn((ids.numel(), f), generator=gen, device=dev))
        threshold[F] = {
            "k1_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k1(sidx, svals, rows)),
            "k4_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k4(sidx, svals, rows)),
            "bound_ms": bound(seg_bytes(ids.numel(), f, rows), ids.numel() * f)[0],
        }
    emit({"phase": "k1_k4_threshold", "M": M, "num_rows": T, "K4_MIN_F": sa.K4_MIN_F,
          "times": threshold})

    # K4's window (R rows, R * F floats of shared memory) at the fine slabs
    # and the dense voxel rows
    windows, default = {}, sa._K4_WINDOW_ROWS
    for name in ("fine_slabs", "dense_voxels"):
        idx, F, T = shapes[name]
        sidx, svals = sa.sort_segments(idx, torch.randn((idx.numel(), F), generator=gen, device=dev))
        windows[name] = {}
        try:
            for r in (4, 8, 16, 32, 64, 128, 256):
                sa._K4_WINDOW_ROWS = r
                windows[name][r] = cuda_ms(torch, lambda: sa.segment_accumulate_k4(sidx, svals, T))
        finally:
            sa._K4_WINDOW_ROWS = default
    emit({"phase": "k4_window", "window_rows_default": default, "ms_by_window_rows": windows})
    del sidx, svals

    # K5's chunk (updates a wide-row group walks) at the same two shapes
    chunks, default = {}, sa._K5_CHUNK
    for name in ("fine_slabs", "dense_voxels"):
        idx, F, T = shapes[name]
        vals = torch.randn((idx.numel(), F), generator=gen, device=dev)
        chunks[name] = {}
        try:
            for c in (1, 4, 16, 64):
                sa._K5_CHUNK = c
                chunks[name][c] = cuda_ms(torch, lambda: sa.segment_accumulate_k5(idx, vals, T))
        finally:
            sa._K5_CHUNK = default
    emit({"phase": "k5_chunk", "chunk_default": default, "ms_by_chunk": chunks})
    del vals
    torch.cuda.empty_cache()
    return {"shapes": out, "threshold": threshold, "windows": windows, "k5_chunks": chunks}


def occupancy_grid(np, seed: int = 0):
    """A (128^3,) grid of few values: a ball of cells from {0.5, 1, 2}, a
    fifth of it 0, zeros elsewhere, so that many cells share a score."""
    rng = np.random.default_rng(seed)
    R = OCC_R
    c = (np.arange(R) + 0.5) / R * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = (x**2 + y**2 + z**2 < 0.5).reshape(-1)
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), R**3)
    vals[rng.random(R**3) < 0.2] = 0.0
    return np.where(ball, vals, 0.0).astype(np.float32)


def phase_occupancy(torch, np):
    """Culling on the card against the CPU (0 differences allowed), then the
    flagship's cull timed at the fine and coarse passes' shapes. Returns the
    records and the fine pass's kept points for the K5 shapes."""
    from hashnerf_torch.kernels.gather import permute_rows
    from hashnerf_torch.render import occupancy as occ
    from hashnerf_torch.render.renderer import keep_k, keep_per_ray

    bbox_np = np.array([[-1.6] * 3, [1.6] * 3], np.float32)
    grid_np = occupancy_grid(np)
    diffs, recs = {}, {}
    passes = {"fine": (192, FLAGSHIP_KEEP[0]), "coarse": (64, FLAGSHIP_KEEP[1])}
    for name, (S, kf) in passes.items():
        pts_np = ray_points(np, 1024, S, seed=4 if name == "fine" else 5)
        on = {"pts": torch.as_tensor(pts_np, device=DEV), "grid": torch.as_tensor(grid_np, device=DEV),
              "bbox": torch.as_tensor(bbox_np, device=DEV)}
        off = {k: v.cpu() for k, v in on.items()}
        cfg = occ.OccupancyConfig(resolution=OCC_R, block=OCC_BLOCK)
        out = {}
        for where, t in (("card", on), ("cpu", off)):
            r = out[where] = {}
            r["cells"] = occ.cell_index(t["pts"], t["bbox"], OCC_R)
            r["scores"] = occ.occupancy_scores(t["grid"], t["pts"], t["bbox"], cfg)
            n = r["scores"].numel()
            for block in (1, OCC_BLOCK):
                s = r["scores"] if block == 1 else r["scores"].reshape(-1, block).amax(-1)
                for mode in ("sort1", "sort2", "cumsum"):
                    r[(block, mode)] = occ.cull_points(s, keep_k(n, kf) // block, mode=mode)
            r["per_ray"] = occ.cull_per_ray(r["scores"].reshape(1024, S), keep_per_ray(S, kf))
        card, cpu = out["card"], out["cpu"]
        d = {}
        for key in card:
            got = card[key] if isinstance(card[key], tuple) else (card[key],)
            want = cpu[key] if isinstance(cpu[key], tuple) else (cpu[key],)
            label = "/".join(map(str, key)) if isinstance(key, tuple) else key
            d[label] = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
        diffs[name] = d
        scores = cpu["scores"]
        recs[name] = {"points": int(scores.numel()), "outside_bbox": int((scores == -1).sum()),
                      "distinct_scores": int(torch.unique(scores).numel()),
                      "keep_k": keep_k(scores.numel(), kf)}
        if name == "fine":
            # the fine pass's kept points at the flagship's fine keep in its
            # steps with TV (0.5) and without (0.125)
            blocks = on["pts"].reshape(-1, OCC_BLOCK, 3)
            bs = card["scores"].reshape(-1, OCC_BLOCK).amax(-1)
            kept_pts = {}
            for k in (PATHS["flagship"]["keeps_tv"][0], PATHS["flagship"]["keeps_no_tv"][0]):
                kept = occ.cull_points(bs, keep_k(bs.numel() * OCC_BLOCK, k) // OCC_BLOCK)[0]
                kept_pts[k] = blocks[kept].reshape(-1, 3)

        # the flagship's cull, timed: block scores, the partition, and the
        # un-permute of (blocks, 8 x 4 floats) rows forward and backward.
        # *_ms are CUDA events (host gaps between launches included),
        # *_device_ms the kernels' own time from a profiler trace.
        n = on["pts"].numel() // 3
        nb, kb = n // OCC_BLOCK, keep_k(n, kf) // OCC_BLOCK
        C = 4 * OCC_BLOCK
        gen = torch.Generator(device=DEV)
        gen.manual_seed(7)
        bscores = card["scores"].reshape(nb, OCC_BLOCK).amax(-1)
        kept, order, inv = card[(OCC_BLOCK, "sort1")]
        x = torch.randn((nb, C), generator=gen, device=DEV).requires_grad_(True)
        g = torch.randn((nb, C), generator=gen, device=DEV)
        y = permute_rows(x, inv, order)
        (dx,) = torch.autograd.grad(y, x, g)
        require(bool(torch.equal(y, x.detach()[inv])) and bool(torch.equal(dx, g[order])),
                f"permute_rows on the card ({name})")

        row_bytes = nb * C * 4 * 2 + nb * 8  # rows read and written, ids read
        timed = {
            "block_scores": lambda: occ.occupancy_scores(
                on["grid"], on["pts"], on["bbox"], cfg).reshape(nb, OCC_BLOCK).amax(-1),
            "partition_sort1": lambda: occ.cull_points(bscores, kb, "sort1"),
            "partition_sort2": lambda: occ.cull_points(bscores, kb, "sort2"),
            "partition_cumsum": lambda: occ.cull_points(bscores, kb, "cumsum"),
            "permute_rows_fwd": lambda: permute_rows(x.detach(), inv, order),
            # PermuteRows.backward: the gather by the inverse permutation
            "permute_rows_bwd": lambda: g.index_select(0, order),
            "per_ray_sort": lambda: occ.cull_per_ray(
                card["scores"].reshape(1024, -1), keep_per_ray(n // 1024, kf)),
        }
        recs[name].update({"blocks": nb, "kept_blocks": kb, "row_floats": C,
                           "permute_rows_bound_ms_each_way": bound(row_bytes, 0)[0]})
        for what, fn in timed.items():
            recs[name][f"{what}_ms"] = cuda_ms(torch, fn)
            recs[name][f"{what}_device_ms"] = device_ms(torch, fn)
        del x, g, y, dx
    bad = {p: {k: v for k, v in d.items() if v} for p, d in diffs.items()}
    rec = {"phase": "occupancy", "grid": f"{OCC_R}^3", "differences": diffs, "passes": recs}
    emit(rec)
    require(not any(bad.values()), f"culling differs between card and CPU: {bad}")
    return rec, kept_pts


def phase_culled_k5(torch, np, kept_pts):
    """K5 at the flagship's culled shapes: the packed rows of the points the
    fine cull kept, {keep fraction: points}: 24,576 at 0.125 (the coarse
    pass keeps as many at 0.375), 98,304 at 0.5; beside its plain version
    and index_add_."""
    from hashnerf_torch.kernels import segment_accum as sa
    from hashnerf_torch.ops.packed_grid import packed_geometry

    pcfg = packed_config()
    bmin = torch.full((3,), -1.6, device=DEV)
    bmax = torch.full((3,), 1.6, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    shapes = {}
    for keep, pts in kept_pts.items():
        geo = packed_geometry(pts.contiguous(), bmin, bmax, pcfg)
        tag = "" if keep == FLAGSHIP_KEEP[0] else f"_keep_{keep}"
        shapes["culled_slabs" + tag] = (geo.fine_rows.reshape(-1), 27 * PACKED_F,
                                        len(pcfg.fine_resolutions) * pcfg.n_block_rows)
        shapes["culled_dense_voxels" + tag] = (geo.dense_rows.reshape(-1), 8 * PACKED_F,
                                               pcfg.packed_offsets[-1])
    out = {}
    for name, (idx, F, T) in shapes.items():
        M = idx.numel()
        vals = torch.randn((M, F), generator=gen, device=DEV)
        got = sa.segment_accumulate_k5(idx, vals, T)
        want = sa.segment_accumulate_k5_plain(idx, vals, T)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(row_abs_ok(got, want, sa.segment_accumulate_k5_plain(idx, vals.abs(), T)),
                f"K5 {name}: max_abs_err {err}")
        idx64 = idx.long()
        b = bound(seg_bytes(M, F, T), M * F)
        out[name] = {
            "M": M, "F": F, "num_rows": T, "unique_rows": int(torch.unique(idx).numel()),
            "max_abs_err": err,
            "k5_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k5(idx, vals, T)),
            "plain_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k5_plain(idx, vals, T)),
            "library_ms": cuda_ms(torch, lambda: torch.zeros((T, F), device=DEV).index_add_(
                0, idx64, vals)),
            "bound_ms": b[0], "bound_by": b[1],
        }
        emit({"phase": "culled_k5", "shape": name, **out[name]})
    return out


def phase_packed_encode(torch, np, kept_pts):
    """packed_encode (torch ops: geometry, take_rows, the einsum blends;
    backward K5), forward and backward, at the packed path's pass shapes and
    at the flagship's culled ones: device ms from a profiler trace beside
    the byte bound of the function (x, the dense vertex table and the fine
    slabs the points touch read, the cotangent read, the features and both
    tables' gradients written)."""
    from hashnerf_torch.ops.packed_grid import init_packed_tables, packed_encode, packed_geometry

    pcfg = packed_config()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    tables = {k: (v * 1e4).requires_grad_(True)
              for k, v in init_packed_tables(pcfg, gen, DEV).items()}
    bmin = torch.full((3,), -1.6, device=DEV)
    bmax = torch.full((3,), 1.6, device=DEV)
    x_all = torch.as_tensor(chair_points(np, N_POINTS, -1.6, 1.6, pcfg.resolutions, seed=1), device=DEV)
    point_sets = {"fine": x_all, "coarse": x_all[:N_COARSE].contiguous(),
                  "culled": kept_pts[FLAGSHIP_KEEP[0]].contiguous()}
    out = {}
    for name, x in point_sets.items():
        N = x.shape[0]
        g = torch.randn((N, pcfg.out_dim), generator=gen, device=DEV)
        fwd = lambda: packed_encode(tables, x, bmin, bmax, pcfg)
        both = lambda: torch.autograd.grad(fwd()[0], list(tables.values()), g)
        feats, keep = fwd()
        require(bool(torch.isfinite(feats).all()), f"packed_encode ({name}): non-finite features")
        fine_rows = torch.unique(packed_geometry(x, bmin, bmax, pcfg).fine_rows).numel()
        dense_b = tables["dense"].numel() * 4
        fine_b = tables["fine"].numel() * 4
        read = N * 12 + dense_b + fine_rows * tables["fine"].shape[1] * 4 + N * pcfg.out_dim * 4
        written = N * pcfg.out_dim * 4 + N + dense_b + fine_b
        b = bound(read + written, 0)
        out[name] = {"N": N, "touched_fine_slabs": fine_rows,
                     "fwd_device_ms": device_ms(torch, fwd, reps=5),
                     "fwd_bwd_device_ms": device_ms(torch, both, reps=5),
                     "fwd_bwd_ms": cuda_ms(torch, both, reps=5),
                     "bound_ms": b[0], "bound_by": b[1]}
        emit({"phase": "packed_encode", "points": name, **out[name]})
    del tables
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# Phase 3
# --------------------------------------------------------------------------- #

def timed_steps(torch, trainer, n: int, keeps=None):
    """Host-clock seconds of n train steps (ray sampling included), each
    closed by a synchronize; returns (seconds, losses). Appends each step's
    culling keep fractions (or None) to `keeps` when given."""
    args, sc = trainer.args, trainer.scene
    ts, losses = [], []
    for _ in range(n):
        img_i = int(sc.i_train[trainer.global_step % len(sc.i_train)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = trainer.sample_image(
            img_i, args.N_rand, precrop=trainer.global_step + 1 < args.precrop_iters
        )
        m = trainer.step(batch)
        loss = float(m["loss"])
        ts.append(time.perf_counter() - t0)
        losses.append(loss)
        if keeps is not None:
            keeps.append(trainer.last_occ_keep)
    return ts, losses


def phase_main_path(torch, np, path: str, profile: bool):
    """One main path of PATHS: the chair widths plus its flags."""
    from hashnerf_torch import kernels
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer, train_loop

    spec = PATHS[path]
    flags = spec["flags"]
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_smoke_")
    try:
        args = parse_args([
            "--config", os.path.join(ROOT, "configs", "chair.txt"),
            "--dataset_type", "synthetic", "--basedir", workdir, "--no_reload",
            "--N_iters", "40", "--i_print", "1", "--i_weights", "40",
            "--i_testset", "40", "--i_video", "0", "--device", DEV, *flags,
        ])
        t0 = time.perf_counter()
        scene = make_synthetic_scene(H=128, W=128, n_train=8, n_test=2)
        scene_s = time.perf_counter() - t0

        logs = []
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_loop(args, scene, log_fn=logs.append)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0

        c0 = kernels.launch_counts()
        loop_peak = torch.cuda.max_memory_allocated() / 2**30  # its test-set render included
        torch.cuda.reset_peak_memory_stats()
        if spec["tv_start"] is not None:
            trainer.global_step = spec["tv_start"]
        keeps_tv = []
        tv_s, tv_losses = timed_steps(torch, trainer, 10, keeps_tv)  # TV on
        c1 = kernels.launch_counts()
        tv_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        trainer.global_step = spec["no_tv_start"]  # past the TV steps, as bench.py does
        keeps = []
        notv_s, notv_losses = timed_steps(torch, trainer, 20, keeps)
        c2 = kernels.launch_counts()
        notv_peak = torch.cuda.max_memory_allocated() / 2**30
        train_peak = max(tv_peak, notv_peak)  # training steps only
        for window, got, want in (("with", keeps_tv, spec["keeps_tv"]),
                                  ("without", keeps, spec["keeps_no_tv"])):
            require(all(k == want for k in got),
                    f"{path}: steps {window} TV not all at keeps {want}: {got}")
        k5_no_tv = c2["segment_accumulate_k5"] - c1["segment_accumulate_k5"]
        require((k5_no_tv > 0) == spec["k5_no_tv"],
                f"{path}: K5 launched {k5_no_tv} times in the steps without TV")

        prof = None
        if profile:
            prof = {"path": path, **profile_steps(torch, trainer, 3, statistics.median(notv_s))}

        # the same windows as CUDA graph replays (run_steps blocks)
        c_g0 = kernels.launch_counts()
        graphed = {"tv": graphed_window(torch, trainer, spec["graph_tv_start"], "tv", spec, profile),
                   "no_tv": graphed_window(torch, trainer, GRAPH_NO_TV_START, "no_tv", spec, profile)}
        c_g1 = kernels.launch_counts()
        k5_graphed_no_tv = graphed["no_tv"]["launches_per_step"]["segment_accumulate_k5"]
        require((k5_graphed_no_tv > 0) == spec["k5_no_tv"],
                f"{path}: K5 launched {k5_graphed_no_tv} times a graphed step without TV")
        for name in spec["kernels"]:
            require(c_g1[name] > c_g0[name], f"kernel {name} was not launched in {path}'s graphed windows")

        ckpt = os.path.join(workdir, "restore", "{:06d}.ckpt".format(trainer.global_step))
        trainer.save(ckpt)
        restored = Trainer(args, scene, device=DEV, seed=1)
        require(restored.try_restore(os.path.dirname(ckpt)), "checkpoint not restored")
        require(restored.global_step == trainer.global_step, "restored global_step differs")
        for (k, a), (_, b) in zip(trainer.state.state_dict().items(),
                                  restored.state.state_dict().items()):
            require(bool(torch.equal(a, b)), f"restored parameter {k} differs")

        t0 = time.perf_counter()
        rgb, depth, acc, _ = restored.render_image(scene.poses[scene.i_test[0]])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        gt = torch.as_tensor(scene.images[scene.i_test[0]], device=DEV)
        psnr = lambda img: float(-10.0 * torch.log10(torch.mean((img - gt) ** 2)))
        test_psnr = psnr(rgb)
        # without --occ_keep_eval the test view renders exact
        require(restored.eval_occ_grid is None, f"{path}: the restored trainer's render culls")
        culled = None
        if spec["eval_cull"] is not None:
            # the test view once more, culled with the eval budgets on the
            # trained grid (ready: its steps culled above)
            from hashnerf_torch.models.factory import query_fn
            from hashnerf_torch.render.renderer import render
            from hashnerf_torch.train.driver import render_config_from_args

            eval_cfg = render_config_from_args(parse_args([
                "--config", os.path.join(ROOT, "configs", "chair.txt"), *flags, *spec["eval_cull"],
            ])).eval_mode()
            t0 = time.perf_counter()
            rgb_c, _, _, _ = render(trainer.state, query_fn, scene.H, scene.W, scene.K, trainer.bbox,
                                    eval_cfg, c2w=torch.as_tensor(scene.poses[scene.i_test[0]],
                                                                  device=DEV),
                                    chunk=args.chunk, near=scene.near, far=scene.far,
                                    occ_grid=trainer.occ_grid)
            torch.cuda.synchronize()
            culled = {"render_s": time.perf_counter() - t0, "test_psnr": psnr(rgb_c),
                      "flags": spec["eval_cull"],
                      "occupied_cells": int((trainer.occ_grid > 0).sum())}
            require(rgb_c.shape == (scene.H, scene.W, 3), f"culled render shape {tuple(rgb_c.shape)}")
            require(bool(torch.isfinite(rgb_c).all()), "non-finite culled render")
        counts = kernels.launch_counts()

        losses = [h[1] for h in trainer.history] + tv_losses + notv_losses
        require(rgb.shape == (scene.H, scene.W, 3), f"render shape {tuple(rgb.shape)}")
        require(bool(torch.isfinite(rgb).all()), "non-finite render")
        require(all(np.isfinite(losses)), "non-finite loss")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]), "loss did not fall")
        for name in spec["kernels"]:
            require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
        for name in OFF_PATH:
            require(counts[name] == 0, f"kernel {name} was launched on the {path} path")

        per_step = lambda a, b, n: {k: (b[k] - a[k]) / n for k in a}
        rec = {
            "phase": "main_path", "path": path, "flags": list(flags),
            "config": "configs/chair.txt widths on make_synthetic_scene(128, 128, 8 train, 2 test)",
            "N_rand": args.N_rand, "samples": args.N_samples + args.N_importance,
            "scene_s": scene_s, "train_loop_40_steps_s": loop_s,
            "testset_log": [ln for ln in logs if "test set" in ln],
            "loss_first5": losses[:5], "loss_last5": losses[-5:],
            "step_ms_tv": [t * 1e3 for t in tv_s], "step_ms_no_tv": [t * 1e3 for t in notv_s],
            "train_rays_per_s_tv": args.N_rand / statistics.median(tv_s),
            "train_rays_per_s_no_tv": args.N_rand / statistics.median(notv_s),
            "launches_per_step_tv": per_step(c0, c1, len(tv_s)),
            "launches_per_step_no_tv": per_step(c1, c2, len(notv_s)),
            "render_s": render_s, "test_psnr": test_psnr, "culled_eval_render": culled,
            "tv_start": spec["tv_start"], "no_tv_start": spec["no_tv_start"],
            "keeps_tv": keeps_tv, "keeps_no_tv": keeps,
            "peak_mem_gib_training": train_peak, "peak_mem_gib_tv": tv_peak,
            "peak_mem_gib_no_tv": notv_peak,
            "peak_mem_gib": max(loop_peak, torch.cuda.max_memory_allocated() / 2**30),
            "graphed": graphed,
            "train_rays_per_s_graphed_tv": graphed["tv"]["train_rays_per_s_graphed"],
            "train_rays_per_s_graphed_no_tv": graphed["no_tv"]["train_rays_per_s_graphed"],
            "launches": counts,
        }
        emit(rec)
        if prof is not None:
            emit(prof)
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def row_gate(got, want):
    """(entries outside, max |got - want|) under the atomics' gate of K5 and
    K6, row by row: |got - want| <= 2e-5 * sum(|want row|) + 1e-6, a row
    the last axis of a table or weight (each entry of a 1-d tensor)."""
    bad, worst = 0, 0.0
    for g, w in zip(got, want):
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() > 1 else w.reshape(-1, 1)
        d = (g.detach().reshape(w2.shape) - w2).abs()
        bad += int((d > 2e-5 * w2.abs().sum(-1, keepdim=True) + 1e-6).sum())
        worst = max(worst, float(d.max()))
    return bad, worst


# The graph-against-eager gate. Two eager runs of 16 steps from one state
# and one generator state already leave entries outside the atomics' row
# gate (row_gate) once RAdam has normalised 16 steps of near-cancelling
# table gradients: on an H100, 0.004-0.022% of the chair's entries and
# 0.0006-4.1% of the packed path's, all in the tables (PERF.md §6). The
# flagship's runs leave 0-3 entries outside. So each group of state
# (GATE_GROUPS: the tables, the MLP weights, the occupancy grid) is held to
# its own spread in this run: two graphed runs, each against an eager run
# of its own, and the fewer entries outside the row gate of the two pairs
# at most GATE_SPREAD_FACTOR times the more of the eager pair and the
# graphed pair (at least 1 entry). The last loss must be within
# GATE_LOSS_RTOL or 10x the pairs' loss differences. A wrong learning rate,
# draw, keep budget or grid update moves most entries of its group.
GATE_GROUPS = {
    "tables": lambda tr: tr.state.table_parameters(),
    "mlp": lambda tr: tr.state.net_parameters(),
    "grid": lambda tr: [tr.occ_grid] if tr.occ_grid is not None else [],
}
GATE_SPREAD_FACTOR = 3
GATE_LOSS_RTOL = 1e-4


def graphed_window(torch, trainer, start: int, window: str, spec, profile: bool):
    """From global_step `start`: GRAPH_BLOCK eager steps twice, and the same
    steps twice as a run_steps block (CUDA graphs: the capture, then
    replays), each from the same state and generator state, held to the
    gate above. Then GRAPH_TIMED_BLOCKS[window] timed blocks, each closed
    by a host read. Every graphed step must cull at the window's keeps."""
    from hashnerf_torch import kernels

    args, n = trainer.args, GRAPH_BLOCK
    want_keep = spec["keeps_tv" if window == "tv" else "keeps_no_tv"]
    precrop = start + 1 < args.precrop_iters
    snap = [t.detach().clone() for t in trainer.training_state()]
    rng, ready = trainer.generator.get_state(), trainer._occ_ready

    def from_snapshot():
        with torch.no_grad():
            for t, s in zip(trainer.training_state(), snap):
                t.copy_(s)
        trainer.generator.set_state(rng)
        trainer.global_step, trainer._occ_ready = start, ready

    def run(graphed: bool):
        from_snapshot()
        if graphed:
            m = trainer.run_steps(n, block_size=n, precrop=precrop)
        else:
            for _ in range(n):
                m = trainer.step(trainer.sample_batch(precrop))
        state = {g: [t.detach().clone() for t in of(trainer)] for g, of in GATE_GROUPS.items()}
        return state, float(m["loss"])

    eager, eager_loss = run(False)
    eager2, eager2_loss = run(False)
    t0 = time.perf_counter()
    graph, graph_loss = run(True)  # the capture, then the replays
    first_block_s = time.perf_counter() - t0
    graph2, graph2_loss = run(True)
    del snap
    pairs = {"graph_vs_eager": (graph, eager), "graph2_vs_eager2": (graph2, eager2),
             "eager_vs_eager": (eager2, eager), "graph_vs_graph": (graph2, graph)}
    gate = {"last_loss": {"graph": graph_loss, "eager": eager_loss, "eager_again": eager2_loss,
                          "graph_again": graph2_loss}}
    for group in GATE_GROUPS:
        if not eager[group]:
            continue
        g = gate[group] = {"entries": sum(t.numel() for t in eager[group])}
        for name, (a, b) in pairs.items():
            bad, worst = row_gate(a[group], b[group])
            g[name] = {"outside_row_gate": bad, "max_abs_diff": worst}
        out = lambda name: g[name]["outside_row_gate"]
        g["allowed"] = GATE_SPREAD_FACTOR * max(out("eager_vs_eager"), out("graph_vs_graph"), 1)
        require(min(out("graph_vs_eager"), out("graph2_vs_eager2")) <= g["allowed"],
                f"graphed block from step {start} is not the {n} eager steps ({group}): {gate}")
    del pairs, eager, eager2, graph, graph2
    loss_tol = max(GATE_LOSS_RTOL * abs(eager_loss),
                   10 * max(abs(eager2_loss - eager_loss), abs(graph2_loss - graph_loss)))
    require(min(abs(graph_loss - eager_loss), abs(graph2_loss - eager2_loss)) <= loss_tol,
            f"graphed block from step {start}: last loss off the eager steps': {gate}")
    keeps = [trainer.last_occ_keep]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c0 = kernels.launch_counts()
    ts, losses = [], [graph2_loss]
    for _ in range(GRAPH_TIMED_BLOCKS[window]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.run_steps(n, block_size=n, precrop=precrop)
        losses.append(float(m["loss"]))
        ts.append(time.perf_counter() - t0)
        keeps.append(trainer.last_occ_keep)
    c1 = kernels.launch_counts()
    require(all(k == want_keep for k in keeps),
            f"graphed blocks from step {start}: not all at keeps {want_keep}: {keeps}")
    require(all(math.isfinite(x) for x in losses), f"graphed blocks from step {start}: non-finite loss")
    step_s = statistics.median(ts) / n
    rec = {
        "start": start, "block": n, "precrop": precrop, "gate": gate,
        "first_block_s_with_capture": first_block_s,
        "block_ms": [t * 1e3 for t in ts], "step_ms_graphed": step_s * 1e3,
        "train_rays_per_s_graphed": args.N_rand / step_s, "keeps": keeps, "losses": losses,
        "launches_per_step": {k: (c1[k] - c0[k]) / (n * len(ts)) for k in c0},
        "peak_mem_gib_graphed": torch.cuda.max_memory_allocated() / 2**30,
        "reserved_gib_graphed": torch.cuda.memory_reserved() / 2**30,
    }
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            float(trainer.run_steps(n, block_size=n, precrop=precrop)["loss"])
        rows = kernel_times(p)
        busy_s = sum(r[0] for r in rows) / 1e6 / n
        rec.update({
            "device_busy_ms_per_step": busy_s * 1e3, "device_busy_share": busy_s / step_s,
            "device_ops_per_step": sum(r[2] for r in rows) / n,
            "top": [{"name": k[:90], "ms_per_step": dt / 1e3 / n, "calls_per_step": c / n}
                    for dt, k, c in rows[:12]],
        })
    return rec


def profile_steps(torch, trainer, n: int, step_s: float):
    """torch.profiler over n steps: device time by kernel (device-side
    events only, so operator ranges are not counted twice), and busy share.

    The profiler slows the host about twofold, so the busy share of a real
    step divides the device time per step by `step_s`, the median
    unprofiled step of the same run; the share of the profiled wall is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    timed_steps(torch, trainer, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        timed_steps(torch, trainer, n)
        wall = time.perf_counter() - t0
    rows = kernel_times(p)
    busy_s = sum(r[0] for r in rows) / 1e6 / n
    return {
        "phase": "profile", "steps": n,
        "device_busy_ms_per_step": busy_s * 1e3,
        "step_ms_unprofiled": step_s * 1e3,
        "device_busy_share": busy_s / step_s,
        "step_ms_profiled": wall * 1e3 / n,
        "device_busy_share_of_profiled_wall": busy_s * n / wall,
        "device_ops_per_step": sum(r[2] for r in rows) / n,
        "top": [{"name": k[:90], "ms_per_step": dt / 1e3 / n, "calls_per_step": c / n}
                for dt, k, c in rows[:25]],
    }


def phase_bench(torch):
    """The line of `python -m hashnerf_torch.bench`, for the flagship and
    for BENCH_PARITY=1 (the chair step), run in this process."""
    from hashnerf_torch import bench

    out = {}
    for name, env in (("flagship", {}), ("parity", {"BENCH_PARITY": "1"})):
        t0 = time.perf_counter()
        line = bench.run(env)
        print(json.dumps(line), flush=True)
        out[name] = {**line, "env": env, "seconds": time.perf_counter() - t0}
        emit({"phase": "bench", "config": name, **out[name]})
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None, help="also write every record to this JSON file")
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import hashnerf_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import hashnerf_torch ({e}); run from the repo root",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_k1_cases(torch, np)
    kern = phase_hash_kernels(torch, np)
    k4_hot = phase_k4_cases(torch, np)
    k5_hot = phase_k5_cases(torch, np)
    geo = phase_packed_rows(torch, np)
    packed = phase_packed_kernels(torch, np, geo)
    del geo
    occupancy, kept_pts = phase_occupancy(torch, np)
    culled_k5 = phase_culled_k5(torch, np, kept_pts)
    packed_enc = phase_packed_encode(torch, np, kept_pts)
    del kept_pts
    torch.cuda.empty_cache()
    paths = {path: phase_main_path(torch, np, path, opts.profile) for path in PATHS}
    benches = phase_bench(torch)

    fine = packed["shapes"]["fine_slabs"]
    kern["segment_accumulate_k4"] = {
        "max_abs_err": fine["max_abs_err"], "kernel_ms": fine["kernel_ms"],
        "plain_ms": fine["plain_ms"], "library_ms": fine["library_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
    }
    lines = []
    for name, info in KERNEL_INFO.items():
        k = kern[name]
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        lines.append({
            "name": name, "route": "cuda", **info,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    summary = {"kernels": lines}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"device": dev, "kernels": kern, "k4_hot_row": k4_hot, "k5_hot_rows": k5_hot,
                       "packed_kernels": packed, "occupancy": occupancy, "culled_k5": culled_k5,
                       "packed_encode": packed_enc, "main_paths": paths, "bench": benches,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"card: {dev['smi']}", flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

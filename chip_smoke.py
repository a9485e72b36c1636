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
    - K1, K2, K3 on the five cases of tests/test_kernels.py and at the chair
      shapes of the reference-exact path (N = 196,608 points = 1024 rays x
      192 samples, L = 16, T = 2^19, F = 2, so M = 25,165,824 updates);
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
 3. main paths, each at the width of configs/chair.txt on the procedural
    scene (128 x 128, 8 train views) through
    hashnerf_torch.train.driver.train_loop (40 steps with TV, a checkpoint,
    a test-set render), then 10 timed steps with TV and 20 without, a
    checkpoint restored bit for bit and one test view rendered:
    - chair: the reference-exact hash-grid step (K2, K3, K5);
    - packed: the same with --n_levels 4 --n_features_per_level 8
      --packed_layout --share_fine --compute_dtype bfloat16 --aabb_clip
      (K5);
    the launch counts are set to 0 before each path and read after it, and
    each kernel of a path must have been launched there;
 4. prints one line {"kernels": [...]} with each kernel's launches on the
    main paths, error, times and bound, and as the last line
    {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line. It exits non-zero at once when no CUDA device is present or when
hashnerf_torch cannot be imported (a directory holding only this script).
`--profile` adds a torch.profiler breakdown of three steps without TV of
each path.
"""
from __future__ import annotations

import argparse
import json
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
# 8 x F multiply-adds) or the expansion (K3: 8 x F products + 8 level adds).
GEOM_OPS = 36 + 19 + 64
K2_OPS = GEOM_OPS + 16 * HASH_F
K3_OPS = GEOM_OPS + 8 * HASH_F + 8

# Packed path (--n_levels 4 --n_features_per_level 8 --packed_layout at the
# chair widths): 2 dense levels (res 16, 50) and 2 fine levels of 2^16 block
# rows; a fine slab is 27 * 8 = 216 floats, a dense voxel row 8 * 8 = 64.
PACKED_FLAGS = ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout",
                "--share_fine", "--compute_dtype", "bfloat16", "--aabb_clip"]
PACKED_L, PACKED_F, PACKED_LOG2_BLOCKS = 4, 8, 16
N_COARSE = 1024 * 64

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
}
# kernels each main path must launch (K1 and K4 keep the sorted contract,
# which no path calls since K5)
PATH_KERNELS = {
    "chair": ("segment_accumulate_k5", "hash_encode_fwd", "hash_encode_bwd_expand"),
    "packed": ("segment_accumulate_k5",),
}


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


def phase_hash_kernels(torch, np):
    """K2, K3 and K1 at the chair shapes, against their plain versions."""
    from hashnerf_torch.kernels.hash_encode import (
        hash_encode_bwd_expand, hash_encode_bwd_expand_plain,
        hash_encode_fwd, hash_encode_fwd_plain,
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
    # K5 on K3's output as it comes, as HashEncode.backward calls it
    d_k5 = segment_accumulate_k5(flat_idx, vals, L * T)
    torch.cuda.synchronize()
    k5_err = float((d_k5 - d_plain).abs().max())

    # K3 + K1 (the HashEncode backward) against autograd of the plain encode
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
    del t_req, fp, auto, abs_sum, bwd_err

    require(keep_equal, "K2 keep mask differs from the plain version")
    require(feat_bad == 0, f"K2: {feat_bad} points outside rtol 1e-5 / atol 1e-7")
    require(corner_bad == 0, f"K3: {corner_bad} points hash to other corners")
    require(bool(torch.allclose(vals, vals_p, rtol=1e-6, atol=0.0)), "K3 values differ")
    require(bool(torch.allclose(d_table, d_plain, rtol=1e-4, atol=1e-4)),
            f"K1 chair shape: max_abs_err {k1_err}")
    require(bwd_ok, f"K3+K1 vs autograd: max_abs_err {bwd_err_max}")
    require(k5_ok, f"K5 chair shape: max_abs_err {k5_err}")
    require(bwd5_ok, f"K3+K5 vs autograd: max_abs_err {bwd5_err_max}")

    # timings (median of CUDA events)
    k2_ms = cuda_ms(torch, lambda: hash_encode_fwd(table, x, bmin, bmax, res))
    k2_plain_ms = cuda_ms(torch, lambda: hash_encode_fwd_plain(table, x, bmin, bmax, res), reps=5)
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
    k2_bound = bound(N * 12 + unique_rows * F * 4 + N * L * F * 4 + N + 24 + L * 4,
                     N * L * K2_OPS)
    k3_bound = bound(N * 12 + N * L * F * 4 + M * 4 + M * F * 4 + 24 + L * 4,
                     N * L * K3_OPS)
    out = {
        "hash_encode_fwd": {
            "shape": {"N": N, "L": L, "T": T, "F": F}, "keep_equal": keep_equal,
            "keep_fraction": float(keep.float().mean()),
            "feat_mismatch_points": feat_bad, "corner_mismatch_points": corner_bad,
            "max_abs_err": k2_err, "kernel_ms": k2_ms, "plain_ms": k2_plain_ms,
            "library_ms": None, "touched_rows": unique_rows,
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
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


# --------------------------------------------------------------------------- #
# Phase 3
# --------------------------------------------------------------------------- #

def timed_steps(torch, trainer, n: int):
    """Host-clock seconds of n train steps (ray sampling included), each
    closed by a synchronize; returns (seconds, losses)."""
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
    return ts, losses


def phase_main_path(torch, np, path: str, flags, profile: bool):
    """One main path: the chair widths plus `flags`; `path` names it."""
    from hashnerf_torch import kernels
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer, train_loop

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
        tv_s, tv_losses = timed_steps(torch, trainer, 10)  # global_step 41-50: TV on
        c1 = kernels.launch_counts()
        trainer.global_step = 1001  # past the TV warmup, as bench.py does
        notv_s, notv_losses = timed_steps(torch, trainer, 20)
        c2 = kernels.launch_counts()
        train_peak = torch.cuda.max_memory_allocated() / 2**30  # training steps only

        prof = None
        if profile:
            prof = {"path": path, **profile_steps(torch, trainer, 3, statistics.median(notv_s))}

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
        test_psnr = float(-10.0 * torch.log10(torch.mean((rgb - gt) ** 2)))
        counts = kernels.launch_counts()

        losses = [h[1] for h in trainer.history] + tv_losses + notv_losses
        require(rgb.shape == (scene.H, scene.W, 3), f"render shape {tuple(rgb.shape)}")
        require(bool(torch.isfinite(rgb).all()), "non-finite render")
        require(all(np.isfinite(losses)), "non-finite loss")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]), "loss did not fall")
        for name in PATH_KERNELS[path]:
            require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")

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
            "render_s": render_s, "test_psnr": test_psnr,
            "peak_mem_gib_training": train_peak,
            "peak_mem_gib": max(loop_peak, torch.cuda.max_memory_allocated() / 2**30),
            "launches": counts,
        }
        emit(rec)
        if prof is not None:
            emit(prof)
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def profile_steps(torch, trainer, n: int, step_s: float):
    """torch.profiler over n steps: device time by kernel (device-side
    events only, so operator ranges are not counted twice), and busy share.

    The profiler slows the host about twofold, so the busy share of a real
    step divides the device time per step by `step_s`, the median
    unprofiled step of the same run; the share of the profiled wall is
    printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    timed_steps(torch, trainer, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        timed_steps(torch, trainer, n)
        wall = time.perf_counter() - t0
    rows = []
    for ev in p.key_averages():
        # operator and record_function ranges mirrored onto the device
        # timeline span the kernels they launch: count the kernels only
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt, ev.key, ev.count))
    rows.sort(reverse=True)
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
    torch.cuda.empty_cache()
    paths = {
        "chair": phase_main_path(torch, np, "chair", [], opts.profile),
        "packed": phase_main_path(torch, np, "packed", PACKED_FLAGS, opts.profile),
    }

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
                       "packed_kernels": packed,
                       "main_paths": paths, "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"card: {dev['smi']}", flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

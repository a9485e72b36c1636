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
      the bound on the blend's summation order, BLEND_ORDER_RTOL); K6 also
      on the (x, g) the chair path's step RECORDED_STEP hands it, zero
      cotangent rows and all (recorded_encode_inputs);
    - K5, the sort-free scatter-add, on the same five cases and three at
      F = 216, each with its ids shuffled and sorted, on ids outside the
      table and on one hot row at each width; then at the chair shape and
      at every packed shape below, beside the sort + K1/K4 route it
      replaces and `index_add_`, and over its wide-row chunk sizes; and at
      the TV losses' own row ids (tv_rows: the chair's hash-grid cubes, the
      packed dense cubes and slabs), timed in turns with `index_add_`
      (phase_tv_k5);
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
    - packed_encode: K7 and K8, the packed encode's forward and
      fused backward, against their plain versions and against the
      torch-ops route they replaced (packed_encode_ops), at the packed
      passes (196,608 uniform and ray-ordered points, 65,536), the
      flagship's culled passes (24,576 at keep 0.125, 98,304 at 0.5) and
      tpu-quality's L8 / F4 widths (196,608 and 98,304), and on the (x, g)
      the packed path's fine pass hands K8 at step RECORDED_STEP, the
      tables x 1e4;
      timed with CUDA events and from a profiler trace beside their bounds
      (packed_case);
    - the field query's copies: K9 (NeRFSmall's colour input) and
      field_raw (the query's raw), forward and backward, at the render
      chunk's passes (32,768 rays x 64 and x 192 samples), the chair's
      training passes (1024 x 64 and x 192), the flagship's culled blocks
      (3072 x 8) and a grid update's 65,536 points, each equal to its
      plain version on the same card tensors, with and without the view
      encoding and the keep mask; timed beside its plain version and its
      byte bound (phase_field_kernels); and field_mlp_fwd and
      field_mlp_fwd_f32, NeRFSmall's bf16 and float32 forward in one
      kernel, at the same shapes: bit for bit their in-order arithmetic
      (field_mlp_fwd_ordered), close to their plain version, timed beside
      it and their bound;
 3. main paths, each at the width of configs/chair.txt on the procedural
    scene (128 x 128, 8 train views) through
    hashnerf_torch.train.driver.train_loop (40 steps with TV, a checkpoint,
    a test-set render), then 10 timed steps with TV and 20 without, a
    checkpoint restored bit for bit and one test view rendered:
    - chair: the reference-exact hash-grid step (K2, K6; K5 from the TV
      loss only);
    - packed: the same with --n_levels 4 --n_features_per_level 8
      --packed_layout --share_fine --compute_dtype bfloat16 --aabb_clip
      (K7, K8; K5 from the TV loss only);
    - flagship: packed with the occupancy culling of the JAX package's
      tpu-fast preset (global block-8 culling, coarse keep 0.375, fine keep
      annealed 0.5 / 0.25 / 0.125 from steps 0 / 512 / 1024, adaptive grid
      updates every 16 steps, warmup 256), all but --steps_per_dispatch.
      Its 10 steps with TV start at global_step 256, where the warmup
      ends, so each must run culled at keep 0.5 (fine) and 0.375 (coarse);
      its 20 without TV start at 1024, each culled at 0.125 and 0.375, and
      K7 and K8 must launch in them, K5 not; the test view is rendered exact and culled
      (--occ_keep_eval 0.75 --occ_eval_transmittance);
    then each path's two windows again as Trainer.run_steps blocks of 16
    steps, replayed from CUDA graphs (--steps_per_dispatch): with TV (from
    step 48, the flagship from 256) and without (from 1024). Each window
    is held to the graph gate (graphed_window, GATE_*): one step eager and
    from a fresh capture, from the same state and generator state, with
    bit-equal MLP gradients and table gradients inside the atomics' row
    gate; then 16 steps, eager and as a block, their tables, MLP weights
    and grid each within the runs' spread or the group's floor. Then 3-4
    blocks are timed; the flagship's graphed steps must cull at their
    budgets, and the kernels must launch in the replays (counted per
    replay).
    PATHS holds what each path runs and must show. The launch counts are
    set to 0 before each path and read after it; each kernel of a path
    must have been launched there, and K1, K3 and K4 on no path;
 4. blender: the blender path end to end through hashnerf_torch.run_nerf.main
    (phase_blender): an 800 x 800 RGBA set of 16 / 2 / 4 frames written by
    hashnerf_torch.tools.make_blender_dataset, loaded back with 0
    differences from the frames written; configs/chair.txt trained on it
    (half_res: 400 x 400) for 600 steps with a checkpoint, the test set's
    figures and PSNR pickle and the 40-frame spiral video at the last step,
    then 10 steps timed as the main paths time theirs; --render_only
    --render_test, whose PSNRs must equal the training run's, and
    --render_only --render_factor 4; --preset tpu-fast for 320 steps, every
    step from the warmup (256) on culled at its budgets, with the same
    outputs; and the JAX package's checkpoint fixture
    (tests/golden/jax_smoke_ckpt) restored by load_jax_checkpoint and
    rendered within JAX_VIEW_*_TOL of the view the JAX package rendered.
    The launch counts are set to 0 before it and read after: K2, K6 and K5
    must launch, K1, K3 and K4 not;
 5. llff: the LLFF forward-facing path end to end (phase_llff): a set of
    fern's layout and size written by llff_set (20 frames, poses_bounds.npy
    with fern's 3024 x 4032 hwf, images_8 PNGs of 378 x 504 from the
    procedural tracer), loaded back with 0 differences; configs/fern.txt
    trained on it through run_nerf.main with ray batching (a shuffled pool
    of every training ray on the card) and NDC rays for 300 steps, with
    the test set's 3 views, their PSNR pickle and the 120-frame spiral
    video at the last step; --render_only --render_test (PSNRs equal to the
    training run's) and --render_factor 4; then timed eager pool steps and
    two graphed pool windows (Trainer.run_steps blocks of 16 on the pool,
    held to the graph gate); K2 and K6 on the coarse and fine sample
    points of a pool batch in the NDC box, held to their plain versions;
    one test view rendered whole on the card, then every 8th row and the
    rays near a step function of sample_pdf or the keep mask held against
    the CPU's plain path stage by stage (view_gate: the coarse pass, the
    fine pass at the card's samples, the placement; JAX_VIEW_*_TOL), a
    failure's state, rays and stages saved to VIEW_FAILURE_FILE. K2, K6
    and K5 (every TV step) must launch on it, K1, K3 and K4 not;
 6. st3d: the panorama path end to end (phase_st3d, ST3D_*): a procedural
    512 x 1024 RGB-D panorama of a room written by st3d_set, 100 train
    views with occlusion masks and 10 test views made from it by
    hashnerf_torch.tools.generate_equirect_data, loaded (host peak traced);
    configs/st3d.txt through run_nerf.main as written (hash grid,
    NeRFSmall, use_gradient vestigial: K2, K6, K5 while TV is on) and as
    OmniNeRF's model (positional NeRFGradient 8 x 256, Adam, depth and
    gradient supervision: no kernel of kernels.KERNELS), each in graphed pool
    blocks of 16 with the test set (statistics.txt, video2.gif) at the last
    step; then the pool again from the loader's rays (its rows the
    loader's), eager pool steps and graphed pool windows held to the graph
    gate, one panorama timed; for the hash run K2 and K6 on the coarse and
    fine sample points of a pool batch, held to their plain versions; for
    OmniNeRF one step on the card against the CPU's float64 step (its TF32
    and bf16 controls stopped by the same gate) and every 8th row of the
    ground-truth panorama on the card against the CPU;
 7. loaders: scannet (configs/scannet_scene0000.txt, 1296 x 968 frames, a
    binary PLY), deepvoxels (positional NeRF 8 x 256, 512 x 512) and
    LINEMOD (hash defaults, its K, the +-10 box), each written by
    loader_set from the procedural tracer and trained 64 steps through
    run_nerf.main with one test view (phase_loaders, LOADERS);
    PATHS["st3d"] and PATHS["loaders"] name the kernels each run must
    launch, and every other kernel must show 0 launches there;
    after the loaders, the chair at --compute_dtype float32 for a few steps
    (chair_float32_run: K2, K6 and K5 for TV, finite falling losses);
 8. tools (phase_tools, slice 12): the A9 tools on the blender phase's 800 x
    800 set (kept for it): the chair for 96 steps with a checkpoint every
    32, each checkpoint rendered by tools/run_all_checkpoints.py and a GIF
    of them by tools/make_gif.py (3 frames, in order); tools/render_bench.py
    on a set of its own with 17 test frames (TOOLS_BENCH_SET: JAX's testskip
    8 keeps 3; 256 steps of the flagship, those 3 full frames exact and at
    keep 0.5);
    tools/profile_step.py in both modes, and K2 and K6 at its encode shape
    (49,152 points, L 8, F 4) held to their plain versions;
    hashnerf_torch/bench_quality.py (QB_ITERS 256) and
    tools/quality_summary.py; tools/parity_curve.py for 3 seeds at 640
    steps, whose gate against the recorded PyTorch-reference curves must
    pass; collective_volumes (1 NCCL rank, then MULTI_GLOO_WORLD gloo ranks)
    and project_two_host, their payload bytes held to SCALING_r05.json
    where the shapes match (SCALING_*); graft_entry.entry() finite, and
    against the CPU on rays that absorb most of their light. PATHS["tools"]'s kernels must launch there, K1, K3 and K4 not. The
    three host plots (plot_losses, pose_visualizer, blender_render_poses)
    need matplotlib, which the card's host lacks: tests/test_torch_tools.py
    runs them on the CPU;
 9. multi (phase_multi): W NCCL ranks, one a card (1 on a one-card
    machine), then MULTI_GLOO_WORLD gloo ranks sharing card 0; each rank
    runs the chair through run_nerf.main --num_devices W (graphed under
    NCCL), ZeRO-1, the table-sharded trainer and the tpu-fast flagship
    with global culling (multi_flagship: eager windows at the schedule's
    budgets, the graph gate under NCCL, one step against the one-process
    flagship, the culling's collectives timed, K5 on the rank's share of
    the kept blocks); PATHS["multi"] names each run's kernels;
10. prints one line {"kernels": [...]} with each kernel's launches on the
    main paths, the blender, llff, st3d, loaders, tools and multi phases
    (graph replays included), error, times and bound (K5's at the packed
    TV's slabs, K4's at the packed fine slabs, K7's and K8's at the packed
    fine pass, the others' at the chair's shapes), the total seconds and
    the card, and as the last line {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line. It exits non-zero at once when no CUDA device is present or when
hashnerf_torch cannot be imported (a directory holding only this script).
`--profile` adds a torch.profiler breakdown of three eager steps without TV
of each path and of the llff and st3d pool steps (for OmniNeRF with its
GEMMs' share), of one graphed block of each window, and of three chair
steps with TV on the blender set.
"""
from __future__ import annotations

import argparse
import contextlib
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

# What each kernel of hashnerf_torch.kernels.KERNELS replaces of the JAX
# package; kernel_info adds its source, the csrc/ library of its Kernel.
REPLACES = {
    "segment_accumulate_k1": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    "hash_encode_fwd": "hashnerf_tpu/kernels/hash_encode_vjp.py:63",
    "hash_encode_bwd_expand": "hashnerf_tpu/kernels/hash_encode_vjp.py:82",
    "segment_accumulate_k4": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    "segment_accumulate_k5": "hashnerf_tpu/kernels/pallas_segment_accum.py:134",
    "hash_encode_bwd": "hashnerf_tpu/kernels/hash_encode_vjp.py:82",
    "packed_encode_fwd": "hashnerf_tpu/ops/packed_grid.py:174",
    "packed_encode_bwd": "hashnerf_tpu/ops/packed_grid.py:174 (its VJP) and "
                         "hashnerf_tpu/kernels/pallas_segment_accum.py:134 (through take_rows)",
    # The field query's copies: no TPU kernel (XLA fuses the JAX package's
    # concatenations into their consumers)
    **dict.fromkeys(("field_colour_input_fwd", "field_colour_input_bwd", "field_raw_fwd",
                     "field_raw_bwd"), "none"),
    # NeRFSmall's whole bf16 and float32 forward without a gradient: no TPU
    # kernel (XLA fuses the casts, ReLUs and concatenations into the dots)
    "field_mlp_fwd": "none",
    "field_mlp_fwd_f32": "none",
}


def kernel_info():
    """{name: {"source", "replaces"}} for every kernel the port registers."""
    from hashnerf_torch import kernels

    require(set(kernels.KERNELS) == set(REPLACES),
            f"kernels {sorted(kernels.KERNELS)}, REPLACES {sorted(REPLACES)}")
    return {name: {"source": f"hashnerf_torch/csrc/{kernels.KERNELS[name].lib}.cu",
                   "replaces": r} for name, r in REPLACES.items()}


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
#   K6 reduces the encode's gradient, and on the packed paths K8 reduces
#   the packed encode's);
# - eval_cull: the flags of a second test-view render, culled on the
#   trained grid (None: none);
# - graph_tv_start: the global_step of the graphed window with TV; the one
#   without TV starts at GRAPH_NO_TV_START. Each graphed window runs
#   Trainer.run_steps blocks of GRAPH_BLOCK steps (CUDA graph replays), must
#   keep the eager window's keeps and K5 rule and launch the path's kernels,
#   and must pass the graph gate (graphed_window, GATE_*);
# - mlp_fused: the one of MLP_FUSED + MLP_FUSED_F32 that must launch on the
#   path (the other must not): a bf16 or float32 net's renders and grid
#   updates take no gradient.
# NeRFSmall's colour input (K9) and raw (field_raw), forward and backward:
# every path of the hash grid's MLP launches them, the NeRF family none.
# MLP_FUSED: NeRFSmall's one-kernel bf16 forward, wherever a bf16 net takes
# no gradient: the packed and flagship paths' renders and grid updates.
# MLP_FUSED_F32: the float32 one, wherever a float32 NeRFSmall renders: the
# chair path's and the hash grid's test views.
FIELD_KERNELS = ("field_colour_input_fwd", "field_colour_input_bwd", "field_raw_fwd",
                 "field_raw_bwd")
CHAIR_KERNELS = ("hash_encode_fwd", "hash_encode_bwd", "segment_accumulate_k5") + FIELD_KERNELS
# The packed layout's encode (K7, K8), K5 for its TV loss, and the MLP's K9.
PACKED_KERNELS = ("packed_encode_fwd", "packed_encode_bwd", "segment_accumulate_k5") + FIELD_KERNELS
MLP_FUSED = ("field_mlp_fwd",)
MLP_FUSED_F32 = ("field_mlp_fwd_f32",)
PATHS = {
    "chair": {"flags": [],
              "kernels": CHAIR_KERNELS,
              "tv_start": None, "no_tv_start": 1001, "keeps_tv": None, "keeps_no_tv": None,
              "k5_no_tv": False, "eval_cull": None, "graph_tv_start": 48,
              "mlp_fused": "field_mlp_fwd_f32"},
    "packed": {"flags": PACKED_FLAGS, "kernels": PACKED_KERNELS,
               "tv_start": None, "no_tv_start": 1001, "keeps_tv": None, "keeps_no_tv": None,
               "k5_no_tv": False, "eval_cull": None, "graph_tv_start": 48,
               "mlp_fused": "field_mlp_fwd"},
    "flagship": {"flags": FLAGSHIP_FLAGS, "kernels": PACKED_KERNELS + MLP_FUSED,
                 "tv_start": 256, "no_tv_start": 1024, "keeps_tv": (0.5, 0.375),
                 "keeps_no_tv": FLAGSHIP_KEEP, "k5_no_tv": False, "eval_cull": EVAL_CULL_FLAGS,
                 "graph_tv_start": 256, "mlp_fused": "field_mlp_fwd"},
    # Phases of their own (slice 9), not run by phase_main_path: each run
    # of the phase must launch exactly the kernels listed for it (K5 for
    # the TV loss of the hash grid's steps <= 1000, the float32 MLP kernel
    # for a hash grid's test view) and no other kernel of kernels.KERNELS;
    # nothing is culled.
    "st3d": {"phase": "st3d", "keeps_tv": None, "keeps_no_tv": None,
             "runs": {"hash": CHAIR_KERNELS + MLP_FUSED_F32, "omninerf": ()}},
    "loaders": {"phase": "loaders", "keeps_tv": None, "keeps_no_tv": None,
                "runs": {"scannet": CHAIR_KERNELS + MLP_FUSED_F32,
                         "deepvoxels": (),
                         "LINEMOD": CHAIR_KERNELS + MLP_FUSED_F32,
                         # slice 11: the chair's MLPs at --compute_dtype float32
                         "chair_float32": CHAIR_KERNELS}},
    # Slice 10 (phase_multi): each rank's chair path (TV on: K5), ZeRO-1
    # and table-sharded runs (TV off: no K5), under NCCL and over gloo.
    # Slice 11: the flagship (tpu-fast, global culling) on each rank, its
    # kept blocks shared over the ranks: K7, K8, and K5 for TV.
    # Slice 12 (phase_tools): the A9 tools on the card; the chair's runs
    # (K2, K6; K5 for TV; the float32 MLP kernel for their renders), the
    # flagship's render_bench and profile_step (K7, K8), and the encode
    # alone (K2, K6).
    "tools": {"phase": "tools", "keeps_tv": None, "keeps_no_tv": None,
              "kernels": CHAIR_KERNELS + PACKED_KERNELS[:2] + MLP_FUSED + MLP_FUSED_F32},
    "multi": {"phase": "multi", "keeps_tv": None, "keeps_no_tv": None,
              "runs": {"path": CHAIR_KERNELS,
                       "zero": ("hash_encode_fwd", "hash_encode_bwd") + FIELD_KERNELS,
                       "table": ("hash_encode_fwd", "hash_encode_bwd") + FIELD_KERNELS,
                       "flagship": PACKED_KERNELS + MLP_FUSED},
              # what rank 0 alone launches besides: its test-set render
              "main_rank": {"path": MLP_FUSED_F32}},
}
MAIN_PATHS = tuple(p for p, spec in PATHS.items() if "phase" not in spec)
GRAPH_BLOCK = 16  # the flagship preset's --steps_per_dispatch
GRAPH_NO_TV_START = 1024  # the last keep-schedule step; on the update grid
GRAPH_TIMED_BLOCKS = {"tv": 3, "no_tv": 4}
OFF_PATH = ("segment_accumulate_k1", "segment_accumulate_k4", "hash_encode_bwd_expand")


# The JAX package's checkpoint fixture (tests/golden/jax_smoke_ckpt, written
# by tests/golden/make_jax_ckpt_fixture.py) and the tolerance its view is
# rendered to. A render moves when the weights move in their last bits: the
# inverse CDF places the fine samples, and weights changed by 3e-7 of
# themselves move single pixels by 2.9e-4 while the mean moves 2.9e-7
# (tests/test_torch_jax_ckpt.py, seeded). So the view is held by its mean
# and its largest absolute difference, each well above that and far below
# what an untrained state gives (a mean of 0.06).
JAX_FIXTURE = os.path.join("tests", "golden", "jax_smoke_ckpt")
JAX_VIEW_MEAN_TOL = 1e-5
JAX_VIEW_MAX_TOL = 2e-3


def jax_view_close(got, want):
    """(within tolerance, {mean_abs_err, max_abs_err}) of a render of the
    JAX fixture's view against the one the JAX package rendered."""
    import numpy as np

    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    stats = {"mean_abs_err": float(err.mean()), "max_abs_err": float(err.max()),
             "mean_tol": JAX_VIEW_MEAN_TOL, "max_tol": JAX_VIEW_MAX_TOL}
    return stats["mean_abs_err"] <= JAX_VIEW_MEAN_TOL and stats["max_abs_err"] <= JAX_VIEW_MAX_TOL, stats


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def kernel_launches():
    """Each kernel wrapper's launches: kernels.launch_counts without the
    program's counters."""
    from hashnerf_torch import kernels

    return {k: n for k, n in kernels.launch_counts().items() if k in kernels.KERNELS}


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


TV_ROUNDS = 3  # K5 and index_add_ timed in turns, for the spread
RECORDED_STEP = 40  # the main-path step whose encode backward K6 and K8 are also held on


def tv_rows(torch, device: str = DEV):
    """The row ids the TV losses hand take_rows (whose backward is K5) at
    the main paths' widths, with the shape of the table each indexes, as
    train/losses.py draws them: {"chair_tv": the 16 levels' cubes on the
    flat (16 x 2^19, 2) table, "packed_tv_dense_<l>": each dense level's
    cube of vertices (F = 8), "packed_tv_slabs": the fine levels' block
    rows (27 x 8 floats)}."""
    from hashnerf_torch.ops.hash_encoding import HashGridConfig
    from hashnerf_torch.ops.packed_grid import init_packed_tables
    from hashnerf_torch.train import losses

    got = []
    take = losses.take_rows

    def recording(table, idx):
        got.append((tuple(table.shape), idx.detach().reshape(-1).clone()))
        return take(table, idx)

    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    hcfg, pcfg = HashGridConfig(log2_hashmap_size=LOG2_T), packed_config()
    try:
        losses.take_rows = recording
        losses.total_variation_loss_all_levels(
            torch.zeros((HASH_L, 1 << LOG2_T, HASH_F), device=device), hcfg.base_resolution,
            hcfg.finest_resolution, LOG2_T, generator=gen)
        losses.total_variation_loss_packed(init_packed_tables(pcfg, gen, device), pcfg,
                                           generator=gen)
    finally:
        losses.take_rows = take
    names = (["chair_tv"] + [f"packed_tv_dense_{l}" for l in range(pcfg.dense_level_count)]
             + ["packed_tv_slabs"])
    require(len(got) == len(names), f"the TV losses made {len(got)} take_rows calls")
    return dict(zip(names, got))


def phase_tv_k5(torch, np):
    """K5 at the TV losses' own shapes (tv_rows): held to its plain version
    by the row gate, then timed with CUDA events (L2 flushed) in turns with
    index_add_ (TV_ROUNDS rounds each, the spread), beside its plain
    version and its bound. k5_slower_beyond_spread is reported, not
    required: a race of speeds does not fail the smoke."""
    from hashnerf_torch.kernels import segment_accum as sa

    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    out = {}
    for name, ((T, F), idx) in tv_rows(torch, DEV).items():
        M = idx.numel()
        vals = torch.randn((M, F), generator=gen, device=DEV)
        got = sa.segment_accumulate_k5(idx, vals, T)
        want = sa.segment_accumulate_k5_plain(idx, vals, T)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(row_abs_ok(got, want, sa.segment_accumulate_k5_plain(idx, vals.abs(), T)),
                f"K5 {name}: max_abs_err {err}")
        del got, want
        k5 = lambda: sa.segment_accumulate_k5(idx, vals, T)
        lib = lambda: torch.zeros((T, F), device=DEV).index_add_(0, idx, vals)
        k5_ms, lib_ms = [], []
        for r in range(TV_ROUNDS):  # K5, lib, lib, K5, ...
            for fn, ts in ((k5, k5_ms), (lib, lib_ms))[:: 1 if r % 2 == 0 else -1]:
                ts.append(cuda_ms(torch, fn))
        b = bound(seg_bytes(M, F, T), M * F)
        out[name] = {"M": M, "F": F, "num_rows": T, "unique_rows": int(torch.unique(idx).numel()),
                     "max_abs_err": err, "k5_ms": k5_ms, "library_ms": lib_ms,
                     "plain_ms": cuda_ms(torch, lambda: sa.segment_accumulate_k5_plain(idx, vals, T)),
                     "bound_ms": b[0], "bound_by": b[1],
                     "k5_slower_beyond_spread": min(k5_ms) > max(lib_ms)}
        emit({"phase": "tv_k5", "shape": name, **out[name]})
    return out


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


@contextlib.contextmanager
def encode_bwd_recorder():
    """Inside the block, each HashEncode and PackedEncode backward (K6, K8)
    appends a copy of what it receives to the list it yields: {"kernel",
    "x", "g" (the features' cotangent), "saved" (the other saved tensors),
    "ctx_attrs" (table_shape or cfg)}. The kernels run as before."""
    from hashnerf_torch.kernels import hash_encode as he
    from hashnerf_torch.kernels import packed_encode as pe

    got = []
    classes = {he.HashEncode: "hash_encode_bwd", pe.PackedEncode: "packed_encode_bwd"}
    saved = {cls: vars(cls)["backward"] for cls in classes}

    def recording(cls, name):
        inner = saved[cls].__func__

        def backward(ctx, g_feats, g_keep):
            x, *rest = ctx.saved_tensors
            got.append({"kernel": name, "x": x.detach().clone(),
                        "g": g_feats.detach().contiguous().clone(),
                        "saved": [t.detach().clone() for t in rest],
                        "ctx_attrs": getattr(ctx, "table_shape", None) or getattr(ctx, "cfg", None)})
            return inner(ctx, g_feats, g_keep)

        return staticmethod(backward)

    try:
        for cls, name in classes.items():
            cls.backward = recording(cls, name)
        yield got
    finally:
        for cls, fn in saved.items():
            cls.backward = fn


def path_trainer(torch, path: str, device: str = DEV):
    """A fresh Trainer of main path `path` (configs/chair.txt plus its flags)
    on the procedural scene of phase_main_path."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    args = parse_args(["--config", os.path.join(ROOT, "configs", "chair.txt"),
                       "--dataset_type", "synthetic", "--no_reload", "--device", device,
                       *PATHS[path]["flags"]])
    return Trainer(args, make_synthetic_scene(H=128, W=128, n_train=8, n_test=2), device=device)


def recorded_encode_inputs(torch, path: str, iters, device: str = DEV):
    """The encode backward's inputs as a main path's steps give them: a fresh
    trainer of `path` (path_trainer) steps on from 0 to max(iters), and the
    backward of each step whose global_step is in iters is recorded
    (encode_bwd_recorder). Returns {step: [record of each pass, coarse
    first]}."""
    trainer = path_trainer(torch, path, device)
    args, sc = trainer.args, trainer.scene

    def one_step():  # timed_steps' batch, without its clock
        img_i = int(sc.i_train[trainer.global_step % len(sc.i_train)])
        trainer.step(trainer.sample_image(img_i, args.N_rand,
                                          precrop=trainer.global_step + 1 < args.precrop_iters))

    out = {}
    while trainer.global_step <= max(iters):
        step = trainer.global_step
        if step in iters:
            with encode_bwd_recorder() as got:
                one_step()
            out[step] = sorted(got, key=lambda r: r["x"].shape[0])
        else:
            one_step()
    return out


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

    # K6 on the (x, g) the chair path's backward hands it at step
    # RECORDED_STEP (its zero rows and its bbox), each pass
    rec = recorded_encode_inputs(torch, "chair", (RECORDED_STEP,))[RECORDED_STEP]
    for pname, r in zip(("coarse", "fine"), rec):
        xs, gs, (rmin, rmax, rres) = r["x"], r["g"], r["saved"]
        require(r["kernel"] == "hash_encode_bwd" and r["ctx_attrs"] == (L, T, F),
                f"recorded {r['kernel']} at {r['ctx_attrs']}, not the chair path's K6")
        n = xs.shape[0]
        want = hash_encode_bwd_plain(xs, rmin, rmax, rres, gs, T)
        got = hash_encode_bwd(xs, rmin, rmax, rres, gs, T)
        torch.cuda.synchronize()
        k6_err = float((got - want).abs().max())
        require(row_abs_ok(got, want, hash_encode_bwd_plain(xs, rmin, rmax, rres, gs.abs(), T)),
                f"K6 vs its plain version ({pname}_recorded): max_abs_err {k6_err}")
        b6 = bound(n * 12 + n * L * F * 4 + L * T * F * 4 + 24 + L * 4, n * L * K6_OPS)
        shapes[f"{pname}_recorded"] = {
            "N": n, "step": RECORDED_STEP, "k6_max_abs_err": k6_err,
            "zero_row_share": float((gs.reshape(n, L, F) == 0).all(dim=-1).float().mean()),
            "clipped_share": float(1 - ((xs >= rmin) & (xs <= rmax)).all(dim=-1).float().mean()),
            "k6_ms": cuda_ms(torch, lambda: hash_encode_bwd(xs, rmin, rmax, rres, gs, T)),
            "k6_plain_ms": cuda_ms(torch, lambda: hash_encode_bwd_plain(xs, rmin, rmax, rres, gs, T),
                                   reps=3),
            "k6_bound_ms": b6[0], "k6_bound_by": b6[1],
        }
        emit({"phase": "encode_shape", "points": f"{pname}_recorded", **shapes[f"{pname}_recorded"]})
    del rec, got, want

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


def k5_at_kept_points(torch, kept, pcfg, bmin, bmax, phase: str):
    """K5 on the packed rows of kept points, {(slab shape name, voxel shape
    name): points (N, 3)}: the fine slabs (27F floats) and the dense voxel
    rows (8F) those points touch, with seeded values; each held against
    its plain version by the row gate and timed (CUDA events, L2 flushed)
    beside it, index_add_ and its bound."""
    from hashnerf_torch.kernels import segment_accum as sa
    from hashnerf_torch.ops.packed_grid import packed_geometry

    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    F = pcfg.n_features_per_level
    shapes = {}
    for (slab_name, voxel_name), pts in kept.items():
        geo = packed_geometry(pts.contiguous(), bmin, bmax, pcfg)
        shapes[slab_name] = (geo.fine_rows.reshape(-1), 27 * F,
                             len(pcfg.fine_resolutions) * pcfg.n_block_rows)
        shapes[voxel_name] = (geo.dense_rows.reshape(-1), 8 * F, pcfg.packed_offsets[-1])
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
        emit({"phase": phase, "shape": name, **out[name]})
    return out


def phase_culled_k5(torch, np, kept_pts):
    """K5 at the flagship's culled shapes: the packed rows of the points the
    fine cull kept, {keep fraction: points}: 24,576 at 0.125 (the coarse
    pass keeps as many at 0.375), 98,304 at 0.5; beside its plain version
    and index_add_."""
    kept = {}
    for keep, pts in kept_pts.items():
        tag = "" if keep == FLAGSHIP_KEEP[0] else f"_keep_{keep}"
        kept[("culled_slabs" + tag, "culled_dense_voxels" + tag)] = pts
    return k5_at_kept_points(torch, kept, packed_config(), torch.full((3,), -1.6, device=DEV),
                             torch.full((3,), 1.6, device=DEV), "culled_k5")


# Arithmetic of one (point, level) of K7 / K8, counted from
# csrc/packed_encode.cu: clip and geometry 10 ops x 3 axes, 8 corner weights
# (3 subtractions + 16 products), 8 row ids (about 4 ops each, the hash 8
# once), then the blend (K7: 8 x F multiply-adds) or the products and the
# reductions (K8: 8 x F each).
PACKED_GEOM_OPS = 30 + 19 + 40
# The flagship's widths, and tpu-quality's (L8 / F4: dense levels 16-70,
# fine levels 115-511), each at log2 T 19 with 2^16 block rows.
PACKED_WIDTHS = {"flagship": (PACKED_L, PACKED_F), "quality": (8, 4)}


def packed_case(torch, name: str, pcfg, x, gen, reps: int = 10, g=None, bbox=None):
    """K7 and K8 at one shape (points x on the card, the cotangent g
    (default normal) in the bbox (default [-1.6, 1.6]^3), pcfg's widths,
    tables from U(-1e-4, 1e-4) x 1e4 so that a wrong row cannot hide under the
    gates' absolute terms), each held to its plain version and to the
    torch-ops route it replaced (packed_encode_ops: rebuilt table,
    take_rows, einsums; its backward through autograd and K5): K7's keep
    mask bit-equal, its features within BLEND_ORDER_RTOL of each blend's
    absolute sum; K8's gradients within the row gate (row_abs_ok against
    the terms' absolute sums). Then timed with CUDA events (L2 flushed;
    K8's wrapper zeroes both gradient tables, which its time includes) and
    as device time from a profiler trace, beside the byte bound of each
    direction: K7 reads x and each corner row the points touch once and
    writes the features and the mask; K8 reads x and g and writes both
    gradient tables whole."""
    from hashnerf_torch.kernels import packed_encode as pe
    from hashnerf_torch.ops.packed_grid import init_packed_tables, packed_encode_ops

    tables = {k: v * 1e4 for k, v in init_packed_tables(pcfg, gen, DEV).items()}
    dense, fine = tables.get("dense"), tables.get("fine")
    bmin, bmax = bbox or (torch.full((3,), -1.6, device=DEV), torch.full((3,), 1.6, device=DEV))
    N, F, L = x.shape[0], pcfg.n_features_per_level, pcfg.n_levels
    if g is None:
        g = torch.randn((N, pcfg.out_dim), generator=gen, device=DEV)
    args = (x, bmin, bmax)

    feats, keep = pe.packed_encode_fwd(dense, fine, *args, pcfg)
    d_k8 = pe.packed_encode_bwd(*args, g, pcfg)
    torch.cuda.synchronize()
    plain_f, plain_keep = pe.packed_encode_fwd_plain(dense, fine, *args, pcfg)
    abs_f, _ = pe.packed_encode_fwd_plain(dense.abs() if dense is not None else None,
                                          fine.abs() if fine is not None else None, *args, pcfg)
    ops_tables = {k: v.clone().requires_grad_(True) for k, v in tables.items()}
    route_f, route_keep = packed_encode_ops(ops_tables, *args, pcfg)
    route_d = dict(zip(ops_tables, torch.autograd.grad(route_f, list(ops_tables.values()), g)))
    route_f = route_f.detach()
    plain_d = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(*args, g, pcfg)))
    abs_d = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(*args, g.abs(), pcfg)))
    got_d = dict(zip(("dense", "fine"), d_k8))
    rec = {"N": N, "levels": [pcfg.dense_level_count, len(pcfg.fine_resolutions)], "F": F,
           "resolutions": list(pcfg.resolutions), "inside": int(keep.sum()),
           "zero_row_share": float((g.reshape(N, L, F) == 0).all(dim=-1).float().mean())}
    for route, (want_f, want_keep) in (("plain", (plain_f, plain_keep)),
                                      ("ops", (route_f, route_keep))):
        require(bool(torch.equal(keep, want_keep)), f"K7 keep mask vs {route} ({name})")
        err = (feats - want_f).abs()
        ratio = float((err / abs_f.clamp_min(1e-30)).max())
        require(ratio <= BLEND_ORDER_RTOL,
                f"K7 vs {route} ({name}): a feature differs by {ratio} of its blend's absolute sum")
        rec[f"k7_vs_{route}_max_abs_err"] = float(err.max())
        rec[f"k7_vs_{route}_max_err_over_abs_sum"] = ratio
        want_d = plain_d if route == "plain" else route_d
        for kind in ("dense", "fine"):
            if kind not in tables:
                require(got_d[kind] is None, f"K8 ({name}): a {kind} gradient without {kind} levels")
                continue
            k8_err = float((got_d[kind] - want_d[kind]).abs().max())
            require(row_abs_ok(got_d[kind], want_d[kind], abs_d[kind]),
                    f"K8 {kind} vs {route} ({name}): max_abs_err {k8_err}")
            rec[f"k8_{kind}_vs_{route}_max_abs_err"] = k8_err
    del route_d, plain_d, abs_d, route_f, plain_f, abs_f, ops_tables

    # bounds: the rows this run's points touch, each read once
    _, levels = pe.corner_rows(*args, pcfg)
    touched = {kind: torch.unique(torch.cat([r.reshape(-1) for k, r, _ in levels if k == kind]))
               .numel() if kind in tables else 0 for kind in ("dense", "fine")}
    del levels
    table_b = sum(t.numel() * 4 for t in tables.values())
    fwd_bytes = N * 12 + 24 + (touched["dense"] + touched["fine"]) * F * 4 + N * L * F * 4 + N
    bwd_bytes = N * 12 + 24 + N * L * F * 4 + table_b
    fwd_bound = bound(fwd_bytes, N * L * (PACKED_GEOM_OPS + 16 * F))
    bwd_bound = bound(bwd_bytes, N * L * (PACKED_GEOM_OPS + 16 * F))
    rec.update({"touched_rows": touched, "k7_bound_ms": fwd_bound[0], "k7_bound_by": fwd_bound[1],
                "k8_bound_ms": bwd_bound[0], "k8_bound_by": bwd_bound[1]})

    ops_tables = {k: v.clone().requires_grad_(True) for k, v in tables.items()}
    k7 = lambda: pe.packed_encode_fwd(dense, fine, *args, pcfg)
    k8 = lambda: pe.packed_encode_bwd(*args, g, pcfg)
    both = lambda: (k7(), k8())
    route_fwd = lambda: packed_encode_ops(ops_tables, *args, pcfg)
    route_both = lambda: torch.autograd.grad(route_fwd()[0], list(ops_tables.values()), g)
    timed = {"k7": k7, "k8": k8, "k7_k8": both,
             "k7_plain": lambda: pe.packed_encode_fwd_plain(dense, fine, *args, pcfg),
             "k8_plain": lambda: pe.packed_encode_bwd_plain(*args, g, pcfg),
             "route_fwd": route_fwd, "route_fwd_bwd": route_both}
    for what, fn in timed.items():
        rec[f"{what}_ms"] = cuda_ms(torch, fn, reps=reps)
    for what in ("k7", "k8", "route_fwd", "route_fwd_bwd"):
        rec[f"{what}_device_ms"] = device_ms(torch, timed[what], reps=5)
    # K8's kernel alone, without the zero fills of its wrapper
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(5):
            _L2_FLUSH[0].zero_()
            k8()
        torch.cuda.synchronize()
    rec["k8_kernel_device_ms"] = sum(r[0] for r in kernel_times(p)
                                     if "packed_encode_bwd_kernel" in r[1]) / 1e3 / 5
    del tables, ops_tables, g, feats, keep, d_k8
    torch.cuda.empty_cache()
    emit({"phase": "packed_encode", "shape": name, **rec})
    return rec


def phase_packed_encode(torch, np, kept_pts):
    """K7 and K8 (packed_case) at the packed path's pass shapes (196,608
    uniform points as the row-id gate's and along 1024 rays of 192 samples,
    and the coarse pass's 65,536), the flagship's culled pass (the 24,576
    points its fine cull keeps at 0.125) and its keep-0.5 pass (98,304), and
    tpu-quality's widths at the same full and keep-0.5 passes."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    out = {}
    for widths, (L, F) in PACKED_WIDTHS.items():
        from hashnerf_torch.ops.packed_grid import PackedGridConfig

        pcfg = PackedGridConfig(n_levels=L, n_features_per_level=F, log2_hashmap_size=LOG2_T,
                                log2_blocks=PACKED_LOG2_BLOCKS)
        x_all = torch.as_tensor(chair_points(np, N_POINTS, -1.6, 1.6, pcfg.resolutions, seed=1),
                                device=DEV)
        sets = {"fine": x_all, "keep_0.5": kept_pts[0.5].contiguous()}
        if widths == "flagship":
            sets.update({"fine_rays": torch.as_tensor(ray_points(np, 1024, 192, seed=3), device=DEV),
                         "coarse": x_all[:N_COARSE].contiguous(),
                         "culled": kept_pts[FLAGSHIP_KEEP[0]].contiguous()})
        for name, x in sets.items():
            key = name if widths == "flagship" else f"quality_{name}"
            out[key] = packed_case(torch, key, pcfg, x, gen)
    # the (x, g) the packed path's fine pass hands K8 at step RECORDED_STEP
    r = recorded_encode_inputs(torch, "packed", (RECORDED_STEP,))[RECORDED_STEP][-1]
    require(r["kernel"] == "packed_encode_bwd" and r["ctx_attrs"] == packed_config()
            and r["x"].shape[0] == N_POINTS,
            f"recorded {r['kernel']} at {r['ctx_attrs']}, not the packed path's fine K8")
    out["fine_recorded"] = packed_case(torch, "fine_recorded", r["ctx_attrs"], r["x"], gen,
                                       g=r["g"], bbox=tuple(r["saved"]))
    return out


# The field query's (rays, samples a ray) at NeRFSmall's widths (Cv 16 view
# columns, h = [sigma, 15 geo features]): the render chunk's coarse and fine
# passes, the chair's training passes, the flagship's culled blocks of 8 and
# a grid update's points.
FIELD_SHAPES = {"render_coarse": (32768, 64), "render_fine": (32768, 192),
                "train_coarse": (1024, 64), "train_fine": (1024, 192),
                "culled_blocks": (3072, 8), "grid_update": (65536, 1)}
FIELD_CV, FIELD_H = 16, 16
FIELD_LINE_SHAPE = "render_fine"  # the kernels line's shape: the most bytes
# NeRFSmall's multiply-adds a point: 32 x 64 + 64 x 16 + 31 x 64 + 64 x 64 + 64 x 3
MLP_MACS = 32 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3


def field_inputs(torch, R: int, S: int, gen):
    """Card tensors of one field query at (R, S): unit directions d (R, 3),
    their SH encoding, the encoded points, the sigma net's output h, rgb,
    the keep mask and the colour input's and raw's cotangents."""
    from hashnerf_torch.ops.sh_encoding import sh_encode

    N = R * S
    normal = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    d = normal(R, 3)
    d = d / d.norm(dim=-1, keepdim=True)
    G = FIELD_H - 1
    return {"d": d, "views": sh_encode(d), "feats": normal(N, 32), "h": normal(N, FIELD_H),
            "rgb": normal(N, 3), "keep": torch.rand((N,), generator=gen, device=DEV) < 0.8,
            "g_c": normal(N, FIELD_CV + G), "g_raw": normal(N, 4)}


def mlp_close(torch, got, want) -> bool:
    """field_mlp_fwd against its plain version (cuBLAS float32 GEMMs of the
    same bf16 operands, which sum in the kernel's k order but for rare last
    bits, and in other orders at a few thousand rows): ~1e-7 of a column's
    scale, and up to a few bf16 ulps of a hidden value where a last bit
    flips its rounding: at most 0.2% of the entries beyond 1e-5 of their
    column's scale, every entry within 2^-6 of it
    (tests/test_torch_cuda.py's rule)."""
    scale = want.abs().amax(0)
    err = (got - want).abs()
    return (float((err > 1e-5 * scale).float().mean()) <= 2e-3
            and bool((err <= 2.0 ** -6 * scale).all()))


# field_mlp_fwd_f32 against its plain version (cuBLAS float32 GEMMs of the
# same operands, in the kernel's k order but for rare last bits): the
# largest gap over its column's largest magnitude
MLP_F32_GAP = 1e-6


def mlp_rel_gap(got, want) -> float:
    """The largest |got - want| over the largest |want| of its column."""
    return float(((got - want).abs() / want.abs().amax(0)).max())


def phase_field_kernels(torch):
    """K9 (field_colour_input) and field_raw, forward and backward, at the
    field query's shapes (FIELD_SHAPES): each launch on card tensors must
    equal its plain version on the same tensors (torch.equal: every value
    is a copy or +0), with and without the view encoding and the keep mask;
    then each is timed with CUDA events (L2 flushed) and from a profiler
    trace beside its plain version and its byte bound. The bounds count
    what the function needs: each input read once and each output column
    written once; K9's pad column (its rows are padded to 32 floats for
    16-byte stores) is given apart as k9_pad_ms. field_mlp_fwd (NeRFSmall's
    bf16 forward in one kernel) on the encoded points, a bf16 net's
    weights, the views and the keep mask: equal bit for bit to its
    arithmetic in PyTorch ops with every sum in k order
    (field_mlp_fwd_ordered), within mlp_close of its plain version, sigma
    exactly 0 outside the keep mask, two launches equal bit for bit; timed
    the same way, against its bound: the float32 multiply-adds at the
    CUDA cores' peak (its byte bound beside it, as mlp_byte_bound_ms).
    field_mlp_fwd_f32 (the float32 forward, `mlp_f32`) on the same weights
    unrounded: the same checks, within MLP_F32_GAP of its plain version,
    the share of its entries equal to it, timed the same way."""
    from hashnerf_torch.kernels import field_mlp as fm
    from hashnerf_torch.kernels import field_query as fq
    from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig

    gen = torch.Generator(device=DEV)
    gen.manual_seed(20)
    Cv, H = FIELD_CV, FIELD_H
    G = H - 1
    net = NeRFSmall(NeRFSmallConfig(compute_dtype="bfloat16"),
                    torch.Generator().manual_seed(20)).to(DEV)
    ws = [l.weight.detach() for l in [*net.sigma_net, *net.color_net]]
    out = {}
    for shape, (R, S) in FIELD_SHAPES.items():
        N = R * S
        t = field_inputs(torch, R, S, gen)
        views, h, rgb, keep, g_c, g_raw = (t[k] for k in ("views", "h", "rgb", "keep", "g_c",
                                                         "g_raw"))
        feats = t["feats"]
        pairs = {
            "k9": (lambda: fq.field_colour_input_fwd(views, h, S),
                   lambda: fq.field_colour_input_fwd_plain(views, h, S)),
            "k9_no_views": (lambda: fq.field_colour_input_fwd(None, h, S),
                            lambda: fq.field_colour_input_fwd_plain(None, h, S)),
            "k9_bwd": (lambda: fq.field_colour_input_bwd(g_c, Cv, H),
                       lambda: fq.field_colour_input_bwd_plain(g_c, Cv, H)),
            "field_raw": (lambda: fq.field_raw_fwd(rgb, h, keep),
                          lambda: fq.field_raw_fwd_plain(rgb, h, keep)),
            "field_raw_no_keep": (lambda: fq.field_raw_fwd(rgb, h, None),
                                  lambda: fq.field_raw_fwd_plain(rgb, h, None)),
            "field_raw_bwd": (lambda: fq.field_raw_bwd(g_raw, keep, H),
                              lambda: fq.field_raw_bwd_plain(g_raw, keep, H)),
        }
        rec = {"R": R, "S": S, "N": N}
        for what, (kern, plain) in pairs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            require(got.is_cuda and got.shape == want.shape and bool(torch.equal(got, want)),
                    f"field {what} at {shape}: differs from its plain version")
            if what.startswith("k9") and what != "k9_bwd":
                # the padded rows: stride P, the pad column +0
                P = fq.padded_width(got.shape[1])
                require(got.stride() == (P, 1) and not bool(
                    got.as_strided((N, P), (P, 1))[:, got.shape[1]:].any()),
                        f"field {what} at {shape}: rows not padded with +0 to {P}")
            rec[f"{what}_max_abs_err"] = float((got - want).abs().max())
            del got, want
        bf = torch.bfloat16
        mlp = (lambda: fm.field_mlp_fwd(feats, views, S, keep, ws, bf),
               lambda: fm.field_mlp_fwd_plain(feats, views, S, keep, ws, bf))
        with torch.no_grad():
            got, again, want = mlp[0](), mlp[0](), mlp[1]()
            ordered = fm.field_mlp_fwd_ordered(feats, views, S, keep, ws, bf)
        torch.cuda.synchronize()
        require(bool(torch.equal(got, ordered)) and mlp_close(torch, got, want)
                and bool(torch.equal(got, again)) and not bool(got[~keep, 3].any()),
                f"field mlp at {shape}: not its in-order arithmetic bit for bit, not within "
                "mlp_close of its plain version, not deterministic, or sigma outside the "
                "keep mask")
        scale = want.abs().amax(0)
        rec["mlp_max_abs_err"] = float((got - want).abs().max())
        rec["mlp_entries_unequal_to_plain"] = int((got != want).sum())
        rec["mlp_share_beyond_1e-5_scale"] = float(
            ((got - want).abs() > 1e-5 * scale).float().mean())
        del got, again, want, ordered
        mlp_f32 = (lambda: fm.field_mlp_fwd(feats, views, S, keep, ws, None),
                   lambda: fm.field_mlp_fwd_plain(feats, views, S, keep, ws, None))
        with torch.no_grad():
            got, again, want = mlp_f32[0](), mlp_f32[0](), mlp_f32[1]()
            ordered = fm.field_mlp_fwd_ordered(feats, views, S, keep, ws, None)
        torch.cuda.synchronize()
        gap = mlp_rel_gap(got, want)
        require(bool(torch.equal(got, ordered)) and gap <= MLP_F32_GAP
                and bool(torch.equal(got, again)) and not bool(got[~keep, 3].any()),
                f"field mlp_f32 at {shape}: not its in-order arithmetic bit for bit, "
                f"{gap:.3g} of a column's scale from its plain version, not deterministic, or "
                "sigma outside the keep mask")
        rec["mlp_f32_max_abs_err"] = float((got - want).abs().max())
        rec["mlp_f32_max_rel_gap"] = gap
        rec["mlp_f32_share_equal_to_plain"] = float((got == want).float().mean())
        del got, again, want, ordered
        pairs["mlp"], pairs["mlp_f32"] = mlp, mlp_f32
        for what in ("k9", "k9_bwd", "field_raw", "field_raw_bwd", "mlp", "mlp_f32"):
            kern, plain = pairs[what]
            rec[f"{what}_ms"] = cuda_ms(torch, kern)
            rec[f"{what}_device_ms"] = device_ms(torch, kern, reps=5)
            rec[f"{what}_plain_ms"] = cuda_ms(torch, plain)
            rec[f"{what}_plain_device_ms"] = device_ms(torch, plain, reps=5)
        nbytes = {"k9": N * (G + Cv + G) * 4 + R * Cv * 4,  # geo read, row written; views once
                  "k9_bwd": N * (G + H) * 4,  # the geo cotangent read, d_h written
                  "field_raw": N * (3 * 4 + 4 + 1 + 4 * 4),  # rgb, sigma, keep; raw written
                  "field_raw_bwd": N * (4 + 1 + H * 4)}  # sigma's cotangent, keep; d_h written
        for what, nb in nbytes.items():
            rec[f"{what}_bound_ms"], rec[f"{what}_bound_by"] = bound(nb, 0)
        # the encoded points and keep read, raw written, views once a ray; the
        # multiply-adds, 2 operations each, on the CUDA cores
        mlp_bytes = N * (32 * 4 + 1 + 4 * 4) + R * Cv * 4
        rec["mlp_bound_ms"], rec["mlp_bound_by"] = bound(mlp_bytes, N * 2 * MLP_MACS)
        rec["mlp_f32_bound_ms"], rec["mlp_f32_bound_by"] = rec["mlp_bound_ms"], rec["mlp_bound_by"]
        rec["mlp_byte_bound_ms"] = mlp_bytes / PEAK_BYTES_PER_S * 1e3
        rec["k9_pad_ms"] = N * (fq.padded_width(Cv + G) - Cv - G) * 4 / PEAK_BYTES_PER_S * 1e3
        out[shape] = rec
        emit({"phase": "field_kernels", "shape": shape, **rec})
        del t, views, h, rgb, keep, g_c, g_raw, pairs
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# Phase 3
# --------------------------------------------------------------------------- #

def timed_steps(torch, trainer, n: int, keeps=None, batches=None):
    """Host-clock seconds of n train steps (ray sampling included), each
    closed by a synchronize; returns (seconds, losses). Appends each step's
    culling keep fractions (or None) to `keeps` when given. `batches()`
    gives each step's batch (default: one training image's pixels, the
    images in turn)."""
    args, sc = trainer.args, trainer.scene
    ts, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if batches is None:
            img_i = int(sc.i_train[trainer.global_step % len(sc.i_train)])
            batch = trainer.sample_image(
                img_i, args.N_rand, precrop=trainer.global_step + 1 < args.precrop_iters
            )
        else:
            batch = batches()
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

        c0 = kernel_launches()
        loop_peak = torch.cuda.max_memory_allocated() / 2**30  # its test-set render included
        torch.cuda.reset_peak_memory_stats()
        if spec["tv_start"] is not None:
            trainer.global_step = spec["tv_start"]
        keeps_tv = []
        tv_s, tv_losses = timed_steps(torch, trainer, 10, keeps_tv)  # TV on
        c1 = kernel_launches()
        tv_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        trainer.global_step = spec["no_tv_start"]  # past the TV steps, as bench.py does
        keeps = []
        notv_s, notv_losses = timed_steps(torch, trainer, 20, keeps)
        c2 = kernel_launches()
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
        c_g0 = kernel_launches()
        graphed = {"tv": graphed_window(torch, trainer, path, spec["graph_tv_start"], "tv", profile),
                   "no_tv": graphed_window(torch, trainer, path, GRAPH_NO_TV_START, "no_tv", profile)}
        c_g1 = kernel_launches()
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
        counts = kernel_launches()

        losses = [h[1] for h in trainer.history] + tv_losses + notv_losses
        require(rgb.shape == (scene.H, scene.W, 3), f"render shape {tuple(rgb.shape)}")
        require(bool(torch.isfinite(rgb).all()), "non-finite render")
        require(all(np.isfinite(losses)), "non-finite loss")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]), "loss did not fall")
        for name in spec["kernels"]:
            require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
        for name in OFF_PATH:
            require(counts[name] == 0, f"kernel {name} was launched on the {path} path")
        for name in MLP_FUSED + MLP_FUSED_F32:
            require((counts[name] > 0) == (name == spec["mlp_fused"]),
                    f"{name} launched {counts[name]} times on the {path} path")

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


# The graph-against-eager gate, in two parts.
# 1. One step from one state and generator state, eagerly and as a 1-step
#    block of a fresh capture: the loss within GATE_LOSS_RTOL, every MLP
#    gradient bit-equal (their GEMMs and the encode's forward are
#    deterministic), every table gradient inside the atomics' row gate
#    (row_gate: K5 and K6 add in no fixed order). This holds the captured
#    step to the eager step at its capture.
# 2. GRAPH_BLOCK steps twice eagerly and twice as one run_steps block (the
#    step graph replayed, and the grid-update graph under occupancy), each
#    from that state: in each group of state (GATE_GROUPS), the fewer
#    entries outside the row gate of the two graph-vs-eager pairs at most
#    the group's allowance, the larger of GATE_SPREAD_FACTOR x the more of
#    an eager pair and a graphed pair (at least 1) and the floor,
#    GATE_FLOOR_MARGIN x GATE_CROSS_MODE's share of the group's entries
#    (the path's own for the tables); the last loss within
#    GATE_LOSS_FLOOR of itself or 10x the pairs' loss differences. This
#    holds what one step cannot show: the learning rate, draws, keep
#    budgets and grid updates of the later replays.
# The floors: each mode repeats its own order of atomics, so two runs of
# one mode agree better than the two modes do, and the within-mode spread
# alone stopped correct blocks (4 entries outside against 0 and 0; 149
# against 18). On the flagship a last-bit difference can also move a fine
# sample into another grid cell and change a culled kept set: 2 of its 30
# windows measured left up to 34,221 table entries, 4,085 grid entries and
# a last loss 3.3e-4 of itself apart, the same in both pairs, with the runs
# of each mode 0-5 entries apart. GATE_CROSS_MODE holds the largest share
# of a group's entries that the two modes left outside (the smaller pair)
# in 30 windows of each path (llff: 50, at the llff phase's own state;
# st3d: its hash run's two windows at the st3d phase's own state),
# measured by chip_diag.py gate-spread on an H100 80GB HBM3 at 700 W
# (PERF.md §6): per path for the tables, whose spread differs 300-fold
# between paths, the largest of any path for the MLPs, the grid and the
# last loss. Each floor is GATE_FLOOR_MARGIN x that; the planted faults move
# far more (chip_smoke_faults.py: an lr frozen at capture, 54% of the
# chair's table entries; a skipped grid-update replay, 10% of the grid;
# chip_diag.py pool-faults: a pool row offset that never advances, or a
# pool rebound after the capture, 40% of llff's table entries; on st3d's
# column pool, the rgb target read one float off, 600,325 table gradient
# entries in one step, and the depth and gradient targets read one off,
# 824,942 of OmniNeRF's MLP gradient entries in one step).
GATE_GROUPS = {
    "tables": lambda tr: tr.state.table_parameters(),
    "mlp": lambda tr: tr.state.net_parameters(),
    "grid": lambda tr: [tr.occ_grid] if tr.occ_grid is not None else [],
}
GATE_SPREAD_FACTOR = 3
GATE_CROSS_MODE = {
    "tables": {"chair": 2114 / 16777216, "packed": 1076573 / 29412064,
               "flagship": 34221 / 29412064, "llff": 44487 / 16777216,
               "st3d": 650 / 16777216},
    "mlp": 7 / 9344, "grid": 4085 / 2097152, "loss": 3.31e-4,
}
GATE_FLOOR_MARGIN = 4
GATE_LOSS_FLOOR = GATE_FLOOR_MARGIN * GATE_CROSS_MODE["loss"]  # of the last loss
GATE_LOSS_RTOL = 1e-4  # the one step's loss


def graphed_window(torch, trainer, path: str, start: int, window: str, profile: bool,
                   pool=None, offset: int = 0):
    """From global_step `start` on path `path` (of PATHS, or llff): the
    two-part gate above, then GRAPH_TIMED_BLOCKS[window] timed blocks, each
    closed by a host read. Steps take their rays from the images
    (sample_batch) or, given the ray pool, from its rows at `offset` on
    (sample_pool, and run_steps' pool blocks). Every graphed step must cull
    at the window's keeps."""
    from hashnerf_torch import kernels

    args, n = trainer.args, GRAPH_BLOCK
    want_keep = PATHS.get(path, LLFF_SPEC)["keeps_tv" if window == "tv" else "keeps_no_tv"]
    precrop = pool is None and start + 1 < args.precrop_iters
    snap = [t.detach().clone() for t in trainer.training_state()]
    rng, ready = trainer.generator.get_state(), trainer._occ_ready

    def from_snapshot():
        with torch.no_grad():
            for t, s in zip(trainer.training_state(), snap):
                t.copy_(s)
        trainer.generator.set_state(rng)
        trainer.global_step, trainer._occ_ready = start, ready

    def eager(k: int):
        for j in range(k):
            m = trainer.step(trainer.sample_batch(precrop) if pool is None
                             else trainer.sample_pool(pool, offset + j * args.N_rand, args.N_rand))
        return m

    def graphed(k: int, at: int = offset):
        return trainer.run_steps(k, block_size=k, precrop=precrop, pool=pool, offset=at)

    # part 1: one step; the fresh capture's gradients are the tensors its
    # replays write (a cached graph's may not be the ones p.grad holds)
    def one_step(graph: bool):
        from_snapshot()
        if graph:
            t0 = time.perf_counter()
            m = trainer.capture_first_step(n, precrop, pool, offset)
            torch.cuda.synchronize()
            capture_s[0] = time.perf_counter() - t0
        else:
            m = eager(1)
        return float(m["loss"]), {g: [p.grad.detach().clone() for p in GATE_GROUPS[g](trainer)]
                                  for g in ("tables", "mlp")}

    capture_s = [0.0]
    e_loss, e_grads = one_step(False)
    g_loss, g_grads = one_step(True)
    mlp_diff = sum(int((a != b).sum()) for a, b in zip(g_grads["mlp"], e_grads["mlp"]))
    table_out, table_worst = row_gate(g_grads["tables"], e_grads["tables"])
    step1 = {"loss": [e_loss, g_loss], "mlp_grad_entries_differing": mlp_diff,
             "table_grad_outside_row_gate": table_out, "table_grad_max_abs_diff": table_worst}
    require(abs(g_loss - e_loss) <= GATE_LOSS_RTOL * abs(e_loss) and mlp_diff == 0 and table_out == 0,
            f"graphed block from step {start} is not the eager step at its capture (one step): {step1}")
    del e_grads, g_grads

    # part 2: GRAPH_BLOCK steps
    def run(graph: bool):
        from_snapshot()
        m = graphed(n) if graph else eager(n)
        state = {g: [t.detach().clone() for t in of(trainer)] for g, of in GATE_GROUPS.items()}
        return state, float(m["loss"])

    eager1, eager_loss = run(False)
    eager2, eager2_loss = run(False)
    graph1, graph_loss = run(True)
    graph2, graph2_loss = run(True)
    del snap
    pairs = {"graph_vs_eager": (graph1, eager1), "graph2_vs_eager2": (graph2, eager2),
             "eager_vs_eager": (eager2, eager1), "graph_vs_graph": (graph2, graph1)}
    gate = {"one_step": step1,
            "last_loss": {"graph": graph_loss, "eager": eager_loss, "eager_again": eager2_loss,
                          "graph_again": graph2_loss}}
    for group in GATE_GROUPS:
        if not eager1[group]:
            continue
        g = gate[group] = {"entries": sum(t.numel() for t in eager1[group])}
        for name, (a, b) in pairs.items():
            bad, worst = row_gate(a[group], b[group])
            g[name] = {"outside_row_gate": bad, "max_abs_diff": worst}
        out = lambda name: g[name]["outside_row_gate"]
        share = GATE_CROSS_MODE[group]
        share = share[path] if isinstance(share, dict) else share
        g["floor"] = math.ceil(GATE_FLOOR_MARGIN * share * g["entries"])
        g["allowed"] = max(GATE_SPREAD_FACTOR * max(out("eager_vs_eager"), out("graph_vs_graph"), 1),
                           g["floor"])
        require(min(out("graph_vs_eager"), out("graph2_vs_eager2")) <= g["allowed"],
                f"graphed block from step {start} is not the {n} eager steps ({group}): {gate}")
    del pairs, eager1, eager2, graph1, graph2
    loss_tol = max(GATE_LOSS_FLOOR * abs(eager_loss),
                   10 * max(abs(eager2_loss - eager_loss), abs(graph2_loss - graph_loss)))
    require(min(abs(graph_loss - eager_loss), abs(graph2_loss - eager2_loss)) <= loss_tol,
            f"graphed block from step {start}: last loss off the eager steps': {gate}")
    keeps = [trainer.last_occ_keep]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c0 = kernel_launches()
    ts, losses = [], [graph2_loss]
    for i in range(GRAPH_TIMED_BLOCKS[window]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = graphed(n, offset + (i + 1) * n * args.N_rand)
        losses.append(float(m["loss"]))
        ts.append(time.perf_counter() - t0)
        keeps.append(trainer.last_occ_keep)
    c1 = kernel_launches()
    require(all(k == want_keep for k in keeps),
            f"graphed blocks from step {start}: not all at keeps {want_keep}: {keeps}")
    require(all(math.isfinite(x) for x in losses), f"graphed blocks from step {start}: non-finite loss")
    step_s = statistics.median(ts) / n
    rec = {
        "start": start, "block": n, "precrop": precrop, "pool_offset": None if pool is None else offset,
        "gate": gate, "one_step_s_with_capture": capture_s[0],
        "block_ms": [t * 1e3 for t in ts], "step_ms_graphed": step_s * 1e3,
        "train_rays_per_s_graphed": args.N_rand / step_s, "keeps": keeps, "losses": losses,
        "launches_per_step": {k: (c1[k] - c0[k]) / (n * len(ts)) for k in c0},
        "peak_mem_gib_graphed": torch.cuda.max_memory_allocated() / 2**30,
        "reserved_gib_graphed": torch.cuda.memory_reserved() / 2**30,
    }
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        at = offset + (GRAPH_TIMED_BLOCKS[window] + 1) * n * args.N_rand
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            float(graphed(n, at)["loss"])
        rows = kernel_times(p)
        busy_s = sum(r[0] for r in rows) / 1e6 / n
        rec.update({
            "device_busy_ms_per_step": busy_s * 1e3, "device_busy_share": busy_s / step_s,
            "device_ops_per_step": sum(r[2] for r in rows) / n,
            "top": [{"name": k[:90], "ms_per_step": dt / 1e3 / n, "calls_per_step": c / n}
                    for dt, k, c in rows[:12]],
        })
    return rec


def profile_steps(torch, trainer, n: int, step_s: float, batches=None):
    """torch.profiler over n steps: device time by kernel (device-side
    events only, so operator ranges are not counted twice), and busy share.

    The profiler slows the host about twofold, so the busy share of a real
    step divides the device time per step by `step_s`, the median
    unprofiled step of the same run; the share of the profiled wall is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    timed_steps(torch, trainer, 1, batches=batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        timed_steps(torch, trainer, n, batches=batches)
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


# The blender phase: a blender-format set written by the port's tool at the
# nerf-synthetic resolution (800 x 800 RGBA), cut to 16 / 2 / 4 frames and
# traced without supersampling; the chair trained on it for BLENDER_ITERS
# steps (precrop_iters 500 ends), render-only after it, then the flagship
# preset for BLENDER_FLAGSHIP_ITERS steps (past its warmup of 256).
BLENDER_SET = ["--hw", "800", "--n_train", "16", "--n_val", "2", "--n_test", "4", "--ss", "1"]
BLENDER_ITERS = 600
BLENDER_FLAGSHIP_ITERS = 320
BLENDER_RATE_WINDOW = (400, 500)  # the eager steps timed, by the i_print (20) times
BLENDER_VIDEO_FRAMES = 40  # the spherical demo path
PSNR_MATCH_DB = 1e-4


class _StampedLines:
    """stdout that also keeps each line with the host clock's time, so that
    train_loop's own messages time its checkpoint, video and test set."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.out.write(text)
        if text.strip():
            self.lines.append((time.perf_counter(), text.strip()))
        return len(text)

    def flush(self):
        self.out.flush()

    def at(self, prefix: str) -> float:
        t = next((t for t, ln in self.lines if ln.startswith(prefix)), None)
        require(t is not None, f"no line starting {prefix!r} was printed")
        return t


def gif_frames(path: str):
    """(frames, (H, W)) of a GIF, walking its blocks."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    require(data[:6] in (b"GIF87a", b"GIF89a"), f"{path}: not a GIF")
    W, H, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
    n = 0

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:
            n += 1
            lflags = data[pos + 9]
            pos += 10 + (3 * 2 ** ((lflags & 7) + 1) if lflags & 0x80 else 0)
            pos = skip_blocks(pos + 1)
        else:
            raise CheckFailed(f"{path}: bad GIF block 0x{data[pos]:02x}")
    return n, (H, W)


def video_frames(path_base: str):
    """(path, frames, (H, W)) of the video save_video wrote for `path_base`
    + .mp4: the mp4 (counted by ffprobe) or the GIF beside it."""
    if os.path.exists(path_base + ".gif"):
        return (path_base + ".gif",) + gif_frames(path_base + ".gif")
    mp4 = path_base + ".mp4"
    require(os.path.exists(mp4), f"no video at {path_base}.mp4 or .gif")
    out = subprocess.run(["ffprobe", "-v", "error", "-count_frames", "-select_streams", "v:0",
                          "-show_entries", "stream=nb_read_frames,height,width", "-of", "csv=p=0",
                          mp4], capture_output=True, text=True, timeout=300, check=True).stdout
    w, h, n = (int(v) for v in out.strip().split(","))
    return mp4, n, (h, w)


def _psnr_pickle(d: str):
    import glob
    import pickle

    pkls = glob.glob(os.path.join(d, "test_psnrs_avg*.pkl"))
    require(len(pkls) == 1, f"{d}: {len(pkls)} PSNR pickles")
    with open(pkls[0], "rb") as f:
        return pickle.load(f)


def _check_run(np, trainer, expdir: str, n: int, n_test: int, hw, stamps, what: str,
               n_frames: int = BLENDER_VIDEO_FRAMES):
    """The gates of a training run on a set from disk: finite losses that
    fall, a checkpoint, the test set's figures and PSNR pickle, and the
    spiral video of the demo path (rgb and disparity)."""
    from hashnerf_torch.utils.png import read_png

    losses = [h[1] for h in trainer.history]
    require(len(losses) >= 10 and all(np.isfinite(losses)), f"{what}: losses {losses}")
    require(np.mean(losses[-5:]) < np.mean(losses[:5]), f"{what}: the loss did not fall: {losses}")
    require(os.path.exists(os.path.join(expdir, "{:06d}.ckpt".format(n))), f"{what}: no checkpoint")
    testdir = os.path.join(expdir, "testset_{:06d}".format(n))
    H, W = hw
    for i in range(n_test):
        fig = read_png(os.path.join(testdir, "{:03d}.png".format(i)))
        require(fig.shape == (H, 2 * W, 3), f"{what}: figure {i} is {fig.shape}")
    psnrs = _psnr_pickle(testdir)
    require(len(psnrs) == n_test and all(np.isfinite(psnrs)), f"{what}: PSNRs {psnrs}")
    videos = {}
    for kind in ("rgb", "disp"):
        base = os.path.join(expdir, "{}_spiral_{:06d}_{}".format(trainer.args.expname, n, kind))
        path, frames, shape = video_frames(base)
        require(frames == n_frames and shape == (H, W),
                f"{what}: {path} has {frames} frames of {shape}")
        videos[kind] = os.path.basename(path)
    t_ckpt = stamps.at("Saved checkpoints")
    t_video = stamps.at("Saved video")
    return {"losses": losses, "test_psnrs": psnrs, "videos": videos,
            "video_s": t_video - t_ckpt, "testset_s": stamps.at("Saved test set") - t_video,
            "testset_s_per_view": (stamps.at("Saved test set") - t_video) / n_test}


def _run(run_nerf, argv):
    """run_nerf.main(argv) with its stdout stamped line by line."""
    import contextlib

    stamps = _StampedLines(sys.stdout)
    with contextlib.redirect_stdout(stamps):
        trainer = run_nerf(argv)
    return trainer, stamps


def phase_blender(torch, np, smi: str, profile: bool, data: str):
    """The blender path end to end: write the set into `data` (kept there
    for phase_tools), check the loader against the frames written, train
    the chair, render only, train the flagship, render the JAX package's
    checkpoint; K2, K6, K5 (the chair), K7 and K8 (the flagship) must
    launch on it and K1, K3 and K4 must not.
    `profile` adds a profiler breakdown of three chair steps on the blender
    set."""
    import pickle

    from hashnerf_torch import kernels
    from hashnerf_torch.data.blender import load_blender_scene
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.run_nerf import main as run_nerf
    from hashnerf_torch.tools.make_blender_dataset import main as make_set
    from hashnerf_torch.train.checkpoint import load_jax_checkpoint
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer
    from hashnerf_torch.utils.png import read_png

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_blender_")
    try:
        logs = os.path.join(workdir, "logs")
        t0 = time.perf_counter()
        frames = make_set([data, *BLENDER_SET])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = load_blender_scene(data, half_res=False, testskip=1, white_bkgd=False)
        load_s = time.perf_counter() - t0
        want = np.concatenate([frames[s][..., :3] for s in ("train", "val", "test")])
        png_diffs = int((sc.images != (want / 255.0).astype(np.float32)).sum())
        require(png_diffs == 0, f"blender: {png_diffs} loaded values differ from the frames written")
        n_test = len(frames["test"])
        del sc, want, frames

        base = ["--config", os.path.join(ROOT, "configs", "chair.txt"), "--datadir", data,
                "--basedir", logs, "--device", DEV, "--testskip", "1"]
        n = BLENDER_ITERS
        every = [str(n)] * 3
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, stamps = _run(run_nerf, base + ["--N_iters", str(n), "--i_print", "20", "--no_reload",
                                                 "--i_weights", every[0], "--i_testset", every[1],
                                                 "--i_video", every[2]])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        sc, args = trainer.scene, trainer.args
        hw = (sc.H, sc.W)
        require(hw == (400, 400), f"blender: half_res gave {hw}")
        expdir = os.path.join(logs, args.expname)
        chair = _check_run(np, trainer, expdir, n, n_test, hw, stamps, "chair")
        with open(os.path.join(expdir, "loss_vs_time.pkl"), "rb") as f:
            hist = pickle.load(f)
        iters = [h[0] for h in trainer.history]
        a, b = (iters.index(i) for i in BLENDER_RATE_WINDOW)
        rate = (BLENDER_RATE_WINDOW[1] - BLENDER_RATE_WINDOW[0]) * args.N_rand / (hist["time"][b] - hist["time"][a])
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        # 10 more steps with TV timed as the main paths time theirs
        # (timed_steps: a synchronise a step), beside the procedural scene's
        tv_s, _ = timed_steps(torch, trainer, 10)
        prof = None
        if profile:
            prof = {"path": "blender chair", **profile_steps(torch, trainer, 3, statistics.median(tv_s))}
        del trainer

        # render only: the checkpoint of step n through the same forward pass
        t0 = time.perf_counter()
        r, _ = _run(run_nerf, base + ["--N_iters", str(n), "--render_only", "--render_test"])
        torch.cuda.synchronize()
        render_only_s = time.perf_counter() - t0
        require(r.global_step == n, f"render only restored step {r.global_step}")
        onlydir = os.path.join(expdir, "renderonly_test_{:06d}".format(n))
        only_psnrs = _psnr_pickle(onlydir)
        psnr_diff = max(abs(x - y) for x, y in zip(only_psnrs, chair["test_psnrs"]))
        require(len(only_psnrs) == n_test and psnr_diff <= PSNR_MATCH_DB,
                f"render-only PSNRs {only_psnrs} vs training's {chair['test_psnrs']}")
        del r
        r, _ = _run(run_nerf, base + ["--N_iters", str(n), "--render_only", "--render_factor", "4"])
        pathdir = os.path.join(expdir, "renderonly_path_{:06d}".format(n))
        small = [read_png(os.path.join(pathdir, "{:03d}.png".format(i))).shape
                 for i in range(BLENDER_VIDEO_FRAMES)]
        require(set(small) == {(100, 200, 3)}, f"render_factor 4 figures {set(small)}")
        del r
        c_chair = kernel_launches()

        # the flagship preset on the same set; every step from the warmup on
        # must cull at its budgets (blocks of graph replays and single steps)
        nf = BLENDER_FLAGSHIP_ITERS
        culls = []
        run_block, step = Trainer._run_block, Trainer.step

        def rec_block(self, b, *a, **kw):
            g = self.global_step
            m = run_block(self, b, *a, **kw)
            culls.append((g, b, self.last_occ_keep))
            return m

        def rec_step(self, *a, **kw):
            g = self.global_step
            m = step(self, *a, **kw)
            culls.append((g, 1, self.last_occ_keep))
            return m

        Trainer._run_block, Trainer.step = rec_block, rec_step
        try:
            t0 = time.perf_counter()
            ft, fstamps = _run(run_nerf, base + [
                "--preset", "tpu-fast", "--expname", "blender_flagship", "--N_iters", str(nf),
                "--i_print", "16", "--no_reload", "--i_weights", str(nf), "--i_testset", str(nf),
                "--i_video", str(nf)])
            torch.cuda.synchronize()
            flagship_s = time.perf_counter() - t0
        finally:
            Trainer._run_block, Trainer.step = run_block, step
        warmup = ft.render_cfg.occupancy.warmup_steps
        require(sum(b for _, b, _ in culls) == nf, f"flagship: steps recorded {culls}")
        bad = [c for c in culls if (c[2] == PATHS["flagship"]["keeps_tv"]) != (c[0] >= warmup)]
        require(not bad, f"flagship: steps not culled at {PATHS['flagship']['keeps_tv']} from "
                f"{warmup} on (or culled before): {bad}")
        flagship = _check_run(np, ft, os.path.join(logs, ft.args.expname), nf, n_test, hw, fstamps,
                              "flagship")
        del ft

        # the JAX package's checkpoint, rendered on the card
        view = np.load(os.path.join(ROOT, JAX_FIXTURE, "view.npz"))
        flags = [os.path.join(ROOT, f) if f.endswith(".txt") else f for f in view["flags"]]
        jt = Trainer(parse_args(flags + ["--device", DEV]), make_synthetic_scene(), device=DEV)
        step_j = load_jax_checkpoint(os.path.join(ROOT, JAX_FIXTURE, "000008.ckpt"), jt.state,
                                     jt.optimizer)
        rgb_j = jt.render_image(view["c2w"])[0].cpu().numpy()
        ok, jax_err = jax_view_close(rgb_j, view["rgb"])
        require(step_j == 8 and ok, f"JAX checkpoint (step {step_j}) view: {jax_err}")
        del jt

        counts = kernel_launches()
        for name in CHAIR_KERNELS + PACKED_KERNELS:  # the chair's runs, the flagship's
            require(counts[name] > 0, f"kernel {name} was not launched on the blender path")
        for name in OFF_PATH:
            require(counts[name] == 0, f"kernel {name} was launched on the blender path")
        peak = torch.cuda.max_memory_allocated() / 2**30
        phase_s = time.perf_counter() - t_phase
        rec = {
            "phase": "blender", "card": smi, "set": BLENDER_SET, "iters": n, "flagship_iters": nf,
            "write_s": write_s, "load_s": load_s, "png_diffs": png_diffs, "train_s": train_s,
            "train_rays_per_s_eager_400_500": rate, "print_times_s": hist["time"],
            "print_iters": iters, "step_ms_tv_timed": [t * 1e3 for t in tv_s],
            "train_rays_per_s_tv_timed": args.N_rand / statistics.median(tv_s),
            "test_psnr_mean": float(np.mean(chair["test_psnrs"])),
            "render_s_per_view": chair["testset_s_per_view"], "video_s": chair["video_s"],
            "render_only_s": render_only_s, "render_only_psnr_max_diff_db": psnr_diff,
            "chair": chair, "flagship": {**flagship, "train_s": flagship_s, "culls": len(culls)},
            "flagship_test_psnr_mean": float(np.mean(flagship["test_psnrs"])),
            "jax_checkpoint_view": jax_err, "peak_mem_gib_train": train_peak, "peak_mem_gib": peak,
            "launches_after_chair": c_chair, "launches": counts, "phase_s": phase_s,
        }
        emit(rec)
        if prof is not None:
            emit(prof)
        shown = [("load_s", load_s), ("train_s", train_s), ("eager rays/s 400-500", rate),
                 ("test PSNR dB (sign of life)", rec["test_psnr_mean"]),
                 ("render s per 400x400 view", rec["render_s_per_view"]), ("video_s", rec["video_s"]),
                 ("peak GiB", peak), ("phase_s", phase_s)]
        print("blender: " + "; ".join(f"{k} {v:.6g} [{smi}]" for k, v in shown), flush=True)
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# The llff phase: an LLFF-format set of fern's layout and size (20 frames;
# poses_bounds.npy with fern's 3024 x 4032 hwf and a forward-facing rig;
# images_8 PNGs of 378 x 504) written by llff_set from the procedural tracer,
# and configs/fern.txt trained on it through run_nerf.main, with ray batching
# and NDC, for LLFF_ITERS steps (of 50,000), outputs at the last; then
# render-only, a graphed pool window with TV and one without, timed eager and
# graphed steps, K2 and K6 on the path's points against their plain
# versions, and rows of one test view on the card against the CPU.
LLFF_FRAMES = 20
LLFF_HW_FULL = (3024, 4032)
LLFF_FOCAL_FULL = 3260.0  # about fern's
LLFF_FACTOR = 8
LLFF_NEAR_DEPTH = 4.0 / 3.0  # the loader puts the nearest bound there (bd_factor 0.75)
LLFF_SCENE_DEPTH = 3.5  # of the tracer's origin before the rig: its spheres at 2.4-4.6
LLFF_ITERS = 300
LLFF_VIDEO_FRAMES = 120  # the spiral path
LLFF_SPEC = {"keeps_tv": None, "keeps_no_tv": None}  # no culling
LLFF_GRAPH_TV_START = 320
LLFF_CPU_CHUNK = 4096  # rays a chunk of the CPU render (its memory)
LLFF_CPU_ROW_STRIDE = 8  # the CPU renders every 8th row of the view: 48 of 378


def llff_set(np, root: str, factor: int = LLFF_FACTOR):
    """Write an LLFF set of fern's layout under root, its frames in
    images_{factor} at fern's size / factor, and return them (uint8, image
    order). The rig: LLFF_FRAMES cameras on a 5 x 4 grid 0.3
    wide, each turned by up to 2 degrees, written in LLFF's [down, right,
    back] axes, with bounds (1.33-1.47, 4.8-5.2 after the loader's scaling)
    around the scene. The frames are the procedural tracer's "multi" scene
    (no supersampling) seen from the poses the loader makes of the file
    (axis fix, bd_factor scaling, recentering), its origin LLFF_SCENE_DEPTH
    before the rig: frames of zeros are written and loaded once to get
    those poses, then overwritten."""
    from hashnerf_torch.data.llff import load_llff_scene
    from hashnerf_torch.data.synthetic import _render_view
    from hashnerf_torch.utils.png import write_png

    rng = np.random.default_rng(0)
    n, f = LLFF_FRAMES, factor
    H, W = LLFF_HW_FULL[0] // f, LLFF_HW_FULL[1] // f
    scale = 1.7  # the file's units: any scale loads to the same poses
    rows = []
    for k in range(n):
        ax, ay = np.radians(rng.uniform(-2.0, 2.0, 2))
        rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
        ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
        t = np.array([(k % 5 - 2) * 0.075, (k // 5 - 1.5) * 0.075, rng.uniform(-0.02, 0.02)])
        c2w = np.concatenate([rx @ ry, t[:, None]], 1) * [1, 1, 1, scale]  # NeRF axes
        llff = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:3], c2w[:, 3:4]], 1)
        hwf = np.array([[LLFF_HW_FULL[0]], [LLFF_HW_FULL[1]], [LLFF_FOCAL_FULL]])
        bds = scale * np.array([LLFF_NEAR_DEPTH * (1.0 if k == 0 else rng.uniform(1.0, 1.1)),
                                rng.uniform(4.8, 5.2)])
        rows.append(np.concatenate([np.concatenate([llff, hwf], 1).ravel(), bds]))
    os.makedirs(os.path.join(root, f"images_{f}"))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    paths = [os.path.join(root, f"images_{f}", f"IMG_{k:04d}.png") for k in range(n)]
    for p in paths:
        write_png(p, np.zeros((H, W, 3), np.uint8))
    sc = load_llff_scene(root, factor=f)
    frames = []
    for pose, p in zip(sc.poses, paths):
        c2w = pose.astype(np.float64)
        c2w[2, 3] += LLFF_SCENE_DEPTH  # the camera back, so the scene in front
        img = _render_view(H, W, sc.K, c2w, "multi", 1)
        frames.append(np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))
        write_png(p, frames[-1])
    return np.stack(frames)


def render_on_rays(torch, state, rays, bbox, cfg, near: float, far: float, chunk: int):
    """rgb of render_rays over (rays_o, rays_d, viewdirs) in chunks, as
    render() runs them, on the device of `state`, from rays made once."""
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import render_rays

    dev = bbox.device
    out = []
    with torch.no_grad():
        for s in range(0, rays[0].shape[0], chunk):
            o, d, v = (r[s:s + chunk].to(dev) for r in rays)
            out.append(render_rays(state, query_fn, o, d, v, near, far, bbox, cfg)["rgb_map"].cpu())
    return torch.cat(out)


def encode_check(torch, trainer, batch, path: str, ndc: bool = False):
    """K2 and K6 at a path's shapes, on its own points: the coarse (R x
    N_samples) and fine (R x (N_samples + N_importance)) sample points of
    the R rays of one batch (a pool's N_rand, or a data-parallel rank's
    share of the global batch), warped to NDC where the path is
    (llff) and sampled as a training step samples them (a generator of its
    own), in the trainer's box (llff's NDC box has a z pad of 1e-4: a
    sample at t = 0 or 1 lies on a face), on the trained table, with a
    seeded cotangent. Each is held against its plain version by
    check_encode and timed beside it and its bound (the rows it touches
    from the plain corner expansion)."""
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.ops.rays import get_ndc_rays
    from hashnerf_torch.render.renderer import render_rays

    sc, state, args = trainer.scene, trainer.state, trainer.args
    pts = {}

    def capture(st, p, viewdirs, bbox, fine=False):
        pts["fine" if fine else "coarse"] = p.reshape(-1, 3).contiguous()
        return query_fn(st, p, viewdirs, bbox, fine=fine)

    dev = trainer.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    o, d = batch["rays_o"], batch["rays_d"]
    if ndc:
        o, d_in = get_ndc_rays(sc.H, sc.W, sc.focal, 1.0, o, d)
    else:
        d_in = d
    with torch.no_grad():
        render_rays(state, capture, o, d_in, d / torch.linalg.norm(d, dim=-1, keepdim=True),
                    batch["near"], batch["far"], trainer.bbox, trainer.render_cfg, generator=gen)
    table = state.hash_table.detach()
    bmin, bmax, res = trainer.bbox[0].contiguous(), trainer.bbox[1].contiguous(), state.resolutions
    out = {}
    for name, n_samples in (("coarse", args.N_samples), ("fine", args.N_samples + args.N_importance)):
        xs = pts[name]
        n = xs.shape[0]
        require(n == o.shape[0] * n_samples, f"{path} {name} pass encodes {n} points")
        out[name] = encode_at(torch, f"{path}_{name}", table, xs, bmin, bmax, res, gen)
    return out


def encode_at(torch, what: str, table, xs, bmin, bmax, res, gen):
    """K2 and K6 on points xs of a (L, T, F) table, with a cotangent from
    gen: held against their plain versions (check_encode) and timed beside
    them and their bound (the rows they touch, from the plain corner
    expansion)."""
    from hashnerf_torch.kernels.hash_encode import (
        hash_encode_bwd, hash_encode_bwd_expand_plain, hash_encode_bwd_plain, hash_encode_fwd,
        hash_encode_fwd_plain,
    )

    L, T, F = table.shape
    n = xs.shape[0]
    gs = torch.randn((n, L * F), generator=gen, device=xs.device)
    ref = {
        "k2": hash_encode_fwd_plain(table, xs, bmin, bmax, res),
        "k2_abs_sum": blend_abs_sum(torch, table, xs, bmin, bmax, res),
        "k6": hash_encode_bwd_plain(xs, bmin, bmax, res, gs, T),
        "k6_abs_sum": hash_encode_bwd_plain(xs, bmin, bmax, res, gs.abs(), T),
    }
    errs = check_encode(torch, what, ref, hash_encode_fwd(table, xs, bmin, bmax, res),
                        hash_encode_bwd(xs, bmin, bmax, res, gs, T))
    z_face = ((xs[:, 2] - bmin[2]).abs() <= 2e-4) | ((bmax[2] - xs[:, 2]).abs() <= 2e-4)
    rows = int(torch.unique(hash_encode_bwd_expand_plain(xs, bmin, bmax, res, gs, T)[0]).numel())
    # K2_OPS and K6_OPS at this F (they are written for the chair's F = 2)
    b2 = bound(n * 12 + rows * F * 4 + n * L * F * 4 + n + 24 + L * 4, n * L * (GEOM_OPS + 16 * F))
    b6 = bound(n * 12 + n * L * F * 4 + L * T * F * 4 + 24 + L * 4,
               n * L * (GEOM_OPS + 16 * F + 8))
    rec = {
        "N": n, "table": [L, T, F], **errs, "keep_fraction": float(ref["k2"][1].float().mean()),
        "touched_rows": rows,
        "k2_bound_ms": b2[0], "k2_bound_by": b2[1], "k6_bound_ms": b6[0], "k6_bound_by": b6[1],
        "points_within_2e-4_of_a_z_face": int(z_face.sum()),
        "k2_ms": cuda_ms(torch, lambda: hash_encode_fwd(table, xs, bmin, bmax, res)),
        "k2_plain_ms": cuda_ms(torch, lambda: hash_encode_fwd_plain(table, xs, bmin, bmax, res),
                               reps=5),
        "k6_ms": cuda_ms(torch, lambda: hash_encode_bwd(xs, bmin, bmax, res, gs, T)),
        "k6_plain_ms": cuda_ms(torch, lambda: hash_encode_bwd_plain(xs, bmin, bmax, res, gs, T),
                               reps=3),
    }
    emit({"phase": "encode_shape", "points": what, **rec})
    return rec


# --------------------------------------------------------------------------- #
# The llff view gate, stage by stage
# --------------------------------------------------------------------------- #
# The card's render of a view and the CPU's differ in their last bits
# (cuBLAS against the CPU's GEMM, K2's blend order, the card's parallel
# cumsum). Three of the reference's step functions can turn such bits into a
# jump of a fine sample: sample_pdf's denominator, replaced by 1 below 1e-5;
# its count of cdf entries <= u at a bin boundary (u = 1 against cdf[-1] at
# the end); and the box's keep mask at a face. So the view is held on the
# same rays stage by stage (hold_view_stages): the coarse pass; the fine pass
# at the card's placement; and the placement itself, where a difference is
# admitted only as far as the devices' cdf differences carry it, or at a
# decision that they took apart within rounding. Margins are counted in
# VIEW_CDF_ULP, the spacing of float32 in [0.5, 1) where the cdf ends, and
# for the keep mask in ulps of the face. The card's and the CPU's cdf of
# the llff view lie at most 12 of them apart (PERF.md §6).
VIEW_CDF_ULP = 2.0**-24
VIEW_RISK_ULPS = 64  # a margin within this many ulps is within rounding
VIEW_RISK_LEAST = 256  # the rays of least margin, rendered on the CPU whatever their margin
VIEW_COARSE_TOL = (1e-5, 1e-6)  # (rtol, atol): ROADMAP §C's coarse render tolerances
VIEW_FINE_TOL = (1e-4, 5e-5)  # and its fine ones
VIEW_SAVE_RAYS = 64  # the worst failing rays whose stages and table rows a failure saves
VIEW_FAILURE_FILE = os.path.join(ROOT, "chiprun_out", "llff_view_failure.pt")


def render_stages(torch, state, rays, bbox, cfg, near: float, far: float, chunk: int):
    """render_rays over rays = (rays_o, rays_d, viewdirs) in chunks, as
    render() runs them, on the device of bbox, each chunk with a StageTap:
    {stage: {name: tensor over all rays}} on that device (utils/debug.py
    says what each stage holds)."""
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import render_rays
    from hashnerf_torch.utils.debug import StageTap

    dev = bbox.device
    parts = {}
    with torch.no_grad():
        for s in range(0, rays[0].shape[0], chunk):
            o, d, v = (r[s:s + chunk].to(dev) for r in rays)
            tap = StageTap()
            render_rays(state, query_fn, o, d, v, near, far, bbox, cfg, tap=tap)
            for stage, ts in tap.stages.items():
                for k, t in ts.items():
                    parts.setdefault(stage, {}).setdefault(k, []).append(t)
    return {stage: {k: torch.cat(v) for k, v in ts.items()} for stage, ts in parts.items()}


def fine_pass_at(torch, state, rays, z, bbox, cfg, chunk: int):
    """The fine pass of an unculled eval render (render_rays' march: the
    fine net's query at o + d z and raw2outputs) at given sorted z values
    (R, N_samples + N_importance), in chunks on the device of bbox:
    {"fine": {z, raw, weights, rgb}}."""
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.ops.volume import raw2outputs

    dev = bbox.device
    parts = {}
    with torch.no_grad():
        for s in range(0, rays[0].shape[0], chunk):
            o, d, v, zc = (r[s:s + chunk].to(dev) for r in (*rays, z))
            raw = query_fn(state, o[:, None, :] + d[:, None, :] * zc[..., None], v, bbox, fine=True)
            out = raw2outputs(raw, zc, d, cfg.raw_noise_std, cfg.white_bkgd)
            for k, t in (("z", zc), ("raw", raw), ("weights", out.weights), ("rgb", out.rgb_map)):
                parts.setdefault(k, []).append(t)
    return {"fine": {k: torch.cat(v) for k, v in parts.items()}}


def stages_at(stages, idx, device="cpu"):
    """The rays idx of a render_stages result, on `device`."""
    return {stage: {k: v[idx.to(v.device)].to(device) for k, v in ts.items()}
            for stage, ts in stages.items()}


def placement_margins(torch, sp):
    """(R, S): for each u of sample_pdf's stage sp, how far (in VIEW_CDF_ULP)
    the cdf may move before the u's sample jumps. (1) The denominator of u's
    bin against 1e-5, where u is not at the bin's lower edge (there the
    switch moves nothing) and the bin is not the clamped end. (2) u against
    the boundary cdf[below] or cdf[above] (never cdf[0] = 0, which is exact):
    crossing it moves the sample continuously unless the bin under the
    boundary is switched, so that margin counts only as far as that bin's
    denominator is within reach of 1e-5. u = 1 against cdf[-1] is case (2)
    at the last boundary."""
    cdf, u, below, above, denom = (sp[k] for k in ("cdf", "u", "below", "above", "denom"))
    inf = torch.full_like(u, float("inf"))
    d_bins = cdf[:, 1:] - cdf[:, :-1]  # each bin's denominator, as sample_pdf forms it
    over = lambda d: (d - 1e-5).clamp(min=0)
    cdf_below = cdf.gather(-1, below)
    m1 = torch.where((below != above) & (u > cdf_below), (denom - 1e-5).abs(), inf)
    lo = torch.where(below >= 1, torch.maximum((u - cdf_below).abs(),
                                               over(d_bins.gather(-1, (below - 1).clamp(min=0)))),
                     inf)
    hi = torch.where(below != above, torch.maximum((cdf.gather(-1, above) - u).abs(), over(denom)),
                     inf)
    return torch.minimum(m1, torch.minimum(lo, hi)) / VIEW_CDF_ULP


def keep_margins(torch, rays, z, bbox):
    """(R,): the least distance of a ray's points o + d z (z (R, S)) to a
    face of the box, in ulps of that face's coordinate: the keep mask's
    margin."""
    o, d = rays[0].to(z.device), rays[1].to(z.device)
    p = o[:, None, :] + d[:, None, :] * z[..., None]
    lo, hi = bbox[0].to(z.device), bbox[1].to(z.device)
    ulp = lambda f: torch.nextafter(f.abs(), torch.full_like(f, float("inf"))) - f.abs()
    m = torch.minimum((p - lo).abs() / ulp(lo), (hi - p).abs() / ulp(hi))
    return m.amin(dim=(1, 2))


def view_margins(torch, stages, rays, bbox):
    """Each ray's least margin at the reference's step functions, from a
    render_stages result over `rays` in the box bbox: {"pdf" (R,), "keep"
    (R,), "least" (R,)}, each on the stages' device."""
    pdf = placement_margins(torch, stages["sample_pdf"]).amin(dim=-1)
    keep = torch.minimum(keep_margins(torch, rays, stages["coarse"]["z"], bbox),
                         keep_margins(torch, rays, stages["fine"]["z"], bbox))
    return {"pdf": pdf, "keep": keep, "least": torch.minimum(pdf, keep)}


def view_selection(torch, least, strided):
    """The rays to render on the CPU: `strided`, every ray whose least
    margin is within VIEW_RISK_ULPS, and the VIEW_RISK_LEAST rays of least
    margin; sorted, on the CPU."""
    least = least.cpu()
    n_risk = max(int((least <= VIEW_RISK_ULPS).sum()), min(VIEW_RISK_LEAST, least.numel()))
    return torch.unique(torch.cat([strided.cpu(), torch.argsort(least)[:n_risk]]))


def _close(torch, got, want, tol):
    """Per ray, the largest |got - want| over (atol + rtol |want|): <= 1
    within tolerance."""
    rtol, atol = tol
    r = (got - want).abs() / (atol + rtol * want.abs())
    return r.reshape(r.shape[0], -1).amax(dim=-1)


def pdf_flips(torch, card, cpu):
    """sample_pdf's decisions that the two renders of the same rays took
    apart: (ray, u) where the count of cdf entries <= u differs, or, in the
    same bin, the denominator's switch at 1e-5. Each with its margin on
    either device, in VIEW_CDF_ULP: |u - cdf[k]| at the boundaries k the
    counts put apart, or |denom - 1e-5|. Returns (flipped (R, S) bool,
    margin_card (R, S), margin_cpu (R, S); inf where nothing flipped)."""
    a, b = card["sample_pdf"], cpu["sample_pdf"]
    inds_a, inds_b = a["inds"], b["inds"]
    sw_a, sw_b = a["denom"] < 1e-5, b["denom"] < 1e-5
    count = inds_a != inds_b
    switch = ~count & (a["below"] != a["above"]) & (sw_a != sw_b)
    inf = torch.full_like(a["u"], float("inf"))

    def margin(sp):
        # the boundaries crossed: cdf[k] for k from min(inds) to max(inds) - 1
        lo, hi = torch.minimum(inds_a, inds_b), torch.maximum(inds_a, inds_b)
        m = inf.clone()
        for k in range(int((hi - lo).max()) if bool(count.any()) else 0):
            idx = (lo + k).clamp(max=sp["cdf"].shape[-1] - 1)
            gap = (sp["u"] - sp["cdf"].gather(-1, idx)).abs()
            m = torch.where(count & (lo + k < hi), torch.minimum(m, gap), m)
        m = torch.where(switch, (sp["denom"] - 1e-5).abs(), m)
        return m / VIEW_CDF_ULP

    return count | switch, margin(a), margin(b)


def placement_tolerance(torch, card, cpu):
    """(R, S): how far the two renders' samples z may lie apart where
    sample_pdf took the same decisions: the differences of their inputs
    (bin edges, cdf, denominator) carried through z = below + (u - cdf_below)
    / denom * width, twice, plus one VIEW_CDF_ULP of u - cdf_below and 4
    ulps of z."""
    out = []
    for sp in (card["sample_pdf"], cpu["sample_pdf"]):
        cb = sp["cdf"].gather(-1, sp["below"])
        d = torch.where(sp["denom"] < 1e-5, torch.ones_like(sp["denom"]), sp["denom"])
        bb, ba = sp["bins"].gather(-1, sp["below"]), sp["bins"].gather(-1, sp["above"])
        out.append((cb, d, bb, ba - bb))
    (cb1, d1, bb1, w1), (cb2, d2, bb2, w2) = out
    t = ((card["sample_pdf"]["u"] - cb1) / d1).clamp(0, 1)
    dmin = torch.minimum(d1, d2)
    w = torch.maximum(w1.abs(), w2.abs())
    pred = ((bb1 - bb2).abs() + t * (w1 - w2).abs()
            + w * ((cb1 - cb2).abs() + t * (d1 - d2).abs()) / dmin)
    z = card["sample_pdf"]["z"]
    ulp = torch.nextafter(z.abs(), torch.full_like(z, float("inf"))) - z.abs()
    return 2 * pred + w * VIEW_CDF_ULP / dmin + 4 * ulp


def hold_view_stages(torch, np, card, cpu, at_card):
    """The llff view gate on one set of rays: card and cpu are render_stages
    of them on the two devices, at_card the CPU's fine pass at the card's
    fine z (fine_pass_at); all on the CPU. (a) The coarse pass's rgb and
    weights within VIEW_COARSE_TOL. (b) At the card's placement, the fine
    raw within VIEW_FINE_TOL and the rgb by jax_view_close. (c) The
    placement: every sample within placement_tolerance, except at
    decisions of sample_pdf that the devices took apart (pdf_flips) with
    both margins within VIEW_RISK_ULPS, each of which is listed. The whole
    render's rgb, card against CPU, is recorded; a ray over
    JAX_VIEW_MAX_TOL there fails unless (c) explains it: its samples lie
    apart by more than 4 ulps, and (c) admits each difference. Returns (ok,
    record, failing ray positions)."""
    fails = {}
    a = torch.maximum(_close(torch, card["coarse"]["rgb"], cpu["coarse"]["rgb"], VIEW_COARSE_TOL),
                      _close(torch, card["coarse"]["weights"], cpu["coarse"]["weights"],
                             VIEW_COARSE_TOL))
    fails["coarse"] = a > 1
    b_raw = _close(torch, at_card["fine"]["raw"], card["fine"]["raw"], VIEW_FINE_TOL)
    fails["fine_raw_at_card_z"] = b_raw > 1
    ok_b, b_err = jax_view_close(at_card["fine"]["rgb"].numpy(), card["fine"]["rgb"].numpy())
    b_ray = (at_card["fine"]["rgb"] - card["fine"]["rgb"]).abs().amax(dim=-1)
    fails["fine_rgb_at_card_z"] = b_ray > JAX_VIEW_MAX_TOL
    a_sp, b_sp = card["sample_pdf"], cpu["sample_pdf"]
    flipped, m_card, m_cpu = pdf_flips(torch, card, cpu)
    within = (m_card <= VIEW_RISK_ULPS) & (m_cpu <= VIEW_RISK_ULPS)
    z = a_sp["z"]
    dz = (z - b_sp["z"]).abs()
    moved = dz > placement_tolerance(torch, card, cpu)
    fails["placement"] = ((moved & ~flipped) | (flipped & ~within)).any(dim=-1)
    apart = (dz > 4 * (torch.nextafter(z.abs(), torch.full_like(z, float("inf"))) - z.abs()))
    explained = apart.any(dim=-1) & ~fails["placement"]
    whole = (card["fine"]["rgb"] - cpu["fine"]["rgb"]).abs().amax(dim=-1)
    fails["whole_rgb"] = (whole > JAX_VIEW_MAX_TOL) & ~explained
    ok_whole, whole_err = jax_view_close(card["fine"]["rgb"].numpy(), cpu["fine"]["rgb"].numpy())
    bad = torch.zeros_like(whole, dtype=torch.bool)
    for f in fails.values():
        bad |= f
    ok = ok_b and not bool(bad.any())
    count = a_sp["inds"] != b_sp["inds"]
    r_idx, s_idx = (flipped & within).nonzero(as_tuple=True)
    listed = {
        "ray": r_idx.tolist(), "u_index": s_idx.tolist(),
        "decision": ["count" if c else "switch" for c in count[r_idx, s_idx].tolist()],
        "margin_ulps_card": m_card[r_idx, s_idx].tolist(),
        "margin_ulps_cpu": m_cpu[r_idx, s_idx].tolist(),
        "dz": dz[r_idx, s_idx].tolist(), "rgb_err": whole[r_idx].tolist(),
    }
    rec = {
        "rays": int(whole.numel()), "ok": ok,
        "coarse_max_over_tol": float(a.max()),
        "fine_raw_at_card_z_max_over_tol": float(b_raw.max()),
        "fine_at_card_z": b_err, "card_vs_cpu": whole_err, "card_vs_cpu_within_view_tol": ok_whole,
        "placement_max_dz": float(dz.max()),
        "placed_apart_rays": int(apart.any(dim=-1).sum()),
        "flips": int(flipped.sum()), "flips_within_rounding": int((flipped & within).sum()),
        "flips_count": int((flipped & count).sum()), "flips_switch": int((flipped & ~count).sum()),
        "flip_rays": int(flipped.any(dim=-1).sum()),
        "flip_max_dz": float(dz[flipped].max()) if bool(flipped.any()) else 0.0,
        "explained_rays": int(explained.sum()),
        "explained_over_max_tol": int((explained & (whole > JAX_VIEW_MAX_TOL)).sum()),
        "explained": listed,
        "failing": {k: int(v.sum()) for k, v in fails.items()},
    }
    return ok, rec, bad.nonzero().flatten()


def save_view_failure(torch, path, state, cfg, bbox, near, far, rays, view_idx, order, renders):
    """Write what replay_view needs to replay a failed view gate to path
    (torch.save): the state the CPU rendered, the render config, the box and bounds, every
    failing ray's index in the view (view_idx: the view index of each of
    `rays`), and for the VIEW_SAVE_RAYS worst of them (`order`: positions
    in `rays`, worst first) their rays and each
    render's stages (renders: {name: render_stages result over `rays`}).
    The hash table keeps only the rows that those rays' points read (the
    whole table is 64 MiB; the file stays small enough to copy off the
    card's machine): the rows of every coarse and fine point of each
    render, by the plain geometry."""
    import dataclasses

    from hashnerf_torch.ops.hash_encoding import corner_geometry

    keep = order[:VIEW_SAVE_RAYS]
    sd = {k: v.detach().cpu() for k, v in state.state_dict().items() if k != "hash_table"}
    table = state.hash_table.detach().cpu()
    L, T, F = table.shape
    bb = bbox.cpu()
    ids = []
    sub = tuple(r[keep].cpu() for r in rays)
    for st in renders.values():
        for stage in ("coarse", "fine"):
            if stage not in st:
                continue
            z = st[stage]["z"][keep].cpu()
            pts = (sub[0][:, None, :] + sub[1][:, None, :] * z[..., None]).reshape(-1, 3)
            idx, _, _ = corner_geometry(pts, bb[0], bb[1], state.resolutions.cpu(), T.bit_length() - 1)
            ids.append((idx + (torch.arange(L) * T)[:, None, None]).reshape(-1).unique())
    rows = torch.cat(ids).unique()
    payload = {
        "model_cfg": dataclasses.asdict(state.cfg), "render_cfg": dataclasses.asdict(cfg),
        "table_shape": [L, T, F], "table_rows": rows.to(torch.int32),
        "table_values": table.reshape(L * T, F)[rows], "state": sd,
        "bbox": bb, "near": float(near), "far": float(far),
        "failing_view_idx": view_idx.cpu()[order], "saved_view_idx": view_idx.cpu()[keep],
        "rays": sub,
        "stages": {name: stages_at(st, keep) for name, st in renders.items()},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    return path


def load_view_state(torch, saved):
    """The NGPState of a save_view_failure payload, on the CPU, its table
    zero outside the rows saved."""
    from hashnerf_torch.models.factory import ModelConfig, NGPState
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    mc = dict(saved["model_cfg"])
    mc["hash_grid"] = HashGridConfig(**mc["hash_grid"])
    state = NGPState(ModelConfig(**mc), device="cpu")
    L, T, F = saved["table_shape"]
    table = torch.zeros(L * T, F)
    table[saved["table_rows"].long()] = saved["table_values"]
    state.load_state_dict({**saved["state"], "hash_table": table.reshape(L, T, F)})
    return state


def replay_view(torch, path):
    """Replay a save_view_failure file on the CPU, stage by stage: its rays
    through the CPU route, and fed the card's saved fine z. Returns
    {"saved": the payload, "cpu": the replayed render, "at_card": the
    replayed render at the card's z, "hold": hold_view_stages of the saved
    card stages against the replay (ok, record, failing rays)}."""
    import numpy as np

    from hashnerf_torch.render.renderer import RenderConfig

    saved = torch.load(path, weights_only=True)
    state = load_view_state(torch, saved)
    cfg = RenderConfig(**saved["render_cfg"])
    rays, bbox = saved["rays"], saved["bbox"]
    card = saved["stages"]["card"]
    cpu = render_stages(torch, state, rays, bbox, cfg, saved["near"], saved["far"], LLFF_CPU_CHUNK)
    at_card = fine_pass_at(torch, state, rays, card["fine"]["z"], bbox, cfg, LLFF_CPU_CHUNK)
    return {"saved": saved, "cpu": cpu, "at_card": at_card,
            "hold": hold_view_stages(torch, np, card, cpu, at_card)}


def view_gate(torch, np, state, rays, bbox, cfg, near, far, chunk, strided, save_to=None,
              cpu_state=None):
    """The llff view gate on one view (rays = (rays_o, rays_d, viewdirs) of
    every pixel, NDC): the whole view on the card with its stages
    (render_stages), each ray's margins (view_margins), the rays held
    (view_selection: `strided`, the rays at risk and the least margins),
    those rays on the CPU, and on the CPU again fed the card's fine z; then
    hold_view_stages. The CPU renders cpu_state, by default a copy of
    state. On failure save_to, when given, receives save_view_failure's
    file. Returns (ok, record, the tensors: "whole",
    "margins", "sel", "card", "cpu", "at_card", "bad")."""
    from hashnerf_torch.models.factory import NGPState

    sync = torch.cuda.synchronize if bbox.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    whole = render_stages(torch, state, rays, bbox, cfg, near, far, chunk)
    margins = view_margins(torch, whole, rays, bbox)
    sel = view_selection(torch, margins["least"], strided)
    card = stages_at(whole, sel)
    sync()
    card_s = time.perf_counter() - t0
    if cpu_state is None:
        cpu_state = NGPState(state.cfg, device="cpu")
        cpu_state.load_state_dict({k: v.cpu() for k, v in state.state_dict().items()})
    sub, bb = tuple(r[sel].cpu() for r in rays), bbox.cpu()
    t0 = time.perf_counter()
    cpu = render_stages(torch, cpu_state, sub, bb, cfg, near, far, LLFF_CPU_CHUNK)
    cpu_own_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    at_card = fine_pass_at(torch, cpu_state, sub, card["fine"]["z"], bb, cfg, LLFF_CPU_CHUNK)
    cpu_at_card_s = time.perf_counter() - t0
    ok, rec, bad = hold_view_stages(torch, np, card, cpu, at_card)
    rec["explained"]["ray"] = sel[rec["explained"]["ray"]].tolist()
    least = margins["least"].cpu()
    in_sel = torch.isin(sel, strided.cpu())
    _, strided_err = jax_view_close(card["fine"]["rgb"][in_sel].numpy(),
                                    cpu["fine"]["rgb"][in_sel].numpy())
    rec.update({
        "view_rays": int(least.numel()), "strided_rays": int(strided.numel()),
        "at_risk_rays": int((least <= VIEW_RISK_ULPS).sum()),
        "at_risk_pdf": int((margins["pdf"] <= VIEW_RISK_ULPS).sum()),
        "at_risk_keep": int((margins["keep"] <= VIEW_RISK_ULPS).sum()),
        "least_margin_ulps": [float(x) for x in torch.topk(least, 8, largest=False).values],
        "least_keep_margin_ulps": float(margins["keep"].min()),
        "card_view_s": card_s, "cpu_threads": torch.get_num_threads(),
        "cpu_view_s": cpu_own_s + cpu_at_card_s, "cpu_own_s": cpu_own_s,
        "cpu_at_card_z_s": cpu_at_card_s, "strided_card_vs_cpu": strided_err,
    })
    if not ok and save_to is not None:
        err = (card["fine"]["rgb"] - cpu["fine"]["rgb"]).abs().amax(dim=-1)
        order = bad[torch.argsort(err[bad], descending=True)]
        rec["saved"] = save_view_failure(torch, save_to, cpu_state, cfg, bbox, near, far, sub, sel,
                                         order, {"card": card, "cpu": cpu, "at_card": at_card})
        print(f"llff view gate failed; its state, rays and stages: {rec['saved']}", flush=True)
    parts = {"whole": whole, "margins": margins, "sel": sel, "card": card, "cpu": cpu,
             "at_card": at_card, "bad": bad}
    return ok, rec, parts


def phase_llff(torch, np, smi: str, profile: bool):
    """The LLFF path end to end (see LLFF_*): write the set, check the
    loader against the frames written, train configs/fern.txt with ray
    batching and NDC, render only, then the pool windows, K2 and K6 at the
    path's shapes (encode_check) and rows of one NDC view on the card
    against the CPU; K2, K6 and K5 (every TV step) must launch on it and
    K1, K3 and K4 must not."""
    import itertools

    from hashnerf_torch import kernels
    from hashnerf_torch.data.llff import load_llff_scene
    from hashnerf_torch.ops.rays import get_ndc_rays, get_rays
    from hashnerf_torch.run_nerf import main as run_nerf
    from hashnerf_torch.utils.png import read_png

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_llff_")
    try:
        data, logs = os.path.join(workdir, "fern"), os.path.join(workdir, "logs")
        t0 = time.perf_counter()
        frames = llff_set(np, data)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = load_llff_scene(data, factor=LLFF_FACTOR)
        load_s = time.perf_counter() - t0
        png_diffs = int((sc.images != (frames / 255.0).astype(np.float32)).sum())
        require(png_diffs == 0, f"llff: {png_diffs} loaded values differ from the frames written")
        hw = (sc.H, sc.W)
        require(hw == (378, 504) and sc.ndc and (sc.near, sc.far) == (0.0, 1.0),
                f"llff: the loader gave {hw}, ndc {sc.ndc}, bounds {(sc.near, sc.far)}")
        n_test = len(sc.i_test)
        require(n_test == 3, f"llff: {n_test} test views (llffhold 8 of 20 frames)")
        del sc, frames

        base = ["--config", os.path.join(ROOT, "configs", "fern.txt"), "--datadir", data,
                "--basedir", logs, "--device", DEV]
        n = LLFF_ITERS
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, stamps = _run(run_nerf, base + ["--N_iters", str(n), "--i_print", "20", "--no_reload",
                                                 "--i_weights", str(n), "--i_testset", str(n),
                                                 "--i_video", str(n)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        c_train = kernel_launches()
        run_peak = torch.cuda.max_memory_allocated() / 2**30
        args = trainer.args
        require(trainer.render_cfg.ndc and not args.no_batching and trainer.global_step == n,
                f"llff: ndc {trainer.render_cfg.ndc}, no_batching {args.no_batching}, "
                f"step {trainer.global_step}")
        expdir = os.path.join(logs, args.expname)
        fern = _check_run(np, trainer, expdir, n, n_test, hw, stamps, "fern", LLFF_VIDEO_FRAMES)
        # every step had TV (steps <= 1000): K5, its backward, each step
        require(c_train["segment_accumulate_k5"] >= n,
                f"llff: K5 launched {c_train['segment_accumulate_k5']} times in {n} TV steps")

        t0 = time.perf_counter()
        r, _ = _run(run_nerf, base + ["--N_iters", str(n), "--render_only", "--render_test"])
        torch.cuda.synchronize()
        render_only_s = time.perf_counter() - t0
        require(r.global_step == n, f"llff render only restored step {r.global_step}")
        only_psnrs = _psnr_pickle(os.path.join(expdir, "renderonly_test_{:06d}".format(n)))
        psnr_diff = max(abs(x - y) for x, y in zip(only_psnrs, fern["test_psnrs"]))
        require(len(only_psnrs) == n_test and psnr_diff <= PSNR_MATCH_DB,
                f"llff render-only PSNRs {only_psnrs} vs training's {fern['test_psnrs']}")
        del r
        r, _ = _run(run_nerf, base + ["--N_iters", str(n), "--render_only", "--render_factor", "4"])
        pathdir = os.path.join(expdir, "renderonly_path_{:06d}".format(n))
        small = {read_png(os.path.join(pathdir, "{:03d}.png".format(i))).shape
                 for i in range(LLFF_VIDEO_FRAMES)}
        require(small == {(hw[0] // 4, 2 * (hw[1] // 4), 3)}, f"llff render_factor 4 figures {small}")
        del r

        # the ray pool on the card, then eager and graphed pool steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = trainer.build_ray_pool()
        torch.cuda.synchronize()
        pool_s = time.perf_counter() - t0
        pool_rows, pool_gib = pool.shape[0], pool.numel() * pool.element_size() / 2**30
        rows = itertools.count(0, args.N_rand)
        batches = lambda: trainer.sample_pool(pool, next(rows), args.N_rand)
        torch.cuda.reset_peak_memory_stats()
        c0 = kernel_launches()
        tv_s, tv_losses = timed_steps(torch, trainer, 10, batches=batches)  # TV on
        c1 = kernel_launches()
        trainer.global_step = 1001
        notv_s, notv_losses = timed_steps(torch, trainer, 20, batches=batches)
        c2 = kernel_launches()
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        require(all(np.isfinite(tv_losses + notv_losses)), "llff: non-finite timed loss")
        prof = None
        if profile:
            prof = {"path": "llff", **profile_steps(torch, trainer, 3, statistics.median(notv_s),
                                                    batches=batches)}
        at = next(rows)
        graphed = {"tv": graphed_window(torch, trainer, "llff", LLFF_GRAPH_TV_START, "tv", profile,
                                        pool=pool, offset=at),
                   "no_tv": graphed_window(torch, trainer, "llff", GRAPH_NO_TV_START, "no_tv",
                                           profile, pool=pool, offset=at)}
        for window, k5 in (("tv", True), ("no_tv", False)):
            per = graphed[window]["launches_per_step"]
            require(per["hash_encode_fwd"] > 0 and per["hash_encode_bwd"] > 0
                    and (per["segment_accumulate_k5"] >= 1) == k5,
                    f"llff graphed {window} launches a step: {per}")

        # one test view: its time and peak memory; the path's launches end here
        sc = trainer.scene
        c2w = sc.poses[sc.i_test[0]]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.render_image(c2w)
        torch.cuda.synchronize()
        view_s = time.perf_counter() - t0
        view_peak = torch.cuda.max_memory_allocated() / 2**30
        counts = kernel_launches()

        # K2 and K6 at this path's shapes, on a pool batch's sample points
        encode = encode_check(torch, trainer, trainer.sample_pool(pool, next(rows), args.N_rand), "llff",
                              ndc=True)
        # the view gate: the whole view on the card (K2), then every
        # LLFF_CPU_ROW_STRIDE-th row and the rays at risk held stage by stage
        # against the CPU's plain path (view_gate)
        cfg = trainer.render_cfg.eval_mode()
        ro, rd = get_rays(sc.H, sc.W, torch.as_tensor(sc.K), torch.as_tensor(c2w[:3, :4]))
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        rays = (*get_ndc_rays(sc.H, sc.W, sc.focal, 1.0, ro, rd), vd)
        strided = (torch.arange(0, sc.H, LLFF_CPU_ROW_STRIDE)[:, None] * sc.W
                   + torch.arange(sc.W)).flatten()
        ok, view_gate_rec, _ = view_gate(torch, np, trainer.state, rays, trainer.bbox, cfg, sc.near,
                                         sc.far, args.chunk, strided, save_to=VIEW_FAILURE_FILE)
        n_view = len(range(0, sc.H, LLFF_CPU_ROW_STRIDE)) * sc.W
        view_gate_brief = {**view_gate_rec, "explained": {
            k: v[:16] for k, v in view_gate_rec["explained"].items()}}
        require(ok and view_gate_rec["strided_rays"] == n_view,
                f"llff: card view against the CPU's, stage by stage: {view_gate_brief}")
        del pool

        for name in ("hash_encode_fwd", "hash_encode_bwd", "segment_accumulate_k5"):
            require(counts[name] > 0, f"kernel {name} was not launched on the llff path")
        for name in OFF_PATH:
            require(counts[name] == 0, f"kernel {name} was launched on the llff path")
        per_step = lambda a, b, k: {key: (b[key] - a[key]) / k for key in a}
        phase_s = time.perf_counter() - t_phase
        rec = {
            "phase": "llff", "card": smi, "frames": LLFF_FRAMES, "hw": list(hw), "iters": n,
            "write_s": write_s, "load_s": load_s, "png_diffs": png_diffs, "train_s": train_s,
            "print_iters": [h[0] for h in trainer.history], "fern": fern,
            "test_psnr_mean": float(np.mean(fern["test_psnrs"])),
            "render_s_per_view": fern["testset_s_per_view"], "video_s": fern["video_s"],
            "render_only_s": render_only_s, "render_only_psnr_max_diff_db": psnr_diff,
            "pool_rows": pool_rows, "pool_gib": pool_gib, "pool_build_s": pool_s,
            "step_ms_tv": [t * 1e3 for t in tv_s], "step_ms_no_tv": [t * 1e3 for t in notv_s],
            "train_rays_per_s_tv": args.N_rand / statistics.median(tv_s),
            "train_rays_per_s_no_tv": args.N_rand / statistics.median(notv_s),
            "launches_per_step_tv": per_step(c0, c1, len(tv_s)),
            "launches_per_step_no_tv": per_step(c1, c2, len(notv_s)),
            "graphed": graphed,
            "train_rays_per_s_graphed_tv": graphed["tv"]["train_rays_per_s_graphed"],
            "train_rays_per_s_graphed_no_tv": graphed["no_tv"]["train_rays_per_s_graphed"],
            "encode_at_llff_shapes": encode, "view_s": view_s,
            "cpu_view_rays": view_gate_rec["rays"], "cpu_view_s": view_gate_rec["cpu_view_s"],
            "card_vs_cpu_view": view_gate_rec["card_vs_cpu"], "view_gate": view_gate_rec,
            "peak_mem_gib_run": run_peak, "peak_mem_gib_training": train_peak,
            "peak_mem_gib_view": view_peak, "launches_in_training": c_train, "launches": counts,
            "phase_s": phase_s,
        }
        emit({**rec, "view_gate": view_gate_brief})  # every explained ray in --out's record
        if prof is not None:
            emit(prof)
        shown = [("write_s", write_s), ("load_s", load_s), ("train_s", train_s),
                 ("eager rays/s TV", rec["train_rays_per_s_tv"]),
                 ("graphed rays/s TV", rec["train_rays_per_s_graphed_tv"]),
                 ("graphed rays/s no TV", rec["train_rays_per_s_graphed_no_tv"]),
                 ("test PSNR dB (sign of life)", rec["test_psnr_mean"]),
                 ("render s per 378x504 view", rec["render_s_per_view"]), ("video_s", rec["video_s"]),
                 ("view gate rays on the CPU", rec["cpu_view_rays"]), ("cpu_view_s", rec["cpu_view_s"]),
                 ("pool GiB", pool_gib), ("view peak GiB", view_peak), ("phase_s", phase_s)]
        print("llff: " + "; ".join(f"{k} {v:.6g} [{smi}]" for k, v in shown), flush=True)
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# The st3d phase (slice 9): one procedural 512 x 1024 RGB-D panorama of a
# room (st3d_set), 100 train views with occlusion masks and 10 test views
# made from it by the port's hashnerf_torch.tools.generate_equirect_data
# (the loader's fixed counts: the real size); configs/st3d.txt trained on it
# through run_nerf.main as written (the hash grid, NeRFSmall, use_gradient
# vestigial) and as OmniNeRF's model (ST3D_OMNI_FLAGS: positional NeRFGradient
# 8 x 256, Adam, depth and gradient supervision), each for ST3D_ITERS steps
# (of 200,000) in graphed pool blocks of 16, the test set at the last step
# with --st3d_eval_views 2; then eager and graphed pool windows, one
# panorama timed, and for OmniNeRF one step and every ST3D_CPU_ROW_STRIDE-th
# row of the ground-truth panorama on the card against the CPU.
ST3D_NAME = "room"
ST3D_HW = (512, 1024)
ST3D_ITERS = {"hash": 320, "omninerf": 192}
ST3D_OMNI_FLAGS = ["--i_embed", "0", "--i_embed_views", "0", "--use_depth", "--use_gradient"]
ST3D_EVAL_VIEWS = 2
ST3D_GRAPH_TV_START = 336
ST3D_CPU_ROW_STRIDE = 8  # 64 of the panorama's 512 rows
ST3D_CPU_CHUNK = 2048
# One OmniNeRF step from one state and draws on the card, on the CPU in
# float32 and on the CPU in float64: the card's error against the float64
# step, of the loss and of the MLP gradients (the largest ||g - g64|| /
# ||g64|| of a tensor), at most ST3D_F32_ERR_FACTOR x the CPU float32
# step's own, plus 1e-6. A float32 step is no closer than that: its GEMMs
# sum 358,400 points' products, and ReLUs whose inputs round across 0
# switch, so its gradients are 1e-4 to 3e-4 of their norms from the
# float64 step's on either side (OmniNeRF's trained state, H100 80GB HBM3).
ST3D_F32_ERR_FACTOR = 4
# The step's controls, each the card's step at a precision the gate exists
# to exclude: TF32 GEMMs (allow_tf32, which the port turns off to match
# JAX's HIGHEST) and bf16-rounded operands (compute_dtype bfloat16). The
# gate must stop each, every run: it shows the factor still tells these
# precisions from float32's (chip_diag.py st3d-step measured the controls'
# gradients 1.2e-2 to 0.26 of their norms from float64, 16x and more the
# CPU float32 step's own, against the card's 0.88x to 1.43x; PERF.md §6).
ST3D_CONTROLS = ("tf32", "bf16")


def st3d_set(np, root: str):
    """Write a procedural RGB-D panorama at root (<name>_rgb.png and the
    16-bit <name>_d.png, name the folder's) and make the st3d set of it with
    the port's data tool. The scene: an axis-aligned room around the
    camera, each wall its colour under a sinusoid texture, and two spheres
    coloured by their normals; depth is the distance to the first hit,
    scaled to the 16-bit range by its largest. Returns (write_s,
    generate_s)."""
    from hashnerf_torch.ops.rays import equirect_directions
    from hashnerf_torch.tools.generate_equirect_data import generate
    from hashnerf_torch.utils.png import write_png

    t0 = time.perf_counter()
    H, W = ST3D_HW
    d = equirect_directions(H, W).astype(np.float64)
    lo, hi = np.array([-1.6, -1.0, -1.9]), np.array([1.4, 1.3, 1.7])
    with np.errstate(divide="ignore"):
        tb = np.where(d > 0, hi / d, np.where(d < 0, lo / d, np.inf))
    axis, t = np.argmin(tb, -1), np.min(tb, -1)
    p = d * t[..., None]
    u = np.take_along_axis(p, ((axis + 1) % 3)[..., None], -1)[..., 0]
    v = np.take_along_axis(p, ((axis + 2) % 3)[..., None], -1)[..., 0]
    base = np.array([[0.8, 0.4, 0.3], [0.35, 0.6, 0.8], [0.5, 0.75, 0.4]])[axis]
    rgb = base * (0.55 + 0.45 * (0.5 + 0.5 * np.sin(6.0 * u) * np.cos(5.0 * v)))[..., None]
    for c, r in ((np.array([0.7, -0.4, -0.9]), 0.35), (np.array([-0.6, 0.2, 0.8]), 0.45)):
        b = np.sum(-c * d, -1)
        disc = b * b - (np.sum(c * c) - r * r)
        ts = -b - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (ts > 0) & (ts < t)
        n = (d * ts[..., None] - c) / r
        rgb = np.where(hit[..., None], 0.5 + 0.5 * n, rgb)
        t = np.where(hit, ts, t)
    os.makedirs(root)
    name = os.path.basename(root.rstrip("/"))
    write_png(os.path.join(root, name + "_rgb.png"),
              np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8))
    write_png(os.path.join(root, name + "_d.png"), np.round(t / t.max() * 65535).astype(np.uint16))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generate(root, n_train=100, n_test=10, radius=0.3, seed=0)
    return write_s, time.perf_counter() - t0


def st3d_argv(data: str, logs: str, run: str):
    """run_nerf's arguments for the st3d phase's run `run` (of ST3D_ITERS)
    on the set at data: configs/st3d.txt (with ST3D_OMNI_FLAGS for
    omninerf) for ST3D_ITERS[run] steps in graphed pool blocks of 16, the
    test set and a checkpoint at the last."""
    n = str(ST3D_ITERS[run])
    return ["--config", os.path.join(ROOT, "configs", "st3d.txt"), "--datadir", data,
            "--basedir", logs, "--device", DEV, "--no_reload", "--steps_per_dispatch", "16",
            "--st3d_eval_views", str(ST3D_EVAL_VIEWS), "--i_print", "32",
            *(ST3D_OMNI_FLAGS if run == "omninerf" else []),
            "--N_iters", n, "--i_weights", n, "--i_testset", n]


def st3d_pool(np, trainer, rays):
    """The pool as main_st3d builds it from the loader's rays (a RayBundle):
    the columns the trainer's run supervises, shuffled in place by
    np.random.default_rng(0)'s permutation."""
    args = trainer.args
    pool = trainer.build_column_pool({
        "rays_o": rays.o, "rays_d": rays.d, "target": rays.rgb,
        "target_depth": rays.depth if args.use_depth else None,
        "target_grad": rays.g if args.use_gradient else None})
    trainer.shuffle_pool(pool, np.random.default_rng(0).permutation(rays.o.shape[0]))
    return pool


def st3d_step_card_vs_cpu(torch, np, trainer, batch):
    """One loss and backward of OmniNeRF's step from the trainer's state
    on one pool batch with the same draws (drawn on the CPU from a seed),
    on the card and on CPU copies of the state in float32 and float64,
    held by ST3D_F32_ERR_FACTOR; the card's ST3D_CONTROLS, each of which
    the same gate must stop. On the card also: the render returns a finite grad_map, and the
    loss holds the depth and the gradient terms (each adds to the loss of
    the same render without it)."""
    import copy
    import dataclasses

    from hashnerf_torch.models.factory import NGPState, query_fn
    from hashnerf_torch.render.renderer import RenderDraws, render_rays
    from hashnerf_torch.train.driver import TrainDraws, make_loss_fn

    args = trainer.args
    R, S, Si = batch["rays_o"].shape[0], args.N_samples, args.N_importance
    gen = torch.Generator().manual_seed(2)
    draws = RenderDraws(t_strat=torch.rand((R, S), generator=gen),
                        noise0=torch.randn((R, S), generator=gen),
                        u_pdf=torch.rand((R, Si), generator=gen),
                        noise1=torch.randn((R, S + Si), generator=gen))
    cpu_state = NGPState(trainer.model_cfg, device="cpu")
    cpu_state.load_state_dict({k: v.cpu() for k, v in trainer.state.state_dict().items()})
    f64_state = copy.deepcopy(cpu_state).double()
    bf16_cfg = dataclasses.replace(trainer.model_cfg, compute_dtype="bfloat16")
    bf16_state = NGPState(bf16_cfg, device=DEV)
    bf16_state.load_state_dict(trainer.state.state_dict())

    def on(dev, dt):
        b = {k: v.to(dev, dt) for k, v in batch.items()}
        b["viewdirs"] = b["rays_d"] / torch.linalg.norm(b["rays_d"], dim=-1, keepdim=True)
        return b, TrainDraws(render=RenderDraws(*(None if x is None else x.to(dev, dt)
                                                  for x in draws)))

    legs = {"card": (trainer.state, DEV, torch.float32), "cpu": (cpu_state, "cpu", torch.float32),
            "cpu_f64": (f64_state, "cpu", torch.float64), "tf32": (trainer.state, DEV, torch.float32),
            "bf16": (bf16_state, DEV, torch.float32)}
    out, tf32 = {}, torch.backends.cuda.matmul.allow_tf32
    for where in ("card", "cpu", "cpu_f64") + ST3D_CONTROLS:
        state, dev, dt = legs[where]
        cfg = bf16_cfg if where == "bf16" else trainer.model_cfg
        loss_fn = make_loss_fn(args, trainer.render_cfg, trainer.bbox.to(dev, dt), cfg)
        b, d = on(dev, dt)
        for q in state.parameters():
            q.grad = None
        torch.backends.cuda.matmul.allow_tf32 = where == "tf32"
        try:
            t0 = time.perf_counter()
            loss, _ = loss_fn(state, b, 0.0, draws=d)
            loss.backward()
            out[where] = (float(loss.detach()),
                          [q.grad.detach().cpu().double() for q in state.net_parameters()],
                          time.perf_counter() - t0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    ref_loss, ref_g, _ = out["cpu_f64"]

    def errors(where):
        loss, g, _ = out[where]
        return (abs(loss - ref_loss) / abs(ref_loss),
                max(float((a - r).norm() / r.norm().clamp_min(1e-300)) for a, r in zip(g, ref_g)))

    (card_loss, card_grad), (cpu_loss, cpu_grad) = errors("card"), errors("cpu")
    F = ST3D_F32_ERR_FACTOR
    passes = lambda e: e[0] <= F * cpu_loss + 1e-6 and e[1] <= F * cpu_grad + 1e-6
    controls = {c: {"loss_err": e[0], "grad_err_over_norm": e[1], "passes_the_gate": passes(e)}
                for c in ST3D_CONTROLS for e in [errors(c)]}
    del bf16_state
    # the supervision on the card: the same render with each term alone
    b, card_draws = on(DEV, torch.float32)
    terms = {}
    with torch.no_grad():
        ret = render_rays(trainer.state, query_fn, b["rays_o"], b["rays_d"], b["viewdirs"],
                          b["near"], b["far"], trainer.bbox, trainer.render_cfg,
                          draws=card_draws.render)
        for name, flags in (("neither", ()), ("depth", ("use_depth",)), ("gradient", ("use_gradient",))):
            a = argparse.Namespace(**{**vars(args), "use_depth": "use_depth" in flags,
                                      "use_gradient": "use_gradient" in flags})
            fn = make_loss_fn(a, trainer.render_cfg, trainer.bbox, trainer.model_cfg)
            terms[name] = float(fn(trainer.state, b, 0.0, draws=card_draws)[0])
    grad_map = ret.get("grad_map")
    l_card = out["card"][0]
    rec = {"rays": R, "loss_card": l_card, "loss_cpu": out["cpu"][0], "loss_cpu_f64": ref_loss,
           "loss_err_card": card_loss, "loss_err_cpu": cpu_loss,
           "grad_err_over_norm_card": card_grad, "grad_err_over_norm_cpu": cpu_grad,
           "grad_tensors": len(ref_g), "factor": ST3D_F32_ERR_FACTOR,
           "cpu_s": out["cpu"][2], "cpu_f64_s": out["cpu_f64"][2], "loss_terms": terms,
           "grad_map_shape": None if grad_map is None else list(grad_map.shape),
           "controls": controls}
    require(passes((card_loss, card_grad)),
            f"st3d omninerf: one step on the card against the CPU's float64 step: {rec}")
    require(not any(c["passes_the_gate"] for c in controls.values()),
            f"st3d omninerf: a control passes the card's step gate: {rec}")
    require(grad_map is not None and grad_map.shape == (R, 3) and bool(torch.isfinite(grad_map).all())
            and terms["depth"] > terms["neither"] and terms["gradient"] > terms["neither"]
            and abs(terms["depth"] + terms["gradient"] - terms["neither"] - l_card) <= 1e-4 * l_card,
            f"st3d omninerf: grad_map and the depth and gradient terms: {rec}")
    return rec


def _gemm_ms(rows):
    """Device ms a step of the GEMM kernels among profile_steps' top rows."""
    return sum(r["ms_per_step"] for r in rows if "gemm" in r["name"].lower())


def phase_st3d(torch, np, smi: str, profile: bool):
    """The st3d path end to end (see ST3D_*): write and make the set, load
    it (host peak traced), then configs/st3d.txt as written and as
    OmniNeRF through run_nerf.main; after each, the pool again from the
    loader's rays (rows equal to the loader's), eager and graphed pool
    windows and one panorama timed; for the hash grid, after its launches
    are read, K2 and K6 on its own points (encode_check); for OmniNeRF one
    step and rows of the ground-truth panorama card against CPU. Each run
    launches the kernels PATHS["st3d"] names for it and no other."""
    import itertools
    import resource
    import tracemalloc

    from hashnerf_torch import kernels
    from hashnerf_torch.data.st3d import load_st3d_data
    from hashnerf_torch.models.factory import NGPState
    from hashnerf_torch.models.nerf import NeRFGradient
    from hashnerf_torch.run_nerf import eval_test_omninerf, main as run_nerf

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_st3d_")
    try:
        data, logs = os.path.join(workdir, "pano", ST3D_NAME), os.path.join(workdir, "logs")
        write_s, gen_s = st3d_set(np, data)
        tracemalloc.start()
        t0 = time.perf_counter()
        rays, rays_test, H, W = load_st3d_data(data)
        load_s = time.perf_counter() - t0
        load_peak_gib = tracemalloc.get_traced_memory()[1] / 2**30
        tracemalloc.stop()
        n_rays = rays.o.shape[0]
        bundle_gib = sum(a.nbytes for a in (rays.o, rays.d, rays.rgb, rays.depth, rays.g)) / 2**30
        require((H, W) == ST3D_HW and rays_test.rgb.shape[0] == 11 * H * W
                and 0.5 * 100 * H * W < n_rays <= 100 * H * W,
                f"st3d: {n_rays} train rays, {rays_test.rgb.shape[0]} test rays, {(H, W)}")
        gt = rays_test.rgb[-H * W:].reshape(H, W, 3)

        runs = {}
        for name in ST3D_ITERS:
            n = ST3D_ITERS[name]
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer, stamps = _run(run_nerf, st3d_argv(data, logs, name))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            run_peak = torch.cuda.max_memory_allocated() / 2**30
            args = trainer.args
            hashed = trainer.state.hash_table is not None
            require(trainer.global_step == n and hashed == (name == "hash")
                    and isinstance(trainer.state.coarse, NeRFGradient) == (not hashed),
                    f"st3d {name}: step {trainer.global_step}, model {trainer.state.coarse}")
            losses = [h[1] for h in trainer.history]
            require(len(losses) == n // 32 and all(np.isfinite(losses))
                    and np.mean(losses[-3:]) < np.mean(losses[:3]), f"st3d {name}: losses {losses}")
            expdir = os.path.join(logs, args.expname)
            testdir = os.path.join(expdir, "testset_{:06d}".format(n))
            require(os.path.exists(os.path.join(expdir, "{:06d}.ckpt".format(n))),
                    f"st3d {name}: no checkpoint")
            with open(os.path.join(testdir, "statistics.txt")) as f:
                stats = f.read()
            psnr = float(stats.split("psnr:")[1])
            frames, shape = gif_frames(os.path.join(testdir, "video2.gif"))
            require(np.isfinite(psnr) and frames == 2 * (ST3D_EVAL_VIEWS - 1) and shape == (H, W),
                    f"st3d {name}: statistics {stats!r}, video2.gif {frames} frames of {shape}")

            # the pool as main_st3d builds it, from the loader's rays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool = st3d_pool(np, trainer, rays)
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t0
            want_cols = 9 + 3 * args.use_gradient + args.use_depth
            require(pool.shape == (n_rays, want_cols), f"st3d {name}: pool {tuple(pool.shape)}")
            pool_gib = pool.numel() * pool.element_size() / 2**30
            rows = itertools.count(0, args.N_rand)
            batches = lambda: trainer.sample_pool(pool, next(rows), args.N_rand)
            torch.cuda.reset_peak_memory_stats()
            c0 = kernel_launches()
            eager_s, eager_losses = timed_steps(torch, trainer, 10, batches=batches)
            c1 = kernel_launches()
            train_peak = torch.cuda.max_memory_allocated() / 2**30
            require(all(np.isfinite(eager_losses)), f"st3d {name}: non-finite eager loss")
            prof = None
            if profile:
                prof = {"path": f"st3d_{name}", **profile_steps(
                    torch, trainer, 3, statistics.median(eager_s), batches=batches)}
                gemm = _gemm_ms(prof["top"])
                prof["gemm_ms_per_step_top25"] = gemm
                prof["gemm_share_of_busy"] = gemm / prof["device_busy_ms_per_step"]
            at = next(rows)
            windows = {"tv": ST3D_GRAPH_TV_START, "no_tv": GRAPH_NO_TV_START} if hashed else {
                "no_tv": trainer.global_step}
            graphed = {w: graphed_window(torch, trainer, "st3d", start, w, profile, pool=pool,
                                         offset=at) for w, start in windows.items()}
            for w, rec in graphed.items():
                per = rec["launches_per_step"]
                if hashed:
                    ok = (per["hash_encode_fwd"] > 0 and per["hash_encode_bwd"] > 0
                          and (per["segment_accumulate_k5"] >= 1) == (w == "tv"))
                else:
                    ok = not any(per.values())
                require(ok, f"st3d {name} graphed {w} launches a step: {per}")

            # one panorama, timed: the ground-truth view alone, so no GIF
            args.st3d_eval_views = 1
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rgbs, _, view_psnr = eval_test_omninerf(trainer, rays_test, H, W,
                                                    os.path.join(expdir, "one_view"))
            torch.cuda.synchronize()
            view_s = time.perf_counter() - t0
            view_peak = torch.cuda.max_memory_allocated() / 2**30
            require(rgbs.shape == (1, H, W, 3) and np.isfinite(view_psnr)
                    and not os.path.exists(os.path.join(expdir, "one_view", "video2.gif")),
                    f"st3d {name}: one view {rgbs.shape}, PSNR {view_psnr}")
            counts = kernel_launches()
            want = PATHS["st3d"]["runs"][name]
            bad = {k: v for k, v in counts.items() if (v > 0) != (k in want)}
            require(not bad, f"st3d {name}: launches {counts}, must launch exactly {want}")
            # K2 and K6 at run A's shapes, on a pool batch's sample points
            encode = encode_check(torch, trainer, trainer.sample_pool(pool, next(rows), args.N_rand),
                                  "st3d") if hashed else None

            rec = {"run": name, "iters": n, "run_s": run_s, "losses": losses,
                   "test_psnr_gt_view": psnr, "pool_rows": n_rays, "pool_columns": want_cols,
                   "pool_gib": pool_gib, "pool_build_s": pool_s,
                   "step_ms_eager": [t * 1e3 for t in eager_s],
                   "train_rays_per_s_eager": args.N_rand / statistics.median(eager_s),
                   "launches_per_step_eager": {k: (c1[k] - c0[k]) / len(eager_s) for k in c0},
                   "graphed": graphed,
                   "train_rays_per_s_graphed": {w: g["train_rays_per_s_graphed"]
                                                for w, g in graphed.items()},
                   "panorama_s": view_s, "panorama_psnr": view_psnr,
                   "peak_mem_gib_run": run_peak, "peak_mem_gib_training": train_peak,
                   "peak_mem_gib_panorama": view_peak, "launches": counts}
            if hashed:
                rec["encode"] = encode
            else:
                rec["card_vs_cpu_step"] = st3d_step_card_vs_cpu(
                    torch, np, trainer, trainer.sample_pool(pool, next(rows), args.N_rand))
                # every ST3D_CPU_ROW_STRIDE-th row of the ground-truth panorama
                cfg = trainer.render_cfg.eval_mode()
                o = torch.from_numpy(rays_test.o[-H * W:].reshape(H, W, 3)[::ST3D_CPU_ROW_STRIDE])
                d = torch.from_numpy(rays_test.d[-H * W:].reshape(H, W, 3)[::ST3D_CPU_ROW_STRIDE])
                o, d = o.reshape(-1, 3), d.reshape(-1, 3)
                ray_set = (o, d, d / torch.linalg.norm(d, dim=-1, keepdim=True))
                rgb_card = render_on_rays(torch, trainer.state, ray_set, trainer.bbox, cfg,
                                          trainer.near, trainer.far, args.chunk)
                cpu_state = NGPState(trainer.model_cfg, device="cpu")
                cpu_state.load_state_dict({k: v.cpu() for k, v in trainer.state.state_dict().items()})
                t0 = time.perf_counter()
                rgb_cpu = render_on_rays(torch, cpu_state, ray_set, trainer.bbox.cpu(), cfg,
                                         trainer.near, trainer.far, ST3D_CPU_CHUNK)
                cpu_rows_s = time.perf_counter() - t0
                ok, err = jax_view_close(rgb_card.numpy(), rgb_cpu.numpy())
                # the same rows of the card's whole panorama (render() in chunks)
                whole = rgbs[0][::ST3D_CPU_ROW_STRIDE].reshape(-1, 3)
                ok_whole, err_whole = jax_view_close(whole, rgb_cpu.numpy())
                require(ok and ok_whole and rgb_card.shape == (o.shape[0], 3),
                        f"st3d omninerf: rows card against CPU {err}, the panorama's {err_whole}")
                rec.update({"cpu_rows": o.shape[0], "cpu_rows_s": cpu_rows_s,
                            "card_vs_cpu_rows": err, "panorama_vs_cpu_rows": err_whole})
                del cpu_state
            emit({"phase": "st3d", "card": smi, **rec})
            if prof is not None:
                rec["profile"] = prof
                emit(prof)
            runs[name] = rec
            del trainer, pool
            torch.cuda.empty_cache()

        phase_s = time.perf_counter() - t_phase
        out = {"phase": "st3d", "card": smi, "hw": [H, W], "write_s": write_s, "generate_s": gen_s,
               "load_s": load_s, "train_rays": n_rays, "bundle_gib": bundle_gib,
               "load_host_peak_gib_traced": load_peak_gib,
               "host_peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               "runs": runs, "phase_s": phase_s,
               "launches": {k: sum(r["launches"][k] for r in runs.values()) for k in REPLACES}}
        shown = [("write_s", write_s), ("generate_s", gen_s), ("load_s", load_s),
                 ("pool rows", n_rays), ("pool GiB hash", runs["hash"]["pool_gib"]),
                 ("pool GiB omninerf", runs["omninerf"]["pool_gib"]),
                 ("load host peak GiB", load_peak_gib), ("host peak RSS GiB", out["host_peak_rss_gib"])]
        for name, r in runs.items():
            shown += [(f"{name} eager rays/s", r["train_rays_per_s_eager"])]
            shown += [(f"{name} graphed rays/s {w}", v) for w, v in r["train_rays_per_s_graphed"].items()]
            shown += [(f"{name} panorama s", r["panorama_s"]), (f"{name} peak GiB run", r["peak_mem_gib_run"])]
            if "profile" in r:
                shown += [(f"{name} busy ms/step", r["profile"]["device_busy_ms_per_step"]),
                          (f"{name} GEMM share", r["profile"]["gemm_share_of_busy"])]
        shown.append(("phase_s", phase_s))
        print("st3d: " + "; ".join(f"{k} {v:.6g} [{smi}]" for k, v in shown), flush=True)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# The loaders phase (slice 9): every new loader on the card, cut short, on
# sets of the real frame sizes traced from the procedural "multi" scene
# (cameras on the r = 4 ring, as make_synthetic_scene's), through
# run_nerf.main: LOADER_ITERS eager steps, a checkpoint and the test set's
# one view at the last. The cuts, each: frames (LOADER_FRAMES), steps (of
# 50,000), the procedural scene for the real one; scannet keeps its
# trainskip of 10 (only the frames it keeps are written).
LOADER_ITERS = 64
LOADER_FRAMES = {"train": 20, "val": 1, "test": 1}  # scannet's train list; 2 kept
LOADER_RUN = ["--N_iters", str(LOADER_ITERS), "--i_print", "8", "--i_weights", str(LOADER_ITERS),
              "--i_testset", str(LOADER_ITERS), "--i_video", "0", "--no_reload"]
LOADERS = {
    # configs/scannet_scene0000.txt as written (hash grid, ray pool, lrate
    # 0.01, 64 + 128 samples) on ScanNet's 1296 x 968 frames and a binary
    # PLY of the scene's surface
    "scannet": {"hw": (968, 1296), "flags": ["--config", os.path.join(
        "configs", "scannet_scene0000.txt")]},
    # positional NeRF 8 x 256 (OmniNeRF's encoders without the gradient
    # head), Adam, at DeepVoxels' 512 x 512; 4 train, 1 test, 1 validation
    "deepvoxels": {"hw": (512, 512), "flags": [
        "--dataset_type", "deepvoxels", "--shape", "greek", "--i_embed", "0", "--i_embed_views",
        "0", "--use_viewdirs", "--N_samples", "64", "--N_importance", "128", "--N_rand", "1024",
        "--testskip", "1"]},
    # the hash-grid defaults with LINEMOD's K (its 640 x 480 camera) and the
    # +-10 fallback box; 2 train, 1 val, 1 test
    "LINEMOD": {"hw": (480, 640), "flags": [
        "--dataset_type", "LINEMOD", "--use_viewdirs", "--N_samples", "64", "--N_importance",
        "128", "--N_rand", "1024", "--testskip", "1"]},
}
LINEMOD_K = [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]]


def _ring_poses(np, n: int):
    from hashnerf_torch.data.pose_paths import pose_spherical

    return [pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, n + 1)[:-1]]


def _trace_frame(np, hw, K, pose):
    from hashnerf_torch.data.synthetic import _render_view

    img = _render_view(hw[0], hw[1], np.asarray(K), np.asarray(pose)[:3, :4], "multi", 1)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def loader_set(np, kind: str, root: str):
    """Write a set of `kind`'s layout at root and return its (H, W) and the
    number of frames written."""
    import json

    from hashnerf_torch.utils.png import write_png

    H, W = LOADERS[kind]["hw"]
    if kind == "scannet":
        sceneID = "scene0000_00"
        nerfdir = os.path.join(root, "nerfstyle_" + sceneID)
        os.makedirs(os.path.join(nerfdir, "frames"))
        angle_x = 2 * math.atan(W / 2 / 1170.0)  # ScanNet's color camera, fx about 1170
        focal = 0.5 * W / math.tan(0.5 * angle_x)
        K = [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]]
        poses, written = _ring_poses(np, sum(LOADER_FRAMES.values())), 0
        at = 0
        for split, n in LOADER_FRAMES.items():
            frames = []
            for i in range(n):
                pose = poses[at + i]
                fname = f"frames/{split}_{i}"
                if split != "train" or i % 10 == 0:  # trainskip 10 reads no other
                    write_png(os.path.join(nerfdir, fname + ".png"), _trace_frame(np, (H, W), K, pose))
                    written += 1
                cv = np.array(pose)
                cv[:3, 1:3] *= -1  # the loader flips OpenCV's y and z back
                frames.append({"file_path": fname, "transform_matrix": cv.tolist()})
            at += n
            with open(os.path.join(nerfdir, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": angle_x, "frames": frames}, f)
        # vh_clean's layout: float x, y, z and uchar colours, then the faces
        scandir = os.path.join(root, "scans", sceneID)
        os.makedirs(scandir)
        from hashnerf_torch.data.synthetic import _MULTI_SPHERES

        rng = np.random.default_rng(0)
        verts = []
        for c, r in _MULTI_SPHERES:
            v = rng.normal(size=(50000, 3))
            verts.append(c + r * v / np.linalg.norm(v, axis=-1, keepdims=True))
        verts = np.concatenate(verts)
        dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
                       ("blue", "u1"), ("alpha", "u1")])
        arr = np.zeros(len(verts), dt)
        for i, c in enumerate("xyz"):
            arr[c] = verts[:, i]
        header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
                  + "".join(f"property float {c}\n" for c in "xyz")
                  + "".join(f"property uchar {c}\n" for c in ("red", "green", "blue", "alpha"))
                  + "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
        with open(os.path.join(scandir, f"{sceneID}_vh_clean.ply"), "wb") as f:
            f.write(header.encode() + arr.tobytes())
        return (H, W), written
    if kind == "deepvoxels":
        focal = 1.2 * W
        poses, at = _ring_poses(np, 6), 0
        transf = np.diag([1.0, -1.0, -1.0, 1.0])  # the loader's flip, its own inverse
        K = [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]]
        for split, n in (("train", 4), ("test", 1), ("validation", 1)):
            base = os.path.join(root, split, "greek")
            os.makedirs(os.path.join(base, "pose"))
            os.makedirs(os.path.join(base, "rgb"))
            for i in range(n):
                pose = np.asarray(poses[at + i])
                with open(os.path.join(base, "pose", f"{i:03d}.txt"), "w") as f:
                    f.write(" ".join(str(v) for v in (pose @ transf).ravel()))
                write_png(os.path.join(base, "rgb", f"{i:03d}.png"), _trace_frame(np, (H, W), K, pose))
            at += n
            if split == "train":
                with open(os.path.join(base, "intrinsics.txt"), "w") as f:
                    f.write(f"{focal} {W / 2} {H / 2}\n0 0 0\n1.0\n1.0\n{H} {W}\n0\n")
        return (H, W), 6
    # LINEMOD
    poses, at = _ring_poses(np, 4), 0
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i in range(n):
            fp = os.path.join(root, split, f"{i}.png")
            write_png(fp, _trace_frame(np, (H, W), LINEMOD_K, poses[at + i]))
            frames.append({"file_path": fp, "transform_matrix": np.asarray(poses[at + i]).tolist(),
                           "intrinsic_matrix": LINEMOD_K})
        at += n
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": 2.3, "far": 5.7}, f)
    return (H, W), 4


CHAIR_F32_ITERS = 16


def chair_float32_run(torch, np, logs: str):
    """The chair at --compute_dtype float32 (ROADMAP A7.4: the float32
    product, TF32 off) on the procedural scene through run_nerf.main:
    CHAIR_F32_ITERS eager steps with TV; finite losses that fall, the
    kernels PATHS["loaders"]["runs"]["chair_float32"] names and no other."""
    from hashnerf_torch import kernels
    from hashnerf_torch.run_nerf import main as run_nerf

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = run_nerf(["--config", os.path.join(ROOT, "configs", "chair.txt"), "--dataset_type",
                        "synthetic", "--compute_dtype", "float32", "--device", DEV,
                        "--basedir", logs, "--N_iters", str(CHAIR_F32_ITERS), "--i_print", "4",
                        "--i_weights", str(CHAIR_F32_ITERS), "--i_testset", "0", "--i_video", "0"])
    torch.cuda.synchronize()
    counts = kernel_launches()
    losses = [h[1] for h in trainer.history]
    want = PATHS["loaders"]["runs"]["chair_float32"]
    bad = {k: v for k, v in counts.items() if (v > 0) != (k in want)}
    require(trainer.model_cfg.compute_dtype == "float32" and trainer.state.coarse._dtype is None
            and all(np.isfinite(losses)) and losses[-1] < losses[0] and not bad,
            f"chair at --compute_dtype float32: losses {losses}, launches {counts}")
    rec = {"run_s": time.perf_counter() - t0, "losses": losses, "launches": counts}
    emit({"phase": "loaders", "loader": "chair_float32", **rec})
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_loaders(torch, np, smi: str):
    """Each new loader (LOADERS) on the card: write its set, train through
    run_nerf.main for LOADER_ITERS steps with the test set's view at the
    last; the loss finite and falling, a checkpoint, the view's figure and
    PSNR; each run launches the kernels PATHS["loaders"] names for it and
    no other."""
    from hashnerf_torch import kernels
    from hashnerf_torch.run_nerf import main as run_nerf
    from hashnerf_torch.utils.png import read_png

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_loaders_")
    runs = {}
    try:
        for kind, spec in LOADERS.items():
            data, logs = os.path.join(workdir, kind), os.path.join(workdir, "logs_" + kind)
            t0 = time.perf_counter()
            hw, n_frames = loader_set(np, kind, data)
            write_s = time.perf_counter() - t0
            flags = [os.path.join(ROOT, f) if f.startswith("configs") else f for f in spec["flags"]]
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer, stamps = _run(run_nerf, flags + ["--datadir", data, "--basedir", logs,
                                                      "--device", DEV] + LOADER_RUN)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = kernel_launches()
            sc, args = trainer.scene, trainer.args
            losses = [h[1] for h in trainer.history]
            require(trainer.global_step == LOADER_ITERS and (sc.H, sc.W) == hw
                    and all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]),
                    f"{kind}: step {trainer.global_step}, {(sc.H, sc.W)}, losses {losses}")
            expdir = os.path.join(logs, args.expname)
            testdir = os.path.join(expdir, "testset_{:06d}".format(LOADER_ITERS))
            require(os.path.exists(os.path.join(expdir, "{:06d}.ckpt".format(LOADER_ITERS)))
                    and len(sc.i_test) == 1
                    and read_png(os.path.join(testdir, "000.png")).shape == (hw[0], 2 * hw[1], 3),
                    f"{kind}: no checkpoint or test figure")
            psnrs = _psnr_pickle(testdir)
            want = PATHS["loaders"]["runs"][kind]
            bad = {k: v for k, v in counts.items() if (v > 0) != (k in want)}
            require(not bad and np.isfinite(psnrs[0]),
                    f"{kind}: launches {counts}, must launch exactly {want}; PSNR {psnrs}")
            t_first = stamps.at("[TRAIN] Iter: 8 ")
            view_s = stamps.at("Saved test set") - stamps.at("Saved checkpoints")  # its one view
            train_rays_s = (LOADER_ITERS - 8) * args.N_rand / (stamps.at("Saved checkpoints") - t_first)
            bbox = trainer.bbox.tolist()
            runs[kind] = {"hw": list(hw), "frames_written": n_frames, "train_views": len(sc.i_train),
                          "write_s": write_s, "run_s": run_s, "losses": losses,
                          "train_rays_per_s_eager": train_rays_s, "view_s": view_s,
                          "test_psnr": psnrs[0], "bbox": bbox, "near_far": [sc.near, sc.far],
                          "model": type(trainer.state.coarse).__name__,
                          "optimizer": type(trainer.optimizer).__name__,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": counts}
            emit({"phase": "loaders", "loader": kind, "card": smi, **runs[kind]})
            del trainer
            torch.cuda.empty_cache()
        runs["chair_float32"] = chair_float32_run(torch, np, os.path.join(workdir, "f32"))
        phase_s = time.perf_counter() - t_phase
        shown = []
        for kind, r in runs.items():
            if kind == "chair_float32":
                continue
            shown += [(f"{kind} rays/s", r["train_rays_per_s_eager"]), (f"{kind} view s", r["view_s"])]
        shown.append(("phase_s", phase_s))
        print("loaders: " + "; ".join(f"{k} {v:.6g} [{smi}]" for k, v in shown), flush=True)
        return {"phase": "loaders", "card": smi, "runs": runs, "phase_s": phase_s,
                "launches": {k: sum(r["launches"][k] for r in runs.values()) for k in REPLACES}}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# --------------------------------------------------------------------------- #
# Phase: tools (slice 12, the A9 tools)
# --------------------------------------------------------------------------- #

TOOLS_ITERS, TOOLS_CKPT_EVERY = 96, 32  # the chair's run: 3 checkpoints
# render_bench's set: the blender phase's frames, with 17 test frames, of
# which JAX's testskip 8 loads 3 (the blender phase's set has 4)
TOOLS_BENCH_SET = ["--hw", "800", "--n_train", "16", "--n_val", "1", "--n_test", "17", "--ss", "1"]
TOOLS_RENDER_BENCH = ["--iters", "256", "--frames", "3", "--eval-keeps", "0.5"]
TOOLS_QB_ITERS = 256  # bench_quality: two blocks of 128, two curve points
TOOLS_PARITY_SEEDS = (0, 1, 2)
# SCALING_r05.json's payload bytes: JAX's steps compiled on XLA:CPU, at the
# shapes the port's runs match (compile-time counts, not times). XLA
# all-reduces the coarse and the fine pass's partial gradients apart, with
# 4 float32 metrics in the tuple, and carries ZeRO-1's bf16 wire in float32:
# the record is 2 x the port's payload, plus those metrics
# (tests/test_torch_collectives.py shows both on the HLO; ROADMAP §C).
SCALING_DP_ALL_REDUCE = 134_292_496  # data parallel at _chair_args, any W
SCALING_DP_METRICS = 16
SCALING_ZERO_W2 = {"all-gather": 117_685_632, "reduce-scatter": 58_842_816}  # flagship, W = 2
SCALING_ZERO_METRICS = 12
# graft_entry: its table as drawn absorbs about 2e-6 on a ray, so there the
# check is that the outputs are finite. The comparison takes rays from the
# entry's origin aimed at points drawn in [-1, 1]^3 and a table whose
# levels hold a constant feature vector c * v times 1 + TOOLS_ENTRY_NOISE *
# U(-1, 1) an entry (v: the first of TOOLS_ENTRY_SEEDS draws that lights
# TOOLS_ENTRY_MIN_LIT rays on the CPU), and holds rgb, depth and acc on the
# rays that absorb TOOLS_ENTRY_LIT_ACC or more, relatively. The drawn table
# scaled until rays absorb is ill conditioned (x 1e6: a 1e-7 relative change
# of the rays moves rgb by 7.6e-4 on the CPU, and the card differed from
# the CPU by 4.5e-3); this one moves rgb by 1.3e-6 at most
# (tests/test_torch_tools.py::lit_table, the same table against JAX's).
TOOLS_ENTRY_FEATURE_SCALE, TOOLS_ENTRY_NOISE, TOOLS_ENTRY_SEEDS = 10.0, 0.3, 64
TOOLS_ENTRY_LIT_ACC, TOOLS_ENTRY_MIN_LIT = 0.5, 192
TOOLS_ENTRY_RTOL = 1e-4  # the fine render tolerance


def _tools_collectives():
    """collective_volumes on one NCCL rank and on MULTI_GLOO_WORLD gloo
    ranks sharing the card, and project_two_host (two gloo ranks; the
    flagship's graphed step measured in the call), held to SCALING_r05.json
    where the shapes match."""
    from hashnerf_torch.tools.bench_scaling import collective_volumes, project_two_host

    out, secs = {}, {}
    for name, world in (("nccl", 1), ("gloo", MULTI_GLOO_WORLD)):
        t0 = time.perf_counter()
        out[name] = collective_volumes(world, DEV)
        secs[name] = time.perf_counter() - t0
    for name, v in out.items():
        dp = v["data_parallel"]
        grads = dp["collectives_per_step"]["all-reduce"]["bytes"] - dp["all_reduce_metrics_bytes"]
        require(2 * grads + SCALING_DP_METRICS == SCALING_DP_ALL_REDUCE,
                f"tools {name}: data-parallel gradient all-reduce {grads} bytes; the record's "
                f"{SCALING_DP_ALL_REDUCE} is 2 x {(SCALING_DP_ALL_REDUCE - 16) // 2} + 16")
        z = v["data_parallel_zero"]["collectives_per_step"]
        require(z["all-reduce"]["bytes"] == SCALING_ZERO_METRICS,
                f"tools {name}: ZeRO-1 metrics all-reduce {z['all-reduce']}")
    t0 = time.perf_counter()
    proj = project_two_host(device=DEV)
    secs["project_two_host"] = time.perf_counter() - t0
    zc = proj["zero1_collectives_2dev"]
    for kind, want in SCALING_ZERO_W2.items():
        require(2 * zc[kind]["bytes"] == want,
                f"tools: ZeRO-1 {kind} at W = 2 {zc[kind]['bytes']} bytes (bf16); the record's "
                f"{want} is its float32")
    require(zc["all-reduce"]["bytes"] == SCALING_ZERO_METRICS,
            f"tools: two-host ZeRO-1 metrics all-reduce {zc['all-reduce']}")
    require(all(math.isfinite(r["eff_no_overlap"]) for r in proj["projection"]),
            "tools: projection not finite")
    return {"volumes": out, "projected_2host": proj, "seconds": secs}


def _tools_entry(torch, np):
    """graft_entry.entry() on the card: finite outputs of its own rays and
    table; then, on the CPU's MLPs, a lit table (TOOLS_ENTRY_*) and rays
    aimed at the box, rgb, depth and acc against the CPU's plain route,
    within TOOLS_ENTRY_RTOL of the CPU's value on every ray that absorbs
    TOOLS_ENTRY_LIT_ACC or more (TOOLS_ENTRY_MIN_LIT of them at least)."""
    from hashnerf_torch.graft_entry import N_RAYS, entry

    fwd, (state, rays_o, rays_d) = entry(DEV)
    cfwd, (cstate, _, _) = entry("cpu")
    with torch.no_grad():
        drawn = [t.cpu().numpy() for t in fwd(state, rays_o, rays_d)]
        require(all(np.isfinite(g).all() for g in drawn)
                and [g.shape for g in drawn] == [(N_RAYS, 3), (N_RAYS,), (N_RAYS,)],
                f"tools: entry outputs {[g.shape for g in drawn]}, not finite or of wrong shape")
        cpu_o = rays_o.cpu()
        aim = torch.rand((N_RAYS, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1 - cpu_o
        aim = aim / torch.linalg.norm(aim, dim=-1, keepdim=True)
        L, T, F = cstate.hash_table.shape
        noise = torch.rand((L, T, F), generator=torch.Generator().manual_seed(3)) * 2 - 1
        for seed in range(TOOLS_ENTRY_SEEDS):
            v = torch.rand((L, 1, F), generator=torch.Generator().manual_seed(100 + seed)) * 2 - 1
            cstate.hash_table.copy_(TOOLS_ENTRY_FEATURE_SCALE * v * (1 + TOOLS_ENTRY_NOISE * noise))
            want = [t.numpy() for t in cfwd(cstate, cpu_o, aim)]
            if int((want[2] >= TOOLS_ENTRY_LIT_ACC).sum()) >= TOOLS_ENTRY_MIN_LIT:
                break
        else:
            raise CheckFailed(f"tools: no table of {TOOLS_ENTRY_SEEDS} lights "
                              f"{TOOLS_ENTRY_MIN_LIT} rays")
        state.load_state_dict({k: v.to(DEV) for k, v in cstate.state_dict().items()})
        got = [t.cpu().numpy() for t in fwd(state, rays_o, aim.to(DEV))]
    require(all(np.isfinite(g).all() for g in got), "tools: entry outputs not finite (aimed)")
    lit = want[2] >= TOOLS_ENTRY_LIT_ACC
    errs = {}
    for name, g, w in zip(("rgb", "depth", "acc"), got, want):
        rel = np.abs(g[lit] - w[lit]) / np.abs(w[lit])
        errs[name] = {"max_abs_err": float(np.abs(g[lit] - w[lit]).max()),
                      "max_rel_err": float(rel.max())}
        require(bool(np.all(rel <= TOOLS_ENTRY_RTOL)),
                f"tools: entry {name} card vs CPU on lit rays: {errs[name]}")
    return {"drawn_acc_mean": float(drawn[2].mean()), "table_seed": 100 + seed,
            "lit_rays": int(lit.sum()), "acc_mean": float(want[2].mean()),
            "min_lit_value": {n: float(np.abs(w[lit]).min())
                              for n, w in zip(("rgb", "depth", "acc"), want)},
            "errors_on_lit_rays": errs}


def _tools_encode(torch, prof):
    """K2 and K6 at profile_step's default encode shape (its encode_points
    uniform in [-1.2, 1.2]^3, a (8, 2^19, 4) table drawn from U(-1, 1),
    its bbox), held against their plain versions (encode_at)."""
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    L, T, F = prof["table"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    table = torch.rand((L, T, F), generator=gen, device=DEV) * 2 - 1
    xs = torch.rand((prof["encode_points"], 3), generator=gen, device=DEV) * 2.4 - 1.2
    bbox = torch.tensor(prof["bbox"], dtype=torch.float32, device=DEV)
    res = HashGridConfig(n_levels=L, n_features_per_level=F, log2_hashmap_size=T.bit_length() - 1,
                         finest_resolution=512).resolutions_tensor(DEV)
    return encode_at(torch, "profile_step_default", table, xs, bbox[0].contiguous(),
                     bbox[1].contiguous(), res, gen)


def phase_tools(torch, np, smi: str, data: str):
    """The A9 tools on the card (phase_tools, slice 12), on the blender
    phase's 800 x 800 set (`data`): the chair for TOOLS_ITERS steps with a
    checkpoint every TOOLS_CKPT_EVERY, each checkpoint rendered by
    run_all_checkpoints (--render_test --render_factor 4) and make_gif's
    GIF of them (3 frames, in iteration order); render_bench on a set of
    TOOLS_BENCH_SET written here; profile_step
    in both modes; bench_quality (QB_ITERS TOOLS_QB_ITERS) and
    quality_summary over it; parity_curve's dataset / ours (3 seeds) /
    merge against the recorded reference curves, whose gate must pass;
    collective_volumes and project_two_host (_tools_collectives); and
    graft_entry.entry() (_tools_entry). The launch counts are set to 0
    before it and read after: PATHS["tools"]'s kernels must launch, K1, K3
    and K4 not. The three host plots (plot_losses, pose_visualizer,
    blender_render_poses) need matplotlib and are not run here."""
    from hashnerf_torch import bench_quality, kernels
    from hashnerf_torch.run_nerf import main as run_nerf
    from hashnerf_torch.tools import (
        make_gif, parity_curve, profile_step, quality_summary, render_bench,
        run_all_checkpoints,
    )
    from hashnerf_torch.tools.make_blender_dataset import main as make_set

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="hashnerf_torch_tools_")
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    try:
        kernels.reset_launch_counts()
        # checkpoints, their re-renders and the GIF
        base = ["--config", os.path.join(ROOT, "configs", "chair.txt"), "--datadir", data,
                "--basedir", os.path.join(work, "logs"), "--device", DEV]
        trainer, _ = timed("chair_train", lambda: _run(run_nerf, base + [
            "--N_iters", str(TOOLS_ITERS), "--i_weights", str(TOOLS_CKPT_EVERY),
            "--i_print", str(TOOLS_CKPT_EVERY), "--i_testset", "0", "--i_video", "0",
            "--no_reload"]))
        expdir = os.path.join(work, "logs", trainer.args.expname)
        del trainer
        rendered = timed("run_all_checkpoints", lambda: run_all_checkpoints.main(
            base + ["--render_test", "--render_factor", "4"]))
        iters = [it for it, _ in make_gif.collect_frames(expdir)]
        gif = timed("make_gif", lambda: make_gif.make_gif(expdir, os.path.join(work, "conv.gif")))
        n_gif, gif_hw = gif_frames(gif)
        want_iters = list(range(TOOLS_CKPT_EVERY, TOOLS_ITERS + 1, TOOLS_CKPT_EVERY))
        require(len(rendered) == 3 and iters == want_iters and n_gif == 3 and gif_hw == (100, 200),
                f"tools: {len(rendered)} checkpoints rendered, frames of {iters}, GIF of {n_gif} "
                f"frames {gif_hw}")

        # render_bench at 800 x 800
        bench_set = os.path.join(work, "bench_set")
        timed("bench_set_write", lambda: make_set([bench_set, *TOOLS_BENCH_SET]))
        rb = timed("render_bench", lambda: render_bench.main(
            ["--datadir", bench_set, "--json-out", os.path.join(work, "render.json"),
             "--device", DEV] + TOOLS_RENDER_BENCH))
        require((rb["H"], rb["W"]) == (800, 800) and len(rb["frame_s"]) == 3
                and rb["seconds_per_frame"] is not None and len(rb["eval_keep_sweep"]) == 1,
                f"tools: render_bench {rb['H']}x{rb['W']}, {len(rb['frame_s'])} frames, "
                f"s/frame {rb['seconds_per_frame']}")
        shutil.rmtree(bench_set)
        torch.cuda.empty_cache()

        # profile_step, both modes
        prof = {}
        for mode, flags in (("default", []), ("parity", ["--parity"])):
            prof[mode] = timed(f"profile_{mode}", lambda: profile_step.main(
                ["--json-out", os.path.join(work, f"profile_{mode}.json"), "--device", DEV]
                + flags))
            require(all(math.isfinite(v) and v > 0 for v in prof[mode]["readings_ms"].values()),
                    f"tools: profile_step {mode} {prof[mode]['readings_ms']}")
        torch.cuda.empty_cache()
        encode = _tools_encode(torch, prof["default"])

        # bench_quality and its summary
        qb_out = os.path.join(work, "quality_tools.json")
        qb = timed("bench_quality", lambda: bench_quality.main(
            ["--json-out", qb_out, "--device", DEV], env={"QB_ITERS": str(TOOLS_QB_ITERS)}))
        require(len(qb["curve"]) == 2 and all(math.isfinite(p["test_psnr"]) for p in qb["curve"]),
                f"tools: bench_quality curve {qb['curve']}")

        # parity_curve: dataset, ours for each seed, merge against the
        # recorded reference curves
        pdata = os.path.join(work, "parity_tiny")
        timed("parity_dataset", lambda: parity_curve.main(["dataset", pdata]))
        ours, curves = [], {}
        for seed in TOOLS_PARITY_SEEDS:
            ours.append(os.path.join(work, f"parity_ours_s{seed}.json"))
            curves[seed] = timed(f"parity_ours_s{seed}", lambda: parity_curve.run_ours(
                pdata, ours[-1], seed=seed, device=DEV, n_iters=640))
        refs = [os.path.join(ROOT, f"PARITY_CURVE_ref{s}.json") for s in ("", "_s1", "_s2")]
        merged_path = os.path.join(work, "parity_merged.json")
        merged = parity_curve.merge(merged_path, refs, ours)
        require(merged["gate_pass"] and len(merged["milestones"]) == 10,
                f"tools: parity gate {merged['gate_pass']} over {merged['milestones']}")
        summary = quality_summary.main(["--json-glob", os.path.join(work, "quality_*.json"),
                                        "--out", os.path.join(work, "summary.md"),
                                        "--parity", merged_path])
        require("**PASS**" in summary, "tools: quality_summary's parity section")
        torch.cuda.empty_cache()

        graft = timed("graft_entry", lambda: _tools_entry(torch, np))
        counts = kernel_launches()
        for name in REPLACES:
            want = name in PATHS["tools"]["kernels"]
            require((counts[name] > 0) == want,
                    f"tools: kernel {name} launched {counts[name]} times")
        coll = _tools_collectives()
        secs.update({f"collectives_{k}": v for k, v in coll.pop("seconds").items()})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = {"phase": "tools", "card": smi, "seconds": secs, "phase_s": time.perf_counter() - t_phase,
           "launches": counts, "checkpoints_rendered": [os.path.basename(p) for p in rendered],
           "gif_frames": n_gif, "render_bench": rb, "profile_step": prof,
           "profile_step_encode": encode,
           "bench_quality": qb, "quality_summary": summary,
           "parity": {"merged": merged, "ours": curves}, "graft_entry": graft, **coll}
    emit(rec)
    shown = [("render s/frame 800x800", rb["seconds_per_frame"]),
             ("eval rays/s", rb["eval_rays_per_s"]),
             ("keep 0.5 eval rays/s", rb["eval_keep_sweep"][0]["eval_rays_per_s"]),
             ("profile default step ms", prof["default"]["readings_ms"]["step"]),
             ("profile parity step ms", prof["parity"]["readings_ms"]["step"]),
             ("parity mean delta dB", merged["mean_delta_db"]), ("phase_s", rec["phase_s"])]
    print("tools: " + "; ".join(f"{k} {v:.6g} [{smi}]" for k, v in shown), flush=True)
    return rec


# --------------------------------------------------------------------------- #
# Phase: multi (slice 10, multi-device training)
# --------------------------------------------------------------------------- #

MULTI_ITERS = 40  # run_nerf.main's eager steps with TV
MULTI_TIMED = 10  # eager steps timed without TV, from step 1001
MULTI_GRAPH_START = 48  # the graphed window with TV, as the chair path's
MULTI_VS_ONE_STEPS = 16  # steps held against the one-process Trainer (one rank)
MULTI_TABLE_STEPS = 8
MULTI_ZERO_BF16_STEPS = 16
MULTI_GLOO_WORLD = 2  # ranks sharing the one card over gloo
MULTI_LOSS_RTOL = 1e-4
# The flagship run (slice 11): its eager windows culled at the schedule's
# budgets, with TV from the warmup's end and without from its last step
MULTI_FLAGSHIP_TV = (PATHS["flagship"]["tv_start"], 5)  # (start, steps)
MULTI_FLAGSHIP_NO_TV = (PATHS["flagship"]["no_tv_start"], 10)


def _multi_counts():
    from hashnerf_torch import kernels
    from hashnerf_torch.parallel import mesh

    return {**kernel_launches(), **mesh.collective_counts()}


def _multi_reset():
    from hashnerf_torch import kernels
    from hashnerf_torch.parallel import mesh

    kernels.reset_launch_counts()
    mesh.reset_collective_counts()


def _multi_sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _multi_chair(device, flags, *extra):
    return ["--config", os.path.join(ROOT, "configs", "chair.txt"), "--dataset_type", "synthetic",
            "--device", "cuda" if device.type == "cuda" else "cpu", *extra, *flags]


def multi_vs_one(torch, trainer, world: int, n_steps: int, bf16_mlp: bool = False):
    """The data-parallel trainer against a one-process Trainer that takes
    its state, optimizer state, occupancy grid and generator state: one
    step each (the loss within MULTI_LOSS_RTOL; MLP gradients bit-equal
    over one rank, else in the atomics' row gate as the tables'; with
    bf16_mlp, over several ranks the MLP gradients are only recorded: bf16
    operands turn a last-bit difference of a float32 raw into 2^-9 of it,
    so the bf16 flagship is held by its loss and its float32 table
    gradients), then n_steps more each
    from one snapshot, twice on each, held by the graph gate's rule: the
    fewer entries outside the row gate of the two pairs at most the larger
    of GATE_SPREAD_FACTOR x the spread within a trainer and the floor; the
    last loss likewise)."""
    import copy

    from hashnerf_torch.train.driver import Trainer

    args = copy.copy(trainer.args)
    args.num_devices = 0  # its args name the world's ranks: one device here
    one = Trainer(args, trainer.scene, device=trainer.device, seed=0)
    with torch.no_grad():
        for a, b in zip(one.state.parameters(), trainer.state.parameters()):
            a.copy_(b)
    one.optimizer.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    one.generator.set_state(trainer.generator.get_state())
    one.global_step = trainer.global_step
    if trainer.occ_grid is not None:
        one.occ_grid.copy_(trainer.occ_grid)
        one._occ_ready = trainer._occ_ready
    l_dp = float(trainer.step(trainer.sample_batch(False))["loss"])
    l_one = float(one.step(one.sample_batch(False))["loss"])
    grads = lambda tr, of: [p.grad.detach() for p in of(tr)]  # noqa: E731
    mlp_diff = sum(int((a != b).sum()) for a, b in zip(grads(trainer, GATE_GROUPS["mlp"]),
                                                       grads(one, GATE_GROUPS["mlp"])))
    mlp_out, _ = row_gate(grads(trainer, GATE_GROUPS["mlp"]), grads(one, GATE_GROUPS["mlp"]))
    table_out, table_worst = row_gate(grads(trainer, GATE_GROUPS["tables"]),
                                      grads(one, GATE_GROUPS["tables"]))
    rec = {"one_step": {"loss": [l_dp, l_one], "mlp_grad_entries_differing": mlp_diff,
                        "mlp_grad_outside_row_gate": mlp_out,
                        "table_grad_outside_row_gate": table_out,
                        "table_grad_max_abs_diff": table_worst,
                        "keeps": [trainer.last_occ_keep, one.last_occ_keep]}}
    mlp_ok = mlp_diff == 0 if world == 1 else (bf16_mlp or mlp_out == 0)
    require(abs(l_dp - l_one) <= MULTI_LOSS_RTOL * abs(l_one) and table_out == 0 and mlp_ok
            and trainer.last_occ_keep == one.last_occ_keep,
            f"the data-parallel step over {world} ranks is not the one-process step: {rec}")
    if n_steps:
        # n_steps from one snapshot (the data-parallel trainer's), twice on
        # each trainer: the graph gate's rule (graphed_window), the two
        # trainers in place of its two modes
        snap = [t.detach().clone() for t in trainer.training_state()]
        rng, start = trainer.generator.get_state(), trainer.global_step

        def run(tr):
            with torch.no_grad():
                for t, v in zip(tr.training_state(), snap):
                    t.copy_(v)
            tr.generator.set_state(rng)
            tr.global_step = start
            for _ in range(n_steps):
                m = tr.step(tr.sample_batch(False))
            return ({g: [t.detach().clone() for t in GATE_GROUPS[g](tr)] for g in ("tables", "mlp")},
                    float(m["loss"]))

        (dp1, l_dp1), (one1, l_one1) = run(trainer), run(one)
        (dp2, l_dp2), (one2, l_one2) = run(trainer), run(one)
        rec["steps"] = {"n": n_steps, "last_loss": {"dp": [l_dp1, l_dp2], "one": [l_one1, l_one2]}}
        for group in ("tables", "mlp"):
            out = lambda a, b: row_gate(a[group], b[group])[0]  # noqa: E731
            share = GATE_CROSS_MODE[group]
            share = share["chair"] if isinstance(share, dict) else share
            g = rec["steps"][group] = {
                "dp_vs_one": [out(dp1, one1), out(dp2, one2)], "dp_vs_dp": out(dp2, dp1),
                "one_vs_one": out(one2, one1),
                "floor": math.ceil(GATE_FLOOR_MARGIN * share * sum(t.numel() for t in one1[group]))}
            g["allowed"] = max(GATE_SPREAD_FACTOR * max(g["dp_vs_dp"], g["one_vs_one"], 1),
                               g["floor"])
            require(min(g["dp_vs_one"]) <= g["allowed"],
                    f"{n_steps} data-parallel steps off the one-process ones ({group}): {rec}")
        loss_tol = max(GATE_LOSS_FLOOR * abs(l_one1),
                       10 * max(abs(l_dp2 - l_dp1), abs(l_one2 - l_one1)))
        require(min(abs(l_dp1 - l_one1), abs(l_dp2 - l_one2)) <= loss_tol,
                f"{n_steps} data-parallel steps: last loss off the one-process one: {rec}")
    del one
    return rec


def multi_path(torch, np, rank, world, device, workdir, graphed, flags):
    """The chair step at full width through run_nerf.main --num_devices
    world (MULTI_ITERS eager steps with TV, a checkpoint and the test set
    by rank 0), MULTI_TIMED eager steps without TV, the gradient
    all-reduce alone, the graphed window (NCCL), K2 and K6 at the rank's
    shapes (encode_check), then multi_vs_one."""
    from hashnerf_torch import run_nerf
    from hashnerf_torch.parallel.mesh import shard_batch
    from hashnerf_torch.parallel.train_sharded import reduce_gradients

    cuda = device.type == "cuda"
    _multi_reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = run_nerf.main(_multi_chair(device, flags, "--basedir", workdir, "--expname", "multi",
                                         "--no_reload", "--N_iters", str(MULTI_ITERS),
                                         "--i_print", "10", "--i_weights", str(MULTI_ITERS),
                                         "--i_testset", str(MULTI_ITERS), "--i_video", "0",
                                         "--num_devices", str(world)))
    _multi_sync(torch, device)
    loop_s = time.perf_counter() - t0
    require(trainer.layout is not None and trainer.layout.world == world,
            f"rank {rank}: run_nerf.main made no data-parallel trainer")
    expdir = os.path.join(workdir, trainer.args.expname)
    ckpts = sorted(f for f in os.listdir(expdir) if f.endswith(".ckpt"))
    require(ckpts == ["{:06d}.ckpt".format(MULTI_ITERS)], f"rank {rank}: checkpoints {ckpts}")
    require(os.path.isdir(os.path.join(expdir, "testset_{:06d}".format(MULTI_ITERS))),
            f"rank {rank}: no test set written")
    losses = [h[1] for h in trainer.history]
    require(len(losses) == MULTI_ITERS // 10 and all(np.isfinite(losses)),
            f"rank {rank}: losses {losses}")
    c_loop = _multi_counts()

    trainer.global_step = 1001
    ts = []
    for _ in range(MULTI_TIMED):
        _multi_sync(torch, device)
        t0 = time.perf_counter()
        m = trainer.step(trainer.sample_batch(False))
        float(m["loss"])
        ts.append(time.perf_counter() - t0)
    c_eager = _multi_counts()
    params = list(trainer.state.parameters())
    grad_bytes = sum(p.grad.numel() * p.grad.element_size() for p in params if p.grad is not None)
    group = trainer.layout.data_group
    if cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reduce_gradients(params, group)
        e0.record()
        for _ in range(10):
            reduce_gradients(params, group)
        e1.record()
        e1.synchronize()
        ar_ms = e0.elapsed_time(e1) / 10
    else:
        t0 = time.perf_counter()
        for _ in range(10):
            reduce_gradients(params, group)
        ar_ms = (time.perf_counter() - t0) * 100
    rec = {"loop_s": loop_s, "losses": losses, "step_ms_eager": [t * 1e3 for t in ts],
           "train_rays_per_s_eager": trainer.args.N_rand / statistics.median(ts),
           "grad_all_reduce_ms": ar_ms, "grad_all_reduce_bytes": grad_bytes,
           "grad_all_reduce_how": "CUDA events over 10" if cuda else "host clock over 10",
           "launches_loop": c_loop,
           "launches_per_step_eager": {k: (c_eager[k] - c_loop[k]) / MULTI_TIMED for k in c_loop}}
    if graphed:
        c0 = _multi_counts()
        g = graphed_window(torch, trainer, "chair", MULTI_GRAPH_START, "tv", False)
        c1 = _multi_counts()
        # two more blocks (the first captures, its warm-up step eager): the
        # second's replays must run the captured all-reduce as often as an
        # eager step calls it
        trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)
        c1b = _multi_counts()
        trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)
        c2 = _multi_counts()
        g["collectives_per_graphed_step"] = {k: (c2[k] - c1b[k]) / GRAPH_BLOCK
                                             for k in ("all_reduce", "all_gather", "reduce_scatter")}
        # blocks without TV, timed only (the gate ran on the TV window)
        trainer.global_step = GRAPH_NO_TV_START
        trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)  # captures
        ts_g = []
        for _ in range(GRAPH_TIMED_BLOCKS["no_tv"]):
            _multi_sync(torch, device)
            t0 = time.perf_counter()
            float(trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)["loss"])
            ts_g.append(time.perf_counter() - t0)
        rec["step_ms_graphed_no_tv"] = statistics.median(ts_g) / GRAPH_BLOCK * 1e3
        rec["train_rays_per_s_graphed_no_tv"] = (trainer.args.N_rand * GRAPH_BLOCK
                                                 / statistics.median(ts_g))
        rec["graphed"] = g
        rec["train_rays_per_s_graphed_tv"] = g["train_rays_per_s_graphed"]
        per = g["launches_per_step"]
        eager_ar = rec["launches_per_step_eager"]["all_reduce"]
        require(per["hash_encode_fwd"] > 0 and per["hash_encode_bwd"] > 0
                and per["segment_accumulate_k5"] > 0 and c1["all_reduce"] > c0["all_reduce"]
                and g["collectives_per_graphed_step"]["all_reduce"] == eager_ar,
                f"rank {rank}: the graphed window launched {per}, "
                f"{g['collectives_per_graphed_step']} collectives a replayed step")
    if cuda:
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = _multi_counts()
    require(rec["launches"]["all_reduce"] > 0, f"rank {rank}: no all-reduce was called")
    if cuda:
        # K2 and K6 against their plain versions at this rank's shapes (its
        # rows of one global batch), after the counts were read; one rank
        # at a time, as ranks may share a card
        batch = shard_batch(trainer.layout, trainer.sample_batch(False))
        for r in range(world):
            if r == rank:
                rec["encode"] = encode_check(
                    torch, trainer, batch, f"multi_{torch.distributed.get_backend()}_rank{rank}")
            torch.distributed.barrier()
    rec["vs_one_process"] = multi_vs_one(torch, trainer, world, MULTI_VS_ONE_STEPS if world == 1 else 0)
    return rec


def multi_zero(torch, np, rank, world, device, flags):
    """ZeRO-1 at the chair's widths on one fixed batch, deterministic
    rendering, no TV: one step with a float32 wire against the one-device
    step from the same state (loss; the rank's chunk of every gradient,
    MLPs bit-equal over one rank), timed; then MULTI_ZERO_BF16_STEPS with
    the bf16 wire, whose loss must fall."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh
    from hashnerf_torch.parallel.train_sharded import (
        _chunk, init_dp_zero, make_dp_zero_train_step, rank_generator, zero_params,
    )
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    args = parse_args(_multi_chair(device, flags, "--perturb", "0", "--raw_noise_std", "0",
                                   "--tv-loss-weight", "0"))
    scene = make_synthetic_scene(H=128, W=128, n_train=8, n_test=2)
    t = Trainer(args, scene, device=device, seed=0)
    batch = t.sample_image(0, args.N_rand, False)
    layout = make_mesh(world)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, with_tv=False, hwf=scene.hwf)
    snap = [p.detach().clone() for p in t.state.parameters()]

    def restore():
        with torch.no_grad():
            for p, s in zip(t.state.parameters(), snap):
                p.copy_(s)

    gen = rank_generator(0, layout, device)
    _multi_reset()
    master, opt = init_dp_zero(layout, t.state, args)
    step = make_dp_zero_train_step(layout, loss_fn, t.state, torch.float32, torch.float32)
    lz = float(step(master, opt, batch, 0.0, gen)["loss"])
    zgrads = [c.grad.clone() for c in master]
    c_fp32 = _multi_counts()
    restore()
    l1 = float(t.step(batch)["loss"])
    n, r = layout.n_data, layout.data_index
    params = zero_params(t.state)
    g1 = [_chunk(p.grad, n)[r] for p in params]
    n_net = len(t.state.net_parameters())
    mlp_diff = sum(int((a != b).sum()) for a, b in zip(zgrads[:n_net], g1[:n_net]))
    F = t.model_cfg.hash_grid.n_features_per_level
    rows = lambda gs: [g.reshape(-1, F) for g in gs]  # noqa: E731
    mlp_out, _ = row_gate(zgrads[:n_net], g1[:n_net])
    table_out, table_worst = row_gate(rows(zgrads[n_net:]), rows(g1[n_net:]))
    rec = {"fp32": {"loss": [lz, l1], "mlp_grad_entries_differing": mlp_diff,
                    "mlp_grad_outside_row_gate": mlp_out, "table_grad_outside_row_gate": table_out,
                    "table_grad_max_abs_diff": table_worst,
                    "moment_floats_per_rank": sum(st["exp_avg"].numel() for st in opt.state.values()),
                    "param_floats": sum(p.numel() for p in params)}, "bf16": {}}
    require(abs(lz - l1) <= MULTI_LOSS_RTOL * abs(l1) and mlp_out == 0 and table_out == 0
            and (world > 1 or mlp_diff == 0),
            f"ZeRO-1 (float32 wire) over {world} ranks is not the one-device step: {rec}")
    for wire, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        # bytes a rank moves a step: the all-gather's output and the
        # reduce-scatter's input, at the wire's width
        rec[wire]["wire_bytes_per_rank"] = 2 * sum(
            _chunk(p, n).numel() * dtype.itemsize for p in params)
    if device.type == "cuda":
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            step(master, opt, batch, 0.0, gen)
        e1.record()
        e1.synchronize()
        rec["fp32"]["step_ms"] = e0.elapsed_time(e1) / 5
    restore()
    _multi_reset()
    master, opt = init_dp_zero(layout, t.state, args)
    step = make_dp_zero_train_step(layout, loss_fn, t.state)
    losses = []
    for _ in range(MULTI_ZERO_BF16_STEPS):
        _multi_sync(torch, device)
        t0 = time.perf_counter()
        losses.append(float(step(master, opt, batch, 0.0, gen)["loss"]))
        rec["bf16"].setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
    rec["bf16"]["losses"] = losses
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"ZeRO-1 (bf16 wire): the loss did not fall over {len(losses)} steps: {losses}")
    rec["launches"] = _multi_counts()
    rec["launches_fp32_step"] = c_fp32
    return rec


def multi_table(torch, np, rank, world, device, flags):
    """The table-sharded trainer on a (1, world) layout (each rank world's
    share of the levels): its first step's loss against the one-device
    trainer's from the same seed, MULTI_TABLE_STEPS steps; on the card K2
    and K6 on this rank's levels at the step's points, held to their plain
    versions (encode_check; its launches are not counted)."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.table_sharded import make_table_mesh, make_table_sharded_trainer
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    args = parse_args(_multi_chair(device, flags, "--tv-loss-weight", "0"))
    scene = make_synthetic_scene(H=128, W=128, n_train=8, n_test=2)
    layout = make_table_mesh(1, world)
    ts = make_table_sharded_trainer(layout, args, scene, device=device, seed=0)
    one = Trainer(args, scene, device=device, seed=0)
    l_one = float(one.step(one.sample_batch(False))["loss"])
    del one
    _multi_reset()
    losses = [float(ts.step(ts.sample_batch(False))["loss"]) for _ in range(MULTI_TABLE_STEPS)]
    rec = {"levels": list(ts.state.resolutions.shape), "losses": losses, "one_device_loss": l_one,
           "launches": _multi_counts()}
    require(abs(losses[0] - l_one) <= MULTI_LOSS_RTOL * abs(l_one) and all(np.isfinite(losses)),
            f"table-sharded (1, {world}) first step off the one-device one: {rec}")
    if device.type == "cuda":
        rec["encode"] = encode_check(torch, ts, ts.sample_batch(False), f"multi_table_rank{rank}")
    return rec


def _culled_window(torch, trainer, start: int, n: int, want_keep, what: str):
    """n eager steps from global_step start, host-clock timed; each must
    cull at want_keep (last_occ_keep)."""
    trainer.global_step = start
    ts, keeps = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        float(trainer.step(trainer.sample_batch(False))["loss"])
        ts.append(time.perf_counter() - t0)
        keeps.append(trainer.last_occ_keep)
    require(all(k == want_keep for k in keeps), f"{what}: keeps {keeps}, not {want_keep}")
    return {"start": start, "step_ms": [t * 1e3 for t in ts], "keeps": keeps,
            "train_rays_per_s": trainer.args.N_rand / statistics.median(ts)}


def share_k5(torch, trainer, rank, world, tag: str):
    """K5 on this rank's share of one global batch's kept blocks: the
    points its query takes in a culled render at FLAGSHIP_KEEP (every rank
    draws the batch and the render's numbers alike, takes the one cut and
    gathers the others' raws), coarse and fine, held to its plain version
    (k5_at_kept_points), one rank at a time (ranks may share a card)."""
    import torch.distributed as dist

    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import keep_k, render_rays

    pts = {}

    def capture(st, p, viewdirs, bbox, fine=False):
        pts["fine" if fine else "coarse"] = p.reshape(-1, 3).detach().clone()
        return query_fn(st, p, viewdirs, bbox, fine=fine)

    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(1)
    batch = trainer.sample_batch(False)
    d = batch["rays_d"]
    cfg = trainer._render_cfg_for(FLAGSHIP_KEEP[0])
    with torch.no_grad():
        render_rays(trainer.state, capture, batch["rays_o"], d,
                    d / torch.linalg.norm(d, dim=-1, keepdim=True), batch["near"], batch["far"],
                    trainer.bbox, cfg, generator=gen, occ_grid=trainer.occ_grid,
                    layout=trainer.layout)
    R, B, args = d.shape[0], cfg.occupancy.block, trainer.args
    for name, n, kf in (("coarse", R * args.N_samples, FLAGSHIP_KEEP[1]),
                        ("fine", R * (args.N_samples + args.N_importance), FLAGSHIP_KEEP[0])):
        blocks = keep_k(n, kf) // B
        require(pts[name].shape[0] == B * -(-blocks // world),
                f"rank {rank}: its {name} share is {pts[name].shape[0]} points of {blocks} blocks")
    out = None
    for r in range(world):
        if r == rank:
            state = trainer.state
            out = k5_at_kept_points(
                torch, {(f"{tag}_rank{rank}_{p}_slabs", f"{tag}_rank{rank}_{p}_dense_voxels"): pts[p]
                        for p in ("coarse", "fine")},
                state.packed_cfg, trainer.bbox[0].contiguous(), trainer.bbox[1].contiguous(),
                "multi_share_k5")
            out["points"] = {p: int(pts[p].shape[0]) for p in pts}
        dist.barrier()
    return out


def culling_collectives_ms(torch, trainer, world: int):
    """The culling's all-gather and reduce-scatter alone at a pass's shapes
    (the raws of FLAGSHIP_KEEP's kept blocks, 8 samples x 4 floats a
    block, in shares of ceil(blocks / world)), 10 of each timed by CUDA
    events (NCCL) or the host clock (gloo)."""
    from hashnerf_torch.parallel.mesh import all_gather, reduce_scatter

    from hashnerf_torch.render.renderer import keep_k

    args, group = trainer.args, trainer.layout.data_group
    per = -(-(keep_k(args.N_rand * args.N_samples, FLAGSHIP_KEEP[1]) // 8) // world)
    share = torch.randn((per, 8, 4), device=trainer.device)
    whole = torch.empty((per * world, 8, 4), device=trainer.device)
    cuda = trainer.device.type == "cuda"
    out = {"share_blocks": per, "gathered_bytes": whole.numel() * 4,
           "how": "CUDA events over 10" if cuda else "host clock over 10"}
    for name, fn in (("all_gather_ms", lambda: all_gather(whole, share, group)),
                     ("reduce_scatter_ms", lambda: reduce_scatter(share, whole, group))):
        fn()
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):
                fn()
            e1.record()
            e1.synchronize()
            out[name] = e0.elapsed_time(e1) / 10
        else:
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            out[name] = (time.perf_counter() - t0) * 100
    return out


def multi_flagship(torch, np, rank, world, device, workdir, graphed, flags):
    """The tpu-fast flagship at full width (configs/chair.txt with
    FLAGSHIP_FLAGS: packed tables, bf16 MLP operands, block-8 global
    culling; 1024 rays of 64 + 128 samples) through run_nerf.main
    --num_devices world: MULTI_ITERS eager steps with TV (the grid updates
    at 16 and 32 fill the grid), a checkpoint and the test set; then eager
    windows moved as the one-process flagship path's, each step culled at
    the schedule's budget (MULTI_FLAGSHIP_TV at 0.5 / 0.375,
    MULTI_FLAGSHIP_NO_TV at 0.125 / 0.375); under NCCL the graphed window
    with TV from 256 held to the graph gate (graphed_window) and blocks
    without TV from 1024 timed, with their collectives a replayed step;
    the culling's collectives alone; K5 on this rank's share of a global
    batch's kept blocks (share_k5); then one step against the one-process
    flagship (multi_vs_one)."""
    from hashnerf_torch import run_nerf

    cuda = device.type == "cuda"
    _multi_reset()
    t0 = time.perf_counter()
    trainer = run_nerf.main(_multi_chair(device, [*FLAGSHIP_FLAGS, *flags], "--basedir", workdir,
                                         "--expname", "flagship", "--no_reload",
                                         "--N_iters", str(MULTI_ITERS), "--i_print", "10",
                                         "--i_weights", str(MULTI_ITERS),
                                         "--i_testset", str(MULTI_ITERS), "--i_video", "0",
                                         "--num_devices", str(world)))
    _multi_sync(torch, device)
    loop_s = time.perf_counter() - t0
    require(trainer.layout is not None and trainer.layout.world == world and trainer._occ_ready,
            f"rank {rank}: no data-parallel flagship trainer with a ready grid")
    expdir = os.path.join(workdir, trainer.args.expname)
    require(os.path.exists(os.path.join(expdir, "{:06d}.ckpt".format(MULTI_ITERS))),
            f"rank {rank}: no flagship checkpoint")
    losses = [h[1] for h in trainer.history]
    require(all(np.isfinite(losses)), f"rank {rank}: flagship losses {losses}")
    c_loop = _multi_counts()
    windows = {
        "tv": _culled_window(torch, trainer, *MULTI_FLAGSHIP_TV, PATHS["flagship"]["keeps_tv"],
                             f"rank {rank} flagship, TV"),
        "no_tv": _culled_window(torch, trainer, *MULTI_FLAGSHIP_NO_TV, FLAGSHIP_KEEP,
                                f"rank {rank} flagship, no TV")}
    c_eager = _multi_counts()
    n_eager = MULTI_FLAGSHIP_TV[1] + MULTI_FLAGSHIP_NO_TV[1]
    rec = {"loop_s": loop_s, "losses": losses, "eager": windows,
           "train_rays_per_s_eager_tv": windows["tv"]["train_rays_per_s"],
           "train_rays_per_s_eager_no_tv": windows["no_tv"]["train_rays_per_s"],
           "launches_loop": c_loop,
           "launches_per_step_eager": {k: (c_eager[k] - c_loop[k]) / n_eager for k in c_loop}}
    eager_per = rec["launches_per_step_eager"]
    require(eager_per["all_gather"] == eager_per["reduce_scatter"] == 2,
            f"rank {rank}: the culled eager steps ran {eager_per} collectives a step")
    if graphed:
        g = graphed_window(torch, trainer, "flagship", PATHS["flagship"]["graph_tv_start"], "tv",
                           False)
        trainer.global_step = GRAPH_NO_TV_START
        trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)  # captures
        c1 = _multi_counts()
        ts_g, keeps = [], []
        for _ in range(GRAPH_TIMED_BLOCKS["no_tv"]):
            _multi_sync(torch, device)
            t0 = time.perf_counter()
            float(trainer.run_steps(GRAPH_BLOCK, block_size=GRAPH_BLOCK)["loss"])
            ts_g.append(time.perf_counter() - t0)
            keeps.append(trainer.last_occ_keep)
        c2 = _multi_counts()
        n_g = GRAPH_BLOCK * len(ts_g)
        per = {k: (c2[k] - c1[k]) / n_g for k in c1}
        require(all(k == FLAGSHIP_KEEP for k in keeps),
                f"rank {rank}: graphed flagship blocks at keeps {keeps}")
        require(per["packed_encode_fwd"] > 0 and per["packed_encode_bwd"] > 0
                and per["segment_accumulate_k5"] == 0
                and all(per[k] == eager_per[k] for k in ("all_reduce", "all_gather",
                                                         "reduce_scatter")),
                f"rank {rank}: a replayed flagship step launched {per}, an eager one {eager_per}")
        rec["graphed"] = g
        rec["train_rays_per_s_graphed_tv"] = g["train_rays_per_s_graphed"]
        rec["step_ms_graphed_no_tv"] = statistics.median(ts_g) / GRAPH_BLOCK * 1e3
        rec["train_rays_per_s_graphed_no_tv"] = (trainer.args.N_rand * GRAPH_BLOCK
                                                 / statistics.median(ts_g))
        rec["launches_per_graphed_step_no_tv"] = per
    rec["launches"] = _multi_counts()
    rec["culling_collectives"] = culling_collectives_ms(torch, trainer, world)
    if cuda:
        rec["share_k5"] = share_k5(torch, trainer, rank, world,
                                   f"multi_{torch.distributed.get_backend()}")
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["vs_one_process"] = multi_vs_one(torch, trainer, world, 0, bf16_mlp=True)
    return rec


def multi_rank(rank, world, device, workdir, graphed, flags=()):
    """What each rank of the multi phase runs: the chair path, ZeRO-1, the
    table-sharded trainer and the flagship, each with its own launch
    counts."""
    import numpy as np
    import torch

    out = {"rank": rank, "world": world, "device": str(device),
           "backend": torch.distributed.get_backend()}
    for name, fn in (("path", lambda: multi_path(torch, np, rank, world, device,
                                                  os.path.join(workdir, "path"), graphed, flags)),
                     ("zero", lambda: multi_zero(torch, np, rank, world, device, flags)),
                     ("table", lambda: multi_table(torch, np, rank, world, device, flags)),
                     ("flagship", lambda: multi_flagship(torch, np, rank, world, device,
                                                         os.path.join(workdir, "flagship"),
                                                         graphed, flags))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_multi(torch, np, smi: str):
    """Multi-device training on the card (phase_multi, slice 10): the ranks
    of multi_rank under NCCL, one a card (W = the cards present), then
    MULTI_GLOO_WORLD ranks sharing card 0 over gloo (gloo takes CUDA
    tensors for every collective the port calls: all-reduce, all-gather,
    reduce-scatter, broadcast, barrier). Every rank's launches of each run
    are gated by PATHS["multi"], and every rank holds K2 and K6 to their
    plain versions at its own shapes (multi_path, multi_table) and K5 at
    its share of the flagship's kept blocks (multi_flagship, slice 11)."""
    from hashnerf_torch.parallel.mesh import launch

    W = torch.cuda.device_count()
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hashnerf_torch_multi_")
    try:
        runs = {}
        for name, world, backend, graphed in (("nccl", W, "nccl", True),
                                              ("gloo", MULTI_GLOO_WORLD, "gloo", False)):
            t0 = time.perf_counter()
            res = launch(multi_rank, world, "cuda", (os.path.join(workdir, name), graphed),
                         backend=backend)
            runs[name] = {"world": world, "seconds": time.perf_counter() - t0, "ranks": res}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {name: 0 for name in REPLACES}
    for name, run in runs.items():
        for r in run["ranks"]:
            for part, want in PATHS["multi"]["runs"].items():
                if r["rank"] == 0:
                    want = want + PATHS["multi"]["main_rank"].get(part, ())
                got = r[part]["launches"]
                for k in REPLACES:
                    require((got[k] > 0) == (k in want),
                            f"multi {name} rank {r['rank']} {part}: {k} launched {got[k]} times")
                    launches[k] += got[k]
            # encode_check and share_k5 ran at the rank's shapes (each raises
            # on a disagreement)
            require("encode" in r["path"] and "share_k5" in r["flagship"],
                    f"multi {name} rank {r['rank']}: K2/K6 or K5 not checked")
    rec = {"phase": "multi", "card": smi, "nccl_world": W, "gloo_world": MULTI_GLOO_WORLD,
           "cpu_only_modes": [], "phase_s": time.perf_counter() - t_phase, "runs": runs,
           "launches": launches,
           "encode_points": {name: [{p: r["path"]["encode"][p]["N"] for p in ("coarse", "fine")}
                                    for r in run["ranks"]] for name, run in runs.items()},
           "share_k5_points": {name: [r["flagship"]["share_k5"]["points"] for r in run["ranks"]]
                               for name, run in runs.items()}}
    emit(rec)
    return rec


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
    tv_k5 = phase_tv_k5(torch, np)
    geo = phase_packed_rows(torch, np)
    packed = phase_packed_kernels(torch, np, geo)
    del geo
    occupancy, kept_pts = phase_occupancy(torch, np)
    culled_k5 = phase_culled_k5(torch, np, kept_pts)
    packed_enc = phase_packed_encode(torch, np, kept_pts)
    del kept_pts
    torch.cuda.empty_cache()
    field = phase_field_kernels(torch)
    paths = {path: phase_main_path(torch, np, path, opts.profile) for path in MAIN_PATHS}
    torch.cuda.empty_cache()
    sets = tempfile.mkdtemp(prefix="hashnerf_torch_sets_")
    try:
        blender_set = os.path.join(sets, "blender")
        blender = phase_blender(torch, np, dev["smi"], opts.profile, blender_set)
        torch.cuda.empty_cache()
        llff = phase_llff(torch, np, dev["smi"], opts.profile)
        torch.cuda.empty_cache()
        st3d = phase_st3d(torch, np, dev["smi"], opts.profile)
        torch.cuda.empty_cache()
        loaders = phase_loaders(torch, np, dev["smi"])
        torch.cuda.empty_cache()
        tools = phase_tools(torch, np, dev["smi"], blender_set)
    finally:
        shutil.rmtree(sets, ignore_errors=True)
    torch.cuda.empty_cache()
    multi = phase_multi(torch, np, dev["smi"])
    torch.cuda.empty_cache()

    # K5 in the kernels line at the shape the main paths give it most bytes:
    # the packed TV's slabs
    tv = tv_k5["packed_tv_slabs"]
    kern["segment_accumulate_k5"] = {
        "max_abs_err": tv["max_abs_err"], "kernel_ms": statistics.median(tv["k5_ms"]),
        "plain_ms": tv["plain_ms"], "library_ms": statistics.median(tv["library_ms"]),
        "bound_ms": tv["bound_ms"], "bound_by": tv["bound_by"],
    }
    fine = packed["shapes"]["fine_slabs"]
    kern["segment_accumulate_k4"] = {
        "max_abs_err": fine["max_abs_err"], "kernel_ms": fine["kernel_ms"],
        "plain_ms": fine["plain_ms"], "library_ms": fine["library_ms"],
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
    }
    for name, k in (("packed_encode_fwd", "k7"), ("packed_encode_bwd", "k8")):
        case = packed_enc["fine"]
        kern[name] = {
            "max_abs_err": max(v for key, v in case.items()
                               if key.startswith(k) and key.endswith("vs_plain_max_abs_err")),
            "kernel_ms": case[f"{k}_ms"], "plain_ms": case[f"{k}_plain_ms"],
            "bound_ms": case[f"{k}_bound_ms"], "bound_by": case[f"{k}_bound_by"],
            "library_ms": None,  # no one PyTorch call computes it
        }
    case = field[FIELD_LINE_SHAPE]
    for name, k in (("field_colour_input_fwd", "k9"), ("field_colour_input_bwd", "k9_bwd"),
                    ("field_raw_fwd", "field_raw"), ("field_raw_bwd", "field_raw_bwd"),
                    ("field_mlp_fwd", "mlp"), ("field_mlp_fwd_f32", "mlp_f32")):
        kern[name] = {
            "max_abs_err": case[f"{k}_max_abs_err"],
            "kernel_ms": case[f"{k}_ms"], "plain_ms": case[f"{k}_plain_ms"],
            "bound_ms": case[f"{k}_bound_ms"], "bound_by": case[f"{k}_bound_by"],
            "library_ms": None,  # the copies it replaced were several calls
        }
    lines = []
    for name, info in kernel_info().items():
        k = kern[name]
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        by_path["blender"] = blender["launches"][name]
        by_path["llff"] = llff["launches"][name]
        by_path["st3d"] = st3d["launches"][name]
        by_path["loaders"] = loaders["launches"][name]
        by_path["tools"] = tools["launches"][name]
        by_path["multi"] = multi["launches"][name]
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
                       "tv_k5": tv_k5,
                       "packed_kernels": packed, "occupancy": occupancy, "culled_k5": culled_k5,
                       "packed_encode": packed_enc, "field_kernels": field,
                       "main_paths": paths, "blender": blender,
                       "llff": llff, "st3d": st3d, "loaders": loaders, "tools": tools,
                       "multi": multi,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f} [{dev['smi']}]", flush=True)
    print(f"card: {dev['smi']}", flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI/config system: the whole flag set of hashnerf_tpu/train/config.py.

Same flag names, defaults and `key = value` config files (configs/*.txt),
plus `--device`. `check_supported` raises NotImplementedError, naming the
ROADMAP row, for every flag that selects something the port does not have
yet: no flag is silently ignored. Also create_expname.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def _parse_config_file(path: str) -> List[str]:
    """Convert a configargparse-style `key = value` file to CLI argv tokens."""
    argv: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, val = line.split("=", 1)
            else:
                parts = line.split(None, 1)
                key, val = parts[0], (parts[1] if len(parts) > 1 else "true")
            key, val = key.strip(), val.strip()
            if val.lower() in ("true", "yes"):
                argv.append(f"--{key}")
            elif val.lower() in ("false", "no"):
                pass  # store_true flags default to False
            else:
                argv.extend([f"--{key}", val])
    return argv


def config_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hashnerf_torch.run_nerf")
    parser.add_argument("--config", type=str, default=None, help="config file path")
    parser.add_argument("--expname", type=str, default="exp", help="experiment name")
    parser.add_argument("--basedir", type=str, default="./logs/")
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")

    # training options
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--netdepth_fine", type=int, default=8)
    parser.add_argument("--netwidth_fine", type=int, default=256)
    parser.add_argument("--N_rand", type=int, default=32 * 32 * 4)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--lrate_decay", type=int, default=250)
    parser.add_argument("--chunk", type=int, default=1024 * 32)
    parser.add_argument("--netchunk", type=int, default=1024 * 64)
    parser.add_argument("--no_batching", action="store_true")
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ft_path", type=str, default=None)
    parser.add_argument("--N_iters", type=int, default=50000,
                        help="training iterations (reference hardcodes 50k std / 200k st3d)")

    # rendering options
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=0)
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--use_viewdirs", action="store_true")
    parser.add_argument("--i_embed", type=int, default=1)
    parser.add_argument("--i_embed_views", type=int, default=2)
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--raw_noise_std", type=float, default=0.0)

    parser.add_argument("--render_only", action="store_true")
    parser.add_argument("--render_test", action="store_true")
    parser.add_argument("--render_factor", type=int, default=0)

    parser.add_argument("--precrop_iters", type=int, default=0)
    parser.add_argument("--precrop_frac", type=float, default=0.5)

    # dataset options
    parser.add_argument("--dataset_type", type=str, default="llff")
    parser.add_argument("--testskip", type=int, default=8)
    parser.add_argument("--shape", type=str, default="greek")  # deepvoxels
    parser.add_argument("--white_bkgd", action="store_true")
    parser.add_argument("--half_res", action="store_true")
    parser.add_argument("--scannet_sceneID", type=str, default="scene0000_00")
    parser.add_argument("--factor", type=int, default=8)  # llff
    parser.add_argument("--no_ndc", action="store_true")
    parser.add_argument("--lindisp", action="store_true")
    parser.add_argument("--spherify", action="store_true")
    parser.add_argument("--llffhold", type=int, default=8)

    # st3d flags
    parser.add_argument("--use_depth", action="store_true")
    parser.add_argument("--use_gradient", action="store_true")
    parser.add_argument("--stage", type=int, default=0)
    parser.add_argument("--st3d_eval_views", type=int, default=0,
                        help="TPU extension: render only the LAST k test "
                        "panoramas in eval_test_omninerf (the GT pose is "
                        "always last, so statistics.txt is unaffected); "
                        "0 = all views (reference behavior)")

    # logging/saving options
    parser.add_argument("--i_print", type=int, default=100)
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_weights", type=int, default=10000)
    parser.add_argument("--i_testset", type=int, default=1000)
    parser.add_argument("--i_video", type=int, default=5000)

    parser.add_argument("--finest_res", type=int, default=512)
    parser.add_argument("--log2_hashmap_size", type=int, default=19)
    parser.add_argument("--sparse-loss-weight", type=float, default=1e-10,
                        dest="sparse_loss_weight")
    parser.add_argument("--tv-loss-weight", type=float, default=1e-6,
                        dest="tv_loss_weight")

    # TPU-native extensions (not in the reference)
    parser.add_argument("--n_levels", type=int, default=16,
                        help="hash-grid levels L (reference hardcodes 16)")
    parser.add_argument("--n_features_per_level", type=int, default=2,
                        help="features per level F; L=8/F=4 keeps the 32-dim "
                        "encoding but halves the gather count (TPU fast mode)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        help="MLP operand type: bfloat16 (or float16, a float8 "
                        "type) rounds the operands of float32 products; float32 "
                        "and float64 run the float32 product")
    parser.add_argument("--use_occupancy", action="store_true",
                        help="Instant-NGP-style occupancy-grid sample culling")
    parser.add_argument("--occ_resolution", type=int, default=128)
    parser.add_argument("--occ_keep_fraction", type=float, default=0.5)
    parser.add_argument("--occ_update_every", type=int, default=16)
    parser.add_argument("--occ_warmup", type=int, default=256)
    parser.add_argument("--occ_partition", type=str, default="sort1",
                        choices=["sort2", "sort1", "cumsum"],
                        help="keep-budget selection: sort2 = two argsorts "
                        "(round-3 path), sort1 = one argsort + scatter "
                        "inverse, cumsum = sort-free histogram-threshold "
                        "partition (approximate top-k)")
    parser.add_argument("--occ_adaptive_update", action="store_true",
                        help="importance-sample half the grid-update cells "
                        "near the current surface (top macro-blocks + "
                        "neighbor dilation) instead of all-uniform")
    parser.add_argument("--occ_per_ray", action="store_true",
                        help="per-RAY keep budget: each ray keeps its top "
                        "ceil(S*keep_fraction) samples by occupancy score, "
                        "compacted and composited with original per-sample "
                        "dists (exact zero-fill semantics; no global sort / "
                        "un-permute; shards over rays with no collective)")
    parser.add_argument("--occ_block", type=int, default=1,
                        help="global culling granularity in consecutive "
                        "samples (must divide N_samples and N_samples+"
                        "N_importance): keeps the global budget's cross-ray "
                        "reallocation while cutting the cull sort and "
                        "widening un-permute rows by the block factor")
    parser.add_argument("--occ_keep_coarse", type=float, default=-1.0,
                        help="coarse-pass keep budget override (<=0: use "
                        "--occ_keep_fraction). The coarse pass drives the "
                        "fine PDF and costs ~1/3 of the fine encode, so a "
                        "looser coarse budget buys PDF quality cheaply; the "
                        "--occ_keep_schedule anneals only the fine budget")
    parser.add_argument("--occ_per_ray_select", type=str, default="sort",
                        choices=["sort", "topk", "approx"],
                        help="per-ray top-K algorithm: sort (exact argsort), "
                        "topk (exact lax.top_k), approx (TPU approx_max_k, "
                        "recall ~0.95 — only reallocates budget, never "
                        "breaks compositing)")
    parser.add_argument("--occ_keep_eval", type=float, default=-1.0,
                        help="eval-only keep budget (testset/video/render-"
                        "only): <=0 = exact full evaluation (reference "
                        "semantics); 0.5-0.75 recovers most of the culling "
                        "speedup at eval, PSNR-delta-gated in RENDER_r05")
    parser.add_argument("--occ_keep_eval_coarse", type=float, default=-1.0,
                        help="eval-only COARSE keep budget (<=0 = use "
                        "--occ_keep_eval for both passes); a loose coarse + "
                        "tight fine is the measured-best eval split")
    parser.add_argument("--occ_score_stride", type=int, default=1,
                        help="score every k-th sample on a 3^3-dilated "
                        "occupancy grid (k=2 halves the score-gather "
                        "fetches; conservative coverage, quality-gated). "
                        "Only 1 or 2: the coverage needs consecutive probes "
                        "at most two cells apart")
    parser.add_argument("--occ_eval_transmittance", action="store_true",
                        help="weight eval-time fine culling scores by the "
                        "coarse pass's transmittance (static-shape early "
                        "ray termination: budget goes to VISIBLE samples)")
    parser.add_argument("--occ_keep_schedule", type=str, default=None,
                        help="annealed keep budget: 'STEP:FRAC,STEP:FRAC,...'"
                        " — from each STEP on, use FRAC (e.g. "
                        "'0:0.5,512:0.25,1024:0.125'); overrides "
                        "--occ_keep_fraction")
    parser.add_argument("--fast_merge", action="store_true",
                        help="sort-free hierarchical sampling: draw "
                        "importance samples pre-sorted (order-statistics "
                        "construction, identical multiset law) and "
                        "rank-merge with the stratified z's instead of "
                        "sorting the concatenation")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="N>1: data parallelism over N ranks (rays split, "
                        "params replicated, grads all-reduced; NCCL on the "
                        "cards, gloo with --device cpu); run_nerf spawns the "
                        "ranks unless torchrun started them; 0/1 = one device")
    parser.add_argument("--aabb_clip", action="store_true",
                        help="tighten per-ray [near,far] to the bbox "
                        "intersection before sampling (all samples land "
                        "in-scene; off = reference-exact z ranges)")
    parser.add_argument("--share_fine", action="store_true",
                        help="single network for coarse+fine passes "
                        "(Instant-NGP style; halves params, both passes "
                        "train the same field)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="optimizer steps a launch: >1 runs blocks of "
                        "this many steps, replayed from CUDA graphs on a GPU "
                        "with no host sync inside a block (eagerly on the "
                        "CPU); amortizes the host's launch time")
    parser.add_argument("--packed_layout", action="store_true",
                        help="corner-packed table layout (ops/packed_grid.py):"
                        " dense direct-indexed coarse levels + block-hashed "
                        "fine levels — ONE row fetch per (sample, level) "
                        "instead of 8 (8x fewer gather fetches; off = "
                        "reference-exact per-corner hashing)")
    parser.add_argument("--log2_blocks", type=int, default=-1,
                        help="packed fine-level block rows per level "
                        "(-1 = auto: log2_hashmap_size - 3)")
    parser.add_argument("--preset", type=str, default=None,
                        choices=("tpu-fast", "tpu-quality"),
                        help="named flag bundle of the opt-in execution set "
                        "(PRESETS); a config file and the command line "
                        "override it")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: cuda; the "
                        "entry point raises when no GPU is present)")
    return parser


def check_supported(args) -> None:
    """Raise NotImplementedError for any flag selecting a feature the port
    does not have yet, naming its ROADMAP row."""
    def no(what: str, row: str):
        raise NotImplementedError(
            f"hashnerf_torch: {what} is not ported yet (ROADMAP {row})"
        )

    if args.dataset_type == "st3d":
        from hashnerf_torch.data.st3d import cv2_or_none, needs_exr

        if needs_exr(args.datadir) and cv2_or_none() is None:
            no("reading an mp3d set's depth.exr without cv2", "A6")


# The JAX package's named bundles of the opt-in execution set, copied from
# hashnerf_tpu/train/config.py:235-269 (the measurements behind each are
# the JAX package's, on a TPU).
# tpu-fast, the flagship: L4/F8 packed tables, one shared net, bf16 MLPs,
# bbox clip, block-8 global occupancy culling with a coarse budget of 0.375
# and a fine one annealed 0.5 -> 0.25 at step 512 -> 0.125 at 1024,
# adaptive grid updates, 16 steps a launch.
# tpu-quality: L8/F4 packed, occupancy culling at keep 0.5 (per point).
PRESETS = {
    "tpu-fast": [
        "--n_levels", "4",
        "--n_features_per_level", "8",
        "--compute_dtype", "bfloat16",
        "--use_occupancy",
        "--occ_keep_fraction", "0.125",
        "--occ_keep_coarse", "0.375",
        "--occ_keep_schedule", "0:0.5,512:0.25,1024:0.125",
        "--occ_block", "8",
        "--occ_adaptive_update",
        "--share_fine",
        "--aabb_clip",
        "--packed_layout",
        "--steps_per_dispatch", "16",
    ],
    "tpu-quality": [
        "--n_levels", "8",
        "--n_features_per_level", "4",
        "--compute_dtype", "bfloat16",
        "--use_occupancy",
        "--occ_keep_fraction", "0.5",
        "--share_fine",
        "--packed_layout",
        "--steps_per_dispatch", "16",
    ],
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Two-phase parse: pull --preset and --config, splice the preset's
    tokens, then the config file's, before the CLI args (the CLI overrides
    the config, which overrides the preset: configargparse precedence)."""
    parser = config_parser()
    pre, _ = parser.parse_known_args(argv)
    tokens: List[str] = []
    if pre.preset:
        tokens += PRESETS[pre.preset]
    if pre.config:
        tokens += _parse_config_file(pre.config)
    if not tokens:
        return parser.parse_args(argv)
    import sys

    base = list(argv) if argv is not None else sys.argv[1:]
    return parser.parse_args(tokens + base)


def create_expname(args) -> str:
    """Encode hyperparams into the experiment name (reference util.py:61-78)."""
    expname = args.expname
    if args.i_embed == 1:
        expname += "_hashXYZ"
    elif args.i_embed == 0:
        expname += "_posXYZ"
    if args.i_embed_views == 2:
        expname += "_sphereVIEW"
    elif args.i_embed_views == 0:
        expname += "_posVIEW"
    expname += "_fine" + str(args.finest_res) + "_log2T" + str(args.log2_hashmap_size)
    expname += "_lr" + str(args.lrate) + "_decay" + str(args.lrate_decay)
    expname += "_RAdam"
    if args.sparse_loss_weight > 0:
        expname += "_sparse" + str(args.sparse_loss_weight)
    expname += "_TV" + str(args.tv_loss_weight)
    return expname

"""Split the train step's time into its parts, on the card.

Counterpart of hashnerf_tpu/tools/profile_step.py, at its shapes (1024 rays,
64 + 128 samples, finest_res 512, log2 T 19, lr 0.01, decay 10, on the
procedural 128 x 128 scene, steps from 1001: TV off). The default mode is
JAX's: L 8, F 4 per-corner table, share_fine, bf16 MLPs, occupancy culling
at keep 0.25 with warmup 8 (32 steps fill the grid first); --parity is the
reference-exact chair step (L 16, F 2, float32, a fine net, no culling).
Seven readings, each the median over `reps` CUDA-event timings after
`warmup` calls (a 256 MB buffer overwritten before each, so the L2 starts
cold, as chip_smoke.py::cuda_ms does):

  fwd         render_rays of one batch under no_grad (coarse + fine)
  loss_grad   the loss and its backward (JAX's value_and_grad), no update
  opt         RAdam's step alone, on gradients computed once
  step        Trainer.step (forward, backward, RAdam; a grid update every
              16 steps under culling)
  encode_fwd  K2 alone (kernels/hash_encode.py::hash_encode_fwd) at the
              fine pass's point count: 196,608, or its culled share
              ceil(196,608 * keep / 128) * 128 (49,152 at keep 0.25)
  encode_bwd  K6 alone (hash_encode_bwd) at the same points
  scan48      ms a step of run_steps(96, block_size=48) by the host clock
              closed by a synchronize (the plan's blocks as CUDA-graph
              replays); the first run_steps(48) captures and is not timed

Runs on the card unless --device names another; --json-out is required.

    python -m hashnerf_torch.tools.profile_step --json-out OUT.json [--parity]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

READINGS = ("fwd", "loss_grad", "opt", "step", "encode_fwd", "encode_bwd", "scan48")


def profile_args(parity: bool, device: str):
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
    if not parity:
        args.n_levels = 8
        args.n_features_per_level = 4
        args.share_fine = True
        args.compute_dtype = "bfloat16"
        args.use_occupancy = True
        args.occ_keep_fraction = 0.25
        args.occ_warmup = 8
    return args


class Timer:
    """Median ms of fn() over reps after warmup calls: CUDA events around
    each call on the card (the L2 overwritten before it), the host clock
    on the CPU."""

    def __init__(self, device: torch.device, reps: int = 10, warmup: int = 2):
        self.device, self.reps, self.warmup = device, reps, warmup
        self.flush = (torch.empty(64 << 20, dtype=torch.float32, device=device)
                      if device.type == "cuda" else None)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        ts = []
        if self.flush is None:
            for _ in range(self.reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)
        torch.cuda.synchronize(self.device)
        for _ in range(self.reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            self.flush.zero_()
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def run(parity: bool = False, device=None, reps: int = 10, warmup: int = 2,
        scene_hw: int = 128, overrides=None) -> dict:
    """The seven readings (ms) and their setting. overrides: args
    attributes set after the mode's (tests shrink the widths with them)."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.kernels.hash_encode import hash_encode_bwd, hash_encode_fwd
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import render_rays
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    dev = resolve_device(device)
    args = profile_args(parity, str(dev))
    for k, v in (overrides or {}).items():
        setattr(args, k, v)
    scene = make_synthetic_scene(H=scene_hw, W=scene_hw, n_train=8, n_test=2)
    trainer = Trainer(args, scene, device=dev)
    trainer.global_step = 1001  # steady state: TV off
    timer = Timer(dev, reps, warmup)

    batch = trainer.sample_image(0, args.N_rand, False)
    d = batch["rays_d"]
    batch["viewdirs"] = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    occ_grid = None
    if trainer.render_cfg.occupancy is not None:
        float(trainer.run_steps(32, block_size=16)["loss"])
        trainer._occ_ready = True
        occ_grid = trainer.occ_grid

    state, cfg, bbox, gen = trainer.state, trainer.render_cfg, trainer.bbox, trainer.generator
    out = {}

    def fwd():
        with torch.no_grad():
            return render_rays(state, query_fn, batch["rays_o"], batch["rays_d"],
                               batch["viewdirs"], batch["near"], batch["far"], bbox, cfg,
                               generator=gen, occ_grid=occ_grid)["rgb_map"]

    out["fwd"] = timer(fwd)

    loss_fn = make_loss_fn(args, cfg, bbox, trainer.model_cfg, with_tv=False, hwf=scene.hwf)

    def loss_grad():
        state.zero_grad(set_to_none=True)
        loss, _ = loss_fn(state, batch, 0.0, None, gen, occ_grid=occ_grid)
        loss.backward()
        return loss

    out["loss_grad"] = timer(loss_grad)
    loss_grad()  # the gradients opt steps on
    out["opt"] = timer(trainer.optimizer.step)
    out["step"] = timer(lambda: trainer.step(batch))

    # K2 and K6 alone, at the fine pass's (culled) point count
    n_pts = args.N_rand * (args.N_samples + args.N_importance)
    if occ_grid is not None:
        n_pts = -(-int(n_pts * args.occ_keep_fraction) // 128) * 128
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    pts = torch.rand((n_pts, 3), generator=g, device=dev) * 2.4 - 1.2
    table, res = state.hash_table.detach(), state.resolutions
    bmin, bmax = bbox[0].contiguous(), bbox[1].contiguous()
    feats = hash_encode_fwd(table, pts, bmin, bmax, res)[0]
    ones = torch.ones_like(feats)
    out["encode_fwd"] = timer(lambda: hash_encode_fwd(table, pts, bmin, bmax, res))
    out["encode_bwd"] = timer(lambda: hash_encode_bwd(pts, bmin, bmax, res, ones,
                                                      table.shape[1]))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    float(trainer.run_steps(48, block_size=48)["loss"])
    sync()
    t0 = time.perf_counter()
    float(trainer.run_steps(96, block_size=48)["loss"])
    sync()
    out["scan48"] = (time.perf_counter() - t0) * 1e3 / 96

    L, T, F = table.shape
    return {"mode": "parity" if parity else "default", "readings_ms": out,
            "encode_points": n_pts, "table": [L, T, F], "bbox": bbox.tolist(),
            "N_rand": args.N_rand,
            "samples": [args.N_samples, args.N_importance], "reps": reps, "warmup": warmup,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", required=True, help="the readings' JSON file")
    ap.add_argument("--parity", action="store_true",
                    help="the reference-exact chair step in place of the default mode")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    a = ap.parse_args(argv)
    rec = run(a.parity, a.device, a.reps)
    for k in READINGS:
        print(f"{k:10s} {rec['readings_ms'][k]:10.4f} ms", flush=True)
    with open(a.json_out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()

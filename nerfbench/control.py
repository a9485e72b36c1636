"""The readings the limits of `correct` are set from, on the card, at each
cell's own sizes.

    python3 -m nerfbench.control --config chair --seeds 11 12 13 --out readings.jsonl

For each seed one process builds the configuration's trainer and sets it up
as a run does (three start steps, then train_loop's spans to the traffic's
set-up step), then reads, by the numbers of harness.py:

  * program: the program against the reference (the lower readings): the
    start phase, three steps at the trained state through run_steps, and
    the frames of `check_frames` spiral poses drawn from the seed;
  * control: the reference in the configuration's next lower precision put
    in the program's place (float32 -> TF32; bfloat16 operands -> float8
    e4m3 operands), against the reference (the upper readings);
  * half_batch: the reference with each image loss over half the rays (a
    planted fault), against the reference.

The reference is the configuration's family's (families/<family>.py).

One JSON line a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import sys

import numpy as np
import torch

from nerfbench import harness as H
from nerfbench import spec


@contextlib.contextmanager
def tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def control_dtype(s: dict):
    """(operand type, TF32 on) of the next lower precision than the
    configuration's: TF32 for float32, float8 e4m3 for bfloat16."""
    cd = s.get("compute_dtype") or "float32"
    if cd == "float32":
        return None, True
    return torch.float8_e4m3fn, False


def side(r, snaps: dict, poses, sc: dict, check_steps: int, chunk: int) -> dict:
    """One side's readings: start phase, trained phase, frames."""
    out = {"start": H.reference_phase(r, snaps["start"], check_steps, precrop=True),
           "trained": H.reference_phase(r, snaps["trained"], check_steps, precrop=False)}
    out["frames"] = [r.render_frame(snaps["weights"], torch.as_tensor(
        np.asarray(p)[:3, :4], dtype=torch.float32, device=r.device), sc["H"], sc["W"],
        chunk).cpu().numpy() for p in poses]
    return out


def numbers(got: dict, want: dict) -> dict:
    out = H.phase_numbers("start", got["start"], want["start"])
    out.update(H.phase_numbers("trained", got["trained"], want["trained"]))
    out.update(H.frame_numbers(got["frames"], want["frames"]))
    return out


def read_seed(cfg: dict, tr: dict, seed: int, device: str, check_frames: int = 2,
              chunk: int = 16384) -> dict:
    s = cfg["settings"]
    n = tr.get("check_steps", 3)
    trainer, sc, init, fam, pool = H.build(cfg, seed, device)
    leaves = fam.program_leaves(trainer)
    snaps = {"start": H.initial_snapshot(trainer, init, fam, pool, n)}
    prog = {"start": H.program_phase(trainer, leaves, snaps["start"], n, precrop=True, pool=pool)}
    H.drive(trainer, tr["setup_steps"], s, pool)
    snaps["trained"] = H.snapshot(trainer, leaves, fam, pool, n)
    prog["trained"] = H.program_phase(trainer, leaves, snaps["trained"], n, precrop=False,
                                      pool=pool)
    # the frames are rendered at the trained state the trained phase started from
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(snaps["trained"]["p"][name])
    picks = sorted(random.Random(seed + 2).sample(range(len(sc["render_poses"])), check_frames))
    poses = [sc["render_poses"][i] for i in picks]
    prog["frames"] = [trainer.render_image(p)[0].cpu().numpy() for p in poses]
    snaps["weights"] = snaps["trained"]["p"]
    del trainer, leaves, pool
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    want = side(fam.Reference(s, sc, device), snaps, poses, sc, n, chunk)
    dtype, use_tf32 = control_dtype(s)
    with tf32(use_tf32):
        ctrl = side(fam.Reference(s, sc, device, dtype=dtype), snaps, poses, sc, n, chunk)
    half_r = fam.Reference(s, sc, device, half_batch=True)
    half = {"start": H.reference_phase(half_r, snaps["start"], n, precrop=True),
            "trained": H.reference_phase(half_r, snaps["trained"], n, precrop=False),
            "frames": want["frames"]}
    return {"seed": seed, "program": numbers(prog, want), "control": numbers(ctrl, want),
            "half_batch": numbers(half, want)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nerfbench.control")
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="train_steady")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("nerfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cfg, tr = spec.config(a.config), spec.traffic(a.traffic)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    for seed in a.seeds:
        rec = read_seed(cfg, tr, seed, "cuda")
        rec["config"] = a.config
        with open(a.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

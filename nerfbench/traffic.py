"""The general generator: the drivers of the traffic kinds, which a mix's
data file parameterizes (traffic/<name>.json, `kind` picks the driver).

  * "train": train_loop's steady state under --steps_per_dispatch. Each
    span runs to the next `i_print` event in one Trainer.run_steps call
    (blocks of steps_per_dispatch steps, replayed CUDA graphs), and is
    closed by the loop's host read of the loss. A configuration that
    trains from a ray pool (pool.py) ends a span also at the pool's end,
    with no read there, and reshuffles the pool before the next; the
    window's last span is read wherever it ends. No checkpoint, video or
    test-set event. Parameters: setup_steps (the global step the window
    starts at, a multiple of i_print), trace_warm / trace_units (spans of
    a traced run's untraced and traced slices), check_steps.
  * "render": whole frames of the scene's spiral of render poses, in turn,
    through Trainer.render_image, each copied to the host as render_path
    copies it; closed loop, one viewer waiting for each frame. Parameters:
    setup_steps, trace_warm / trace_units (frames), check_frames,
    reference_chunk.

A window measures for `seconds` and ends with the unit (span or frame)
that passes them; rates are over all its work and all its time, and the
frame tail over every frame.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def rate(units: int, rays_per_unit: int, seconds: float) -> float:
    return units * rays_per_unit / seconds


def percentile(times: List[float], q: float) -> float:
    """Nearest-rank q-th percentile of every sample."""
    t = sorted(times)
    return t[max(0, math.ceil(q / 100.0 * len(t)) - 1)]


def _read_loss(m: dict) -> bool:
    """The loop's host read of a span's last loss: whether it is finite."""
    with record_function("nb.loss_read"):
        return math.isfinite(float(m["loss"]))


class TrainDriver:
    def __init__(self, trainer, tr: dict, s: dict, sc: dict, device: str, pool=None):
        """pool: the pool.PoolCursor the configuration trains from, or None."""
        self.trainer, self.tr, self.s, self.device, self.pool = trainer, tr, s, device, pool
        if tr["setup_steps"] % s["i_print"] or tr["setup_steps"] < s["precrop_iters"]:
            raise ValueError("nerfbench: a train mix starts past the precrop, on an i_print event")

    def warm_up(self) -> None:
        """Set-up trained through the window's own span, blocks and graphs."""

    def window(self, seconds: Optional[float] = None, units: Optional[int] = None) -> dict:
        t, s, pool = self.trainer, self.s, self.pool
        steps = failed = spans = unread = 0
        enqueue = 0.0
        ends = []
        t0 = time.perf_counter()
        while True:
            i = t.global_step + 1
            if pool is None:
                e = ((i - 1) // s["i_print"] + 1) * s["i_print"]
            else:
                e = pool.span_end(i, s["i_print"])
            ts = time.perf_counter()
            with record_function("nb.block_replay"):
                if pool is None:
                    m = t.run_steps(e - i + 1, block_size=s["steps_per_dispatch"])
                else:
                    m = pool.run(e - i + 1, s["steps_per_dispatch"])
            enqueue += time.perf_counter() - ts
            unread += e - i + 1
            if e % s["i_print"] == 0:
                if not _read_loss(m):
                    failed += unread
                unread = 0
            steps += e - i + 1
            spans += 1
            ends.append((time.perf_counter() - t0, steps))
            if (units is not None and spans >= units) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        if unread and not _read_loss(m):
            failed += unread
        _sync(self.device)
        return {"units": steps, "failed": failed, "seconds": time.perf_counter() - t0,
                "enqueue_s": enqueue, "ends": ends}


class RenderDriver:
    def __init__(self, trainer, tr: dict, s: dict, sc: dict, device: str, pool=None):
        """pool: the ray pool set-up trained from; frames take none."""
        self.trainer = trainer
        self.poses = sc["render_poses"]
        self.k = 0

    def _frame(self):
        with record_function("nb.render_frame"):
            rgb, depth, _, _ = self.trainer.render_image(self.poses[self.k % len(self.poses)])
        with record_function("nb.host_copy"):
            out = rgb.cpu().numpy(), depth.cpu().numpy()
        self.k += 1
        return out

    def warm_up(self) -> None:
        self._frame()
        self.k = 0

    def window(self, seconds: Optional[float] = None, units: Optional[int] = None) -> dict:
        times, frames, failed = [], [], 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            pose = self.k % len(self.poses)
            rgb, _ = self._frame()
            times.append(time.perf_counter() - ts)
            frames.append((pose, rgb))
            if not np.isfinite(rgb).all():
                failed += 1
            if (units is not None and len(times) >= units) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        return {"units": len(times), "failed": failed, "seconds": time.perf_counter() - t0,
                "times": times, "frames": frames}


DRIVERS = {"train": TrainDriver, "render": RenderDriver}


def merge(a: dict, b: dict) -> dict:
    """Two slices of one run as one: units, failures, seconds, frames."""
    out = {"units": a["units"] + b["units"], "failed": a["failed"] + b["failed"],
           "seconds": a["seconds"] + b["seconds"]}
    if "frames" in a:
        out["frames"] = a["frames"] + b["frames"]
        out["times"] = a["times"] + b["times"]
    return out


def end_to_end(kind: str, win: dict, s: dict, hw=None) -> Dict[str, dict]:
    if kind == "train":
        return {"train_rays_per_s": {"value": rate(win["units"], s["N_rand"], win["seconds"]),
                                     "unit": "rays/s"}}
    H, W = hw
    return {"render_rays_per_s": {"value": rate(win["units"], H * W, win["seconds"]),
                                  "unit": "rays/s"},
            "render_frame_ms_p90": {"value": 1e3 * percentile(win["times"], 90), "unit": "ms"}}

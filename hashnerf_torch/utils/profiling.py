"""Tracing and profiling: torch.profiler traces and per-step wall clocks.

Counterpart of hashnerf_tpu/utils/profiling.py: `device_trace` writes a
torch.profiler trace (CPU activity, and CUDA kernels on a GPU host) of the
code inside it to a directory, as a Chrome trace JSON that
chrome://tracing, Perfetto or TensorBoard's profiler plugin read;
`annotate` names a region in it; `StepTimer` (the JAX package's, pure
Python) keeps rolling step times, whose history feeds loss_vs_time.pkl.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace everything inside the block into logdir/trace_<pid>.json (CUDA
    activity too when a GPU is present)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling per-step wall times + simple rates."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        self._last = now
        if dt > 0:
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def rays_per_s(self, n_rays: int) -> float:
        m = self.mean_step_s
        return n_rays / m if m > 0 else 0.0

    def summary(self, n_rays: int) -> Dict[str, float]:
        return {
            "mean_step_s": self.mean_step_s,
            "rays_per_s": self.rays_per_s(n_rays),
        }

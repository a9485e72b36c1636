"""Tracing: named spans, the program's counters, and a trace exporter.

  * `annotate(name)`: a span, a torch.profiler `record_function` range
    while a profiler records, else a shared null context after one flag
    check. Every span of the port is named `hn.*`. A CUDA graph's capture
    runs under no profiler and its replays run no Python, so spans inside a
    captured function cost nothing on replay.
  * Counts: plain integers in one store, raised on the host where the work
    is asked for: the program's counters (see COUNTERS) and each kernel's
    launches, registered by kernels/launch.py::Kernel. kernels.launch_counts
    reads them all, and a CUDA graph's replay adds what its capture counted
    (train/graphs.py).
  * `device_trace(logdir)`: a torch.profiler trace (CPU activity, and CUDA
    kernels on a GPU host) of the code inside it, written to a directory as
    a Chrome trace JSON that chrome://tracing, Perfetto or TensorBoard's
    profiler plugin read.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

COUNTERS = {
    "steps_eager": "Trainer.step's eager steps",
    "steps_replayed": "steps run in run_steps' blocks (a step graph's replay on a GPU)",
    "grid_updates": "occupancy-grid updates, eager or replayed",
    "graph_captures": "CUDA graphs captured",
    "host_reads": "the program's own blocking reads of a device value",
    "views_per_ray": "query_fn calls that encoded their view directions once a ray",
    "mlp_points": "points query_fn handed an MLP (R x S a call)",
    "mlp_fused_points": "points NeRFSmall's one-kernel forward answered (no gradient)",
}
# every count: COUNTERS, then each registered kernel's launches
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
_NULL = contextlib.nullcontext()


def annotate(name: str):
    """A named span of the profiler's timeline, or a null context when no
    profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def register(name: str) -> None:
    """A new count, at 0: a kernel's launches."""
    if name in _counts:
        raise ValueError(f"{name} is counted already")
    _counts[name] = 0


def counts() -> Dict[str, int]:
    """Every count: the program's counters and each kernel's launches."""
    return dict(_counts)


def counters() -> Dict[str, int]:
    """The program's counters (COUNTERS) alone."""
    return {name: _counts[name] for name in COUNTERS}


def reset_counters() -> None:
    for name in _counts:
        _counts[name] = 0


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

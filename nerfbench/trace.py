"""The reduction of a torch.profiler trace to the benchmark's numbers.

A traced slice runs inside one host span, `nb.window`; the benchmark's own
host spans (`nb.*`, record_function ranges around its calls into the
program) label what the host did. From the device events (kernels, copies,
fills; not the annotations mirrored onto the device timeline):

  * busy_s: the union of device intervals inside the window;
  * window_s: the window span's length;
  * ops: device seconds by name;
  * idle: the window's idle gaps, by the innermost benchmark span that
    holds each gap's middle (or "no span").

The arithmetic is chip_smoke.py's profile_steps' (device-side events only,
so ranges that span their kernels are not counted twice), with a union in
place of a sum so that overlapping kernels are not counted twice either.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

WINDOW = "nb.window"


def _events(prof):
    from torch.autograd import DeviceType

    dev, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        a, b = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and b > a:
                dev.append((a, b, ev.name()))
        elif ev.is_user_annotation() and ev.name().startswith("nb."):
            spans.append((a, b, ev.name()))
    return dev, spans


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize_events(dev, spans) -> Dict[str, object]:
    """dev: device (start_ns, end_ns, name); spans: host (start_ns, end_ns,
    name), one of them WINDOW."""
    windows = [(a, b) for a, b, n in spans if n == WINDOW]
    if not windows:
        raise ValueError("trace: no nb.window span")
    w0, w1 = windows[0]
    ops: Dict[str, float] = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
    busy = union(clipped)
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    inner = sorted((a, b, n) for a, b, n in spans if n != WINDOW)
    starts = [a for a, _, _ in inner]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label, best = "no span", None
        for s0, s1, n in inner[:bisect.bisect_right(starts, mid)]:
            if s0 <= mid <= s1 and (best is None or s1 - s0 < best):
                label, best = n, s1 - s0
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "ops": ops, "idle": idle}


def summarize(prof) -> Dict[str, object]:
    return summarize_events(*_events(prof))


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def seconds_matching(ops: Dict[str, float], patterns) -> float:
    """Device seconds of the ops whose name holds any of the patterns
    (case-insensitive)."""
    pats = [p.lower() for p in patterns]
    return sum(v for k, v in ops.items() if any(p in k.lower() for p in pats))

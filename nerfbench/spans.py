"""The program's spans in a torch.profiler trace: where the card's time and
its idle gaps go, by the trainer's or renderer's phase.

hashnerf_torch opens `hn.*` ranges (hashnerf_torch/utils/profiling.py)
while a profiler records; trace.py keeps only the benchmark's own `nb.*`
ranges. This reduction keeps both and adds, over the `nb.window` span:

  * spans: count and host seconds of each `hn.*` name;
  * device_by_span: each device interval (clipped to the window, as
    trace.py's ops) put down to the innermost `hn.*` span open at its
    launch, or "no span"; device_by_span_op splits each span's by op. The
    launch is the runtime call (a kernel launch, a graph launch, a copy or
    fill) with the device event's correlation id (a graph's kernels carry
    its launch's); its span is looked for on the launching thread first,
    else on the other threads (autograd's backward launches from a thread
    of its own while the caller waits in `hn.backward`);
  * idle: trace.py's idle gaps, each labelled by the innermost `nb.*` or
    `hn.*` span holding its middle;
  * busy_s, window_s, ops: trace.py's, from the same events.

`span_metrics` reads four per-layer numbers from it. The benchmark's
harness does not call this module yet (its trace keeps `nb.*` ranges
alone); `python3 -m nerfbench.spans --workload <cell> --seed <n>` runs a
cell's set-up and a traced slice as the harness does and prints the
reduction as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from nerfbench import trace as tracem

PROGRAM = "hn."
NO_SPAN = "no span"
# the CUDA runtime's and driver's calls (cudaLaunchKernel, cudaGraphLaunch,
# cudaMemcpyAsync, cuLaunchKernel, ...); torch's operators are named aten::*
RUNTIME = "cu"
# the renderer's and the query's own work: a frame's spans but the encode's
# and the MLP's
RENDERER = ("hn.render", "hn.render.chunk", "hn.render.gather", "hn.march.coarse",
            "hn.march.fine", "hn.sample_pdf", "hn.cull", "hn.composite", "hn.query")


def events(prof):
    """(dev, spans, launches) of a finished profile: device events (start,
    end, name, correlation id); host ranges named `nb.*` or `hn.*` (start,
    end, name, thread); runtime calls {correlation id: (start, thread)}."""
    from torch.autograd import DeviceType

    dev, spans, launches = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        a, b = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and b > a:
                dev.append((a, b, ev.name(), ev.correlation_id()))
        elif ev.is_user_annotation():
            if ev.name().startswith(("nb.", PROGRAM)):
                spans.append((a, b, ev.name(), ev.start_thread_id()))
        elif ev.name().startswith(RUNTIME):
            launches[ev.correlation_id()] = (a, ev.start_thread_id())
    return dev, spans, launches


def innermost(spans: List[tuple], points: List[Tuple[int, Optional[int]]]) -> List[Optional[int]]:
    """For each point (time, thread): the index into spans (start, end,
    name, thread) of the innermost span holding it, a span's ends included.
    A point with a thread takes that thread's innermost span, else the
    shortest innermost span of another thread; a point without one (None)
    the shortest innermost span of any thread. A thread's spans nest, so
    its innermost open span is its last opened."""
    ev = []
    for i, (a, b, _, _) in enumerate(spans):
        ev.append((a, 0, i))
        ev.append((b, 2, i))
    for j, (t, _) in enumerate(points):
        ev.append((t, 1, j))
    ev.sort()
    open_: Dict[int, List[int]] = {}
    out: List[Optional[int]] = [None] * len(points)
    for _, kind, k in ev:
        if kind == 0:
            open_.setdefault(spans[k][3], []).append(k)
        elif kind == 2:
            stack = open_[spans[k][3]]
            if stack[-1] == k:
                stack.pop()
            else:
                stack.remove(k)
        else:
            tid = points[k][1]
            own = open_.get(tid) if tid is not None else None
            if own:
                out[k] = own[-1]
                continue
            tops = [s[-1] for t, s in open_.items() if s and t != tid]
            if tops:
                out[k] = min(tops, key=lambda i: spans[i][1] - spans[i][0])
    return out


def summarize_events(dev, spans, launches) -> Dict[str, object]:
    """dev: (start_ns, end_ns, name, correlation); spans: (start_ns,
    end_ns, name, thread), one of them trace.WINDOW; launches:
    {correlation: (start_ns, thread)}."""
    base = tracem.summarize_events([d[:3] for d in dev],
                                   [s[:3] for s in spans if not s[2].startswith(PROGRAM)])
    w0, w1 = [(a, b) for a, b, n, _ in spans if n == tracem.WINDOW][0]
    program = [s for s in spans if s[2].startswith(PROGRAM)]
    labels = [s for s in spans if s[2] != tracem.WINDOW]

    launched, points = [], []
    for a, b, op, corr in dev:
        d = min(b, w1) - max(a, w0)
        if d > 0:
            launched.append((d, op, corr in launches))
            points.append(launches.get(corr, (0, None)))
    by_span: Dict[str, float] = {}
    by_op: Dict[str, Dict[str, float]] = {}
    unlaunched = 0.0
    for (d, op, found), i in zip(launched, innermost(program, points)):
        name = program[i][2] if found and i is not None else NO_SPAN
        unlaunched += 0.0 if found else d / 1e9
        by_span[name] = by_span.get(name, 0.0) + d / 1e9
        ops = by_op.setdefault(name, {})
        ops[op] = ops.get(op, 0.0) + d / 1e9

    busy = tracem.union([(max(a, w0), min(b, w1)) for a, b, _, _ in dev
                         if min(b, w1) > max(a, w0)])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, float] = {}
    for (a, b), i in zip(gaps, innermost(labels, [((a + b) // 2, None) for a, b in gaps])):
        name = NO_SPAN if i is None else labels[i][2]
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9

    counted: Dict[str, List[float]] = {}
    for a, b, n, _ in program:
        if a >= w0 and b <= w1:
            c = counted.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e9
    return {"busy_s": base["busy_s"], "window_s": base["window_s"], "ops": base["ops"],
            "idle": idle, "spans": counted, "device_by_span": by_span,
            "device_by_span_op": by_op, "unlaunched_s": unlaunched}


def span_metrics(summary: dict, counters: Dict[str, int], units: int,
                 kind: str) -> Dict[str, float]:
    """The per-layer numbers of the traced slice's spans and counters
    (`units` steps or frames); a number whose spans or counters are absent
    is left out."""
    by = summary["device_by_span"]
    spans = summary["spans"]
    out: Dict[str, float] = {}
    if kind == "train":
        eager = counters.get("steps_eager", 0)
        steps = eager + counters.get("steps_replayed", 0)
        if steps:
            out["eager_step_share.train"] = 100.0 * eager / steps
        if "hn.step" in spans:
            n, host_s = spans["hn.step"]
            out["eager_step_host_ms.train"] = 1e3 * host_s / n
        if eager and "hn.optimizer" in by:
            out["optimizer_ms_per_step.train"] = 1e3 * by["hn.optimizer"] / eager
        updates = counters.get("grid_updates", 0)
        update_s = by.get("hn.grid_update", 0.0) + by.get("hn.replay.update", 0.0)
        if updates and update_s:
            out["grid_update_ms.train"] = 1e3 * update_s / updates
    elif units:
        renderer_s = sum(by.get(n, 0.0) for n in RENDERER)
        if renderer_s:
            out["renderer_ms_per_frame.render"] = 1e3 * renderer_s / units
    return out


def run(cfg: dict, tr: dict, seed: int, device: str) -> dict:
    """One cell's set-up and a traced slice, as harness.run_cell makes them
    (no correctness check): the untraced and the traced slice's rates, the
    traced slice's counters, the reduction and span_metrics."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hashnerf_torch import kernels
    from nerfbench import harness, traffic as trafficm

    t0 = time.perf_counter()
    s = cfg["settings"]
    trainer, sc, _, _, pool = harness.build(cfg, seed, device)
    harness.drive(trainer, tr["setup_steps"], s, pool)
    driver = trafficm.DRIVERS[tr["kind"]](trainer, tr, s, sc, device, pool)
    driver.warm_up()
    harness.sync(device)
    setup_s = time.perf_counter() - t0
    untraced = driver.window(seconds=None, units=tr["trace_warm"])
    before = kernels.launch_counts()
    on_card = device.startswith("cuda")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function(tracem.WINDOW):
            traced = driver.window(seconds=None, units=tr["trace_units"])
            harness.sync(device)
    after = kernels.launch_counts()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    dev, spans, launches = events(prof)
    summary = summarize_events(dev, spans, launches)
    per_unit = s["N_rand"] if tr["kind"] == "train" else sc["H"] * sc["W"]
    return {
        "device": torch.cuda.get_device_name(0) if on_card else "cpu", "setup_s": setup_s,
        "rays_per_s": {"untraced": trafficm.rate(untraced["units"], per_unit, untraced["seconds"]),
                       "traced": trafficm.rate(traced["units"], per_unit, traced["seconds"])},
        "units": traced["units"], "counters": {k: v for k, v in counters.items() if v},
        "threads": {"spans": sorted({x[3] for x in spans}),
                    "launches": sorted({t for _, t in launches.values()})},
        "metrics": span_metrics(summary, counters, traced["units"], tr["kind"]),
        "summary": summary,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nerfbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None, help="write the whole result here as JSON")
    a = p.parse_args(argv)
    import torch

    from nerfbench import spec

    cell = spec.workload(spec.load_benchmark(), a.workload)
    if not torch.cuda.is_available():
        print("nerfbench.spans: no CUDA card", file=sys.stderr)
        return 2
    out = {"cell": a.workload, "seed": a.seed,
           **run(spec.config(cell["config"]), spec.traffic(cell["traffic"]), a.seed, "cuda")}
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f)
    s = out.pop("summary")
    idle_s = sum(s["idle"].values())
    out.update(busy_s=s["busy_s"], window_s=s["window_s"], ops_s=sum(s["ops"].values()),
               unlaunched_s=s["unlaunched_s"],
               device_by_span=tracem.top(s["device_by_span"], 20),
               device_by_span_op=tracem.top({f"{k} | {op}": v
                                             for k, ops in s["device_by_span_op"].items()
                                             for op, v in ops.items()}, 20),
               idle_share=[[k, v / idle_s] for k, v in tracem.top(s["idle"], 12)],
               spans=sorted(([k, *v] for k, v in s["spans"].items()), key=lambda r: -r[2])[:20])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the trace, and the
comparison with the plain reference that decides `correct`.

Set-up builds one hashnerf_torch Trainer from the configuration's argv on
the scene its kind makes (scenes/<kind>.py), loads the weights its model
family (families/<family>.py) made from the seed, builds the ray pool where
the argv leaves out --no_batching (pool.py), and drives its first three
steps through `Trainer.run_steps`, as the window calls it (the start
phase, which the reference follows). It then trains on in train_loop's
spans (a host read of the loss at each `i_print`) to the traffic's set-up
step, and warms up every shape the window uses. The window is traffic.py's.
After it, the program's state is read, the program is freed, and the
family's plain reference follows it.
"""
from __future__ import annotations

import gc
import math
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nerfbench import counts, spec
from nerfbench import pool as poolm
from nerfbench import trace as tracem
from nerfbench import traffic as trafficm


# --------------------------------------------------------------------------
# The program
# --------------------------------------------------------------------------
def program_args(cfg: dict, device: str):
    """The port's args for the configuration, held to its settings."""
    from hashnerf_torch.train.config import parse_args

    args = parse_args(list(cfg["argv"]) + ["--device", device])
    s = cfg["settings"]
    for k, v in s.items():
        if not hasattr(args, k):
            continue
        got = getattr(args, k)
        if k == "compute_dtype":
            got = got or "float32"
        same = math.isclose(got, v) if isinstance(v, float) else got == v
        if not same:
            raise ValueError(f"nerfbench: config {cfg['name']}: the port runs {k}={got!r}, "
                             f"the settings say {v!r}")
    return args


def build(cfg: dict, seed: int, device: str, base: str = spec.HERE):
    """(trainer, scene tensors, initial weights, family module, pool): the
    program's Trainer on the configuration's scene, with its family's
    weights made from the seed, and the ray pool it trains from (a
    pool.PoolCursor; None under --no_batching). A scene that gives a
    "pool" and no "images" makes an image-less Scene, as the port's
    st3d_scene does. The family is resolved here alone."""
    from hashnerf_torch.data.scene import Scene
    from hashnerf_torch.train.driver import Trainer

    fam = spec.family_of(cfg, base)
    args = program_args(cfg, device)
    kind = cfg["scene"].get("kind", "ring")
    sc = spec.scene_of(cfg, base).make_scene(cfg["scene"], device)
    if "images" not in sc and (args.no_batching or "pool" not in sc):
        has = '"pool" only' if "pool" in sc else 'neither "images" nor "pool"'
        raise ValueError(f"nerfbench: config {cfg['name']} trains from "
                         f"{'its images (--no_batching)' if args.no_batching else 'a ray pool'}; "
                         f"scene kind {kind!r} gives {has}")
    bbox = sc["bbox"].cpu().numpy()
    if "images" in sc:
        n = sc["images"].shape[0]
        images, poses = sc["images"].cpu().numpy(), sc["poses"].cpu().numpy()
    else:
        n = 0
        images = np.zeros((0, sc["H"], sc["W"], 3), np.float32)
        poses = np.zeros((0, 3, 4), np.float32)
    scene = Scene(images=images, poses=poses,
                  render_poses=sc.get("render_poses", np.zeros((0, 4, 4), np.float32)),
                  hwf=(sc["H"], sc["W"], sc.get("focal", 0.0)), K=sc.get("K_np", np.eye(3)),
                  i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0),
                  near=sc["near"], far=sc["far"], bounding_box=(bbox[0], bbox[1]),
                  ndc=sc.get("ndc", False))
    trainer = Trainer(args, scene, device=device, seed=seed + 1)
    init = fam.initial_weights(cfg["settings"], seed, device)
    leaves = fam.program_leaves(trainer)
    if set(leaves) != set(init):
        raise ValueError(f"nerfbench: the program's leaves {sorted(leaves)} are not the "
                         f"configuration's {sorted(init)}")
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(init[name])
    pool = None if args.no_batching else poolm.make_pool(trainer, sc, seed)
    return trainer, sc, init, fam, pool


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def drive(trainer, end: int, s: dict, pool: Optional[poolm.PoolCursor] = None) -> None:
    """Train to global step `end` as train_loop does under
    --steps_per_dispatch: spans to each i_print event (without ray batching,
    and to the end of the precrop; from a pool, and to its end), each one
    run_steps call, the loss read on the host at each i_print."""
    spd, ip, pc = s["steps_per_dispatch"], s["i_print"], s["precrop_iters"]
    i = trainer.global_step + 1
    while i <= end:
        if pool is None:
            e = min(end, ((i - 1) // ip + 1) * ip)
            precrop = i < pc
            if precrop:
                e = min(e, pc - 1)
            m = trainer.run_steps(e - i + 1, block_size=spd, precrop=precrop)
        else:
            e = min(end, pool.span_end(i, ip))
            m = pool.run(e - i + 1, spd)
        if e % ip == 0:
            float(m["loss"])
        i = e + 1


# --------------------------------------------------------------------------
# Phases of three steps, the program's and the reference's
# --------------------------------------------------------------------------
def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def pool_record(pool: Optional[poolm.PoolCursor], n: int) -> dict:
    """{"pool": where the rows of the next n steps stand}, or {} without a
    pool. Taken before the generator's state: it may reshuffle."""
    return {} if pool is None else {"pool": pool.record(n)}


def snapshot(trainer, leaves, fam, pool: Optional[poolm.PoolCursor] = None,
             n_check: int = 0) -> dict:
    """What the reference needs to follow the program from here: weights,
    the optimizer's moments, its beta1 and the step count of each of the
    family's groups, the occupancy grid if it culls, the generator's state,
    the global step, and from a pool, where the n_check steps' rows stand."""
    pool_at = pool_record(pool, n_check)
    opt = trainer.optimizer
    opt.init_state()
    st = {p: opt.state[p] for p in leaves.values()}
    first = {g: names[0] for g, names in fam.step_groups(list(leaves)).items()}
    occ = trainer.render_cfg.occupancy
    culled = (occ is not None and trainer._occ_ready and trainer.global_step >= occ.warmup_steps)
    return {
        "p": {n: p.detach().clone() for n, p in leaves.items()},
        "m": {n: st[p]["exp_avg"].clone() for n, p in leaves.items()},
        "v": {n: st[p]["exp_avg_sq"].clone() for n, p in leaves.items()},
        "step": {g: st[leaves[n]]["step"].clone() for g, n in first.items()}, "b1": fam.BETA1,
        "occ_grid": trainer.occ_grid.clone() if culled else None,
        "gen_state": trainer.generator.get_state(),
        "step0": trainer.global_step,
        **pool_at,
    }


def initial_snapshot(trainer, init: Dict[str, torch.Tensor], fam,
                     pool: Optional[poolm.PoolCursor] = None, n_check: int = 0) -> dict:
    """The start: the benchmark's weights, the optimizer's zero state,
    step 0, and from a pool, where the n_check steps' rows stand."""
    pool_at = pool_record(pool, n_check)
    z = {n: torch.zeros_like(t) for n, t in init.items()}
    dev = next(iter(init.values())).device
    return {"p": init, "m": z, "v": {n: t.clone() for n, t in z.items()},
            "step": {g: torch.zeros((), dtype=torch.float32, device=dev)
                     for g in fam.step_groups(list(init))}, "b1": fam.BETA1,
            "occ_grid": None, "gen_state": trainer.generator.get_state(), "step0": 0, **pool_at}


def ends(losses: List[float]) -> List[float]:
    """The first loss and the last: what a pool phase reads."""
    return losses[:1] + losses[1:][-1:]


def program_phase(trainer, leaves, snap: dict, n: int, precrop: bool,
                  pool: Optional[poolm.PoolCursor] = None) -> dict:
    """n steps through Trainer.run_steps, one a call; the losses, the first
    gradient's norm by leaf as the optimizer's first moment tells it, and
    each leaf's change after the n. From a pool (no precrop): the first step
    alone, then the other n - 1 in one call, so that the pool's device
    offset advances inside a block as in the window; the losses are the
    first step's and the last's."""
    spd = trainer.args.steps_per_dispatch
    opt = trainer.optimizer
    b1 = snap["b1"]
    calls = [1] * n if pool is None else [1] + ([n - 1] if n > 1 else [])
    losses, grad = [], None
    for k, c in enumerate(calls):
        if pool is None:
            m = trainer.run_steps(c, block_size=spd, precrop=precrop)
        else:
            m = pool.run(c, spd)
        losses.append(float(m["loss"]))
        if k == 0:
            grad = _norms({name: (opt.state[p]["exp_avg"].double() - b1 * snap["m"][name].double())
                           / (1 - b1) for name, p in leaves.items()})
    moved = _norms({name: p.detach() - snap["p"][name] for name, p in leaves.items()})
    return {"losses": losses, "grad": grad, "moved": moved}


def reference_phase(r, snap: dict, n: int, precrop: bool) -> dict:
    """The reference's n steps from the snapshot, read as program_phase;
    from a pool, on the rows its record names, made from the scene."""
    b1 = snap["b1"]
    rows = None
    if "pool" in snap:
        rows = r.pool_rows(poolm.source_ids(snap["pool"], r.device))
    N = r.s["N_rand"]
    p = {k: v.clone() for k, v in snap["p"].items()}
    st = {"m": {k: v.clone() for k, v in snap["m"].items()},
          "v": {k: v.clone() for k, v in snap["v"].items()},
          "step": {k: v.clone() for k, v in snap["step"].items()}}
    gen = torch.Generator(device=r.device)
    gen.set_state(snap["gen_state"])
    losses, grad = [], None
    for k in range(n):
        step_rows = None if rows is None else {c: v[k * N:(k + 1) * N] for c, v in rows.items()}
        loss, _ = r.train_steps(p, st, gen, snap["step0"] + k, 1, precrop, snap["occ_grid"],
                                rows=step_rows)
        losses += loss
        if k == 0:
            grad = _norms({name: (st["m"][name].double() - b1 * snap["m"][name].double()) / (1 - b1)
                           for name in p})
    moved = _norms({name: p[name] - snap["p"][name] for name in p})
    return {"losses": losses if rows is None else ends(losses), "grad": grad, "moved": moved}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], names: List[str]) -> float:
    """max over leaves of |got - want| over the larger of want and the
    median leaf's want (some leaves' norms are all but zero)."""
    if not names:
        return 0.0
    med = statistics.median(want[n] for n in names)
    gaps = []
    for n in names:
        den = max(want[n], med)
        gaps.append(abs(got[n] - want[n]) / den if den > 0 else abs(got[n] - want[n]))
    return max(gaps)


def phase_numbers(tag: str, got: dict, want: dict) -> Dict[str, float]:
    """loss.<tag>: the largest relative gap of the n losses; grad.<tag>:
    the first gradient's norm gap by the worst leaf; move.<tag>: the change
    after the n steps by the worst leaf, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (the others
    move by rounding alone). Where the reference moves nothing (RAdam's
    first five steps), move.<tag> is the largest absolute gap, held to 0."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    names = list(want["grad"])
    grad = worst_leaf_gap(got["grad"], want["grad"], names)
    med_g = statistics.median(want["grad"].values())
    live = [n for n in names if want["grad"][n] >= 1e-3 * med_g]
    if max(want["moved"].values()) == 0.0:
        move = max(abs(got["moved"][n] - want["moved"][n]) for n in names)
    else:
        move = worst_leaf_gap(got["moved"], want["moved"], live)
    return {f"loss.{tag}": loss, f"grad.{tag}": grad, f"move.{tag}": move}


def frame_numbers(got: List[np.ndarray], want: List[np.ndarray]) -> Dict[str, float]:
    """rgb_mean_gap and rgb_max_gap over every pixel of the sampled frames."""
    d = np.concatenate([np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
                        for a, b in zip(got, want)])
    return {"rgb_mean_gap": float(d.mean()), "rgb_max_gap": float(d.max())}


def sample_frames(n_frames: int, k: int, seed: int) -> List[int]:
    """k of the window's frames, drawn from the seed."""
    return sorted(random.Random(seed + 2).sample(range(n_frames), min(k, n_frames)))


# --------------------------------------------------------------------------
# A run
# --------------------------------------------------------------------------
def halves(win: dict) -> List[float]:
    """Units a second in the window's first and second half (a check that
    the window is steady)."""
    if "ends" in win:
        marks = win["ends"]
    else:
        marks, t = [], 0.0
        for k, dt in enumerate(win["times"]):
            t += dt
            marks.append((t, k + 1))
    mid = marks[-1][0] / 2
    t1, n1 = min(marks, key=lambda m: abs(m[0] - mid))
    t2, n2 = marks[-1]
    return [n1 / t1, (n2 - n1) / (t2 - t1)] if t2 > t1 > 0 else []


def record_encodes(trainer, fn) -> List[tuple]:
    """(points, with autograd) of each field query fn() makes: the
    program's query_fn, wrapped for the call."""
    import hashnerf_torch.train.driver as drv

    calls, inner = [], drv.query_fn

    def recording(state, pts, viewdirs, bbox, fine=False):
        calls.append((pts.detach().reshape(-1, 3).clone(), torch.is_grad_enabled()))
        return inner(state, pts, viewdirs, bbox, fine=fine)

    drv.query_fn = recording
    try:
        fn()
    finally:
        drv.query_fn = inner
    return calls


def encode_bytes(g, calls, bbox) -> Dict[str, float]:
    out = {"bytes": 0.0, "forward_calls": 0}
    for pts, grad in calls:
        b = counts.encode_call_bytes(g, pts, bbox, backward=grad)
        out["bytes"] += sum(b.values())
        out["forward_calls"] += 1
    return out


def run_cell(cell: dict, cfg: dict, tr: dict, lim: dict, seed: int, seconds: float, trace: bool,
             device: str, per_layer: List[dict], base: str = spec.HERE,
             t_origin: Optional[float] = None, faults: Optional[dict] = None) -> dict:
    """One run; returns the result line's dict. `faults` plants faults for
    the tests ({"program": fn(trainer)} before the window,
    {"frames": fn(list)} on the window's host copies)."""
    t_origin = time.perf_counter() if t_origin is None else t_origin
    faults = faults or {}
    s = cfg["settings"]
    kind = tr["kind"]
    trainer, sc, init, fam, pool = build(cfg, seed, device, base)
    leaves = fam.program_leaves(trainer)
    n_check = tr.get("check_steps", 3)

    # the start phase: three steps from the seed, as the window calls them
    start_snap = initial_snapshot(trainer, init, fam, pool, n_check)
    start_prog = program_phase(trainer, leaves, start_snap, n_check, precrop=True, pool=pool)
    drive(trainer, tr["setup_steps"], s, pool)
    driver = trafficm.DRIVERS[kind](trainer, tr, s, sc, device, pool)
    driver.warm_up()
    if "program" in faults:
        faults["program"](trainer)
    sync(device)
    setup_s = time.perf_counter() - t_origin

    prof_summary, launches, slice_ = None, None, None
    if trace:
        slice_ = driver.window(seconds=None, units=tr["trace_warm"])
        from hashnerf_torch import kernels

        before = kernels.launch_counts()
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.startswith("cuda") else [])
        with profile(activities=acts) as prof:
            with record_function(tracem.WINDOW):
                traced = driver.window(seconds=None, units=tr["trace_units"])
                sync(device)
        after = kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        prof_summary = tracem.summarize(prof)
        win = trafficm.merge(slice_, traced)
        del prof
    else:
        win = driver.window(seconds=seconds)
        print(f"nerfbench: window halves, units a second: {halves(win)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0

    # the program's side of the checks, then the program is freed
    frames = win.pop("frames", None)
    trained_snap = trained_prog = None
    if kind == "train":
        trained_snap = snapshot(trainer, leaves, fam, pool, n_check)
        trained_prog = program_phase(trainer, leaves, trained_snap, n_check, precrop=False,
                                     pool=pool)
    enc = None
    g = fam.grid(s) if trace else None
    if g is not None:
        if kind == "train":
            enc = {"step": encode_bytes(g, record_encodes(trainer, lambda: trainer.step(
                trainer.sample_batch(False) if pool is None else pool.sample())), sc["bbox"])}
            if trainer.render_cfg.occupancy is not None:
                enc["update"] = encode_bytes(g, record_encodes(trainer, trainer._update_grid),
                                             sc["bbox"])
        else:
            enc = {"frame": encode_bytes(g, record_encodes(
                trainer, lambda: trainer.render_image(sc["render_poses"][0])), sc["bbox"])}
    weights = {n: p.detach().clone() for n, p in leaves.items()}
    del trainer, leaves, driver, pool
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # the reference
    t_check = time.perf_counter()
    r = fam.Reference(s, sc, device)
    numbers = phase_numbers("start", start_prog,
                            reference_phase(r, start_snap, n_check, precrop=True))
    if kind == "train":
        numbers.update(phase_numbers("trained", trained_prog, reference_phase(
            r, trained_snap, n_check, precrop=False)))
    else:
        if "frames" in faults:
            faults["frames"](frames)
        pick = sample_frames(len(frames), tr.get("check_frames", 2), seed)
        want = [r.render_frame(weights, torch.as_tensor(
            np.asarray(sc["render_poses"][frames[i][0]])[:3, :4], dtype=torch.float32, device=device),
            sc["H"], sc["W"], tr.get("reference_chunk", 16384)).cpu().numpy() for i in pick]
        numbers.update(frame_numbers([frames[i][1] for i in pick], want))
    sync(device)
    print(f"nerfbench: set-up {setup_s:.3f} s, reference check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    compared = {k: {"value": v, "limit": lim.get(k, float("nan"))} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    correct = correct and win["failed"] == 0 and set(numbers) == set(lim)

    dev_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win["units"], "failed": win["failed"]}
    if trace:
        ctx = {"settings": s, "traffic": tr, "kind": kind, "on_card": device.startswith("cuda"),
               "slice": slice_, "trace": prof_summary,
               "launches": launches, "traced_units": traced["units"], "encode": enc,
               "frame_hw": (sc["H"], sc["W"]), "family": fam}
        out["metrics"] = spec.read_metrics(per_layer, ctx, base)
        dev_info.update(busy_s=prof_summary["busy_s"], window_s=prof_summary["window_s"])
        out["device"] = dev_info
        out["breakdown"] = {"device_ops": tracem.top(prof_summary["ops"]),
                            "idle_gaps": tracem.top(prof_summary["idle"])}
    else:
        out["metrics"] = trafficm.end_to_end(kind, win, s, (sc["H"], sc["W"]))
        out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        out["device"] = dev_info
    out["compared"] = compared
    return out

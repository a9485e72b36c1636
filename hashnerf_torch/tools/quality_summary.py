"""The port's quality curves (bench_quality.py's JSON) as markdown tables.

Counterpart of hashnerf_tpu/tools/quality_summary.py, over the port's own
curves only (a glob the caller gives; the TPU's BENCH_QUALITY_*.json are
another device's records): per curve its final and best PSNR and steady
ms a step; the training seconds to each milestone (steady ms x iterations
to it); the measured in-run training seconds to it (train_s, eval renders
excluded); and, given the port's merged parity file
(tools/parity_curve.py merge), its milestones and gate. Each curve's step
time is its own `steady_step_ms`.

    python -m hashnerf_torch.tools.quality_summary --json-glob 'DIR/*.json' --out OUT.md
        [--parity DIR/PARITY_CURVE.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

MILESTONES = (20.0, 24.0, 26.0, 28.0, 30.0)


def iters_to_db(curve, db):
    """The iteration the curve first reaches db at, linear between its
    points; None if it never does."""
    prev = None
    for pt in curve:
        if pt["test_psnr"] >= db:
            if prev is None or pt["test_psnr"] == prev["test_psnr"]:
                return pt["iter"]
            f = (db - prev["test_psnr"]) / (pt["test_psnr"] - prev["test_psnr"])
            return round(prev["iter"] + f * (pt["iter"] - prev["iter"]))
        prev = pt
    return None


def train_s_to_db(curve, db):
    """The in-run training seconds (run_steps' wall, eval excluded) to db,
    linear between points; None without train_s or if never reached."""
    if not curve or "train_s" not in curve[0]:
        return None
    prev = None
    for pt in curve:
        if pt["test_psnr"] >= db:
            if prev is None or pt["test_psnr"] == prev["test_psnr"]:
                return pt["train_s"]
            f = (db - prev["test_psnr"]) / (pt["test_psnr"] - prev["test_psnr"])
            return prev["train_s"] + f * (pt["train_s"] - prev["train_s"])
        prev = pt
    return None


def summary(pattern: str, parity: Optional[str] = None) -> str:
    """The markdown of the curves matching pattern (and of the parity file)."""
    rows = []
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            d = json.load(f)
        if "curve" in d:
            rows.append((os.path.basename(path), d))

    out = ["# Quality summary — the port's PSNR curves", ""]
    out.append("Generated by hashnerf_torch/tools/quality_summary.py from the curves of "
               "hashnerf_torch/bench_quality.py (procedural scenes). `parity` = the "
               "reference-exact step (float32, L16/F2, a fine net, no culling).")
    out.append("")
    out.append("| curve | device | scene | N_rand | packed | iters | final dB | best dB | "
               "steady ms/step |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for name, d in rows:
        c = d["curve"]
        ms = d.get("steady_step_ms")
        out.append(
            f"| {d.get('mode', name)} | {d.get('device', '?')} | {d.get('scene', 'sphere')} | "
            f"{d.get('N_rand', '?')} | {d.get('packed', '?')} | {c[-1]['iter']} | "
            f"{c[-1]['test_psnr']:.2f} | {max(p['test_psnr'] for p in c):.2f} | "
            f"{ms if ms is not None else '—'} |")
    out.append("")
    out.append("## Training seconds to X dB (steady ms/step x iterations to X)")
    out.append("")
    header = "| curve | ms/step | " + " | ".join(f"{m:.0f} dB" for m in MILESTONES) + " |"
    out.append(header)
    out.append("|---" * (len(MILESTONES) + 2) + "|")
    for name, d in rows:
        ms = d.get("steady_step_ms")
        cells = []
        for m in MILESTONES:
            it = iters_to_db(d["curve"], m)
            if it is None:
                cells.append("—")
            elif ms is not None:
                cells.append(f"{it * ms / 1e3:.1f}s @{it}")
            else:
                cells.append(f"@{it}")
        out.append(f"| {d.get('mode', name)} | {ms if ms is not None else '—'} | "
                   + " | ".join(cells) + " |")
    out.append("")
    out.append("## Measured in-run training seconds (run_steps wall, eval excluded)")
    out.append("")
    out.append(header.replace("ms/step", "total train_s"))
    out.append("|---" * (len(MILESTONES) + 2) + "|")
    for name, d in rows:
        if "train_s" not in d["curve"][0]:
            continue
        cells = []
        for m in MILESTONES:
            s = train_s_to_db(d["curve"], m)
            cells.append("—" if s is None else f"{s:.1f}s")
        out.append(f"| {d.get('mode', name)} | {d['curve'][-1]['train_s']} | "
                   + " | ".join(cells) + " |")
    out.append("")

    if parity:
        with open(parity) as f:
            pc = json.load(f)
        out.append(f"## Convergence against the PyTorch reference ({os.path.basename(parity)})")
        out.append("")
        out.append(f"Scene: {pc['protocol']['scene']}; ours: {pc['protocol']['ours']}; "
                   f"{pc['protocol']['n_seeds']['reference']} reference / "
                   f"{pc['protocol']['n_seeds']['ours']} ours seeds.")
        out.append("")
        out.append("| iter | reference dB | ours dB | Δ dB | seed spread |")
        out.append("|---|---|---|---|---|")
        for r in pc["milestones"]:
            out.append(f"| {r['iter']} | {r['reference_mean_psnr']:.2f} | "
                       f"{r['ours_mean_psnr']:.2f} | {r['delta_db']:+.2f} | "
                       f"{r['seed_spread_db']:.2f} |")
        out.append("")
        out.append(f"Gate ({pc['gate']}): **{'PASS' if pc['gate_pass'] else 'FAIL'}** — mean "
                   f"Δ {pc['mean_delta_db']:+.2f} dB, final Δ {pc['final']['delta_db']:+.2f} dB.")
        out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-glob", required=True, help="the port's curves")
    ap.add_argument("--out", required=True, help="the markdown file to write")
    ap.add_argument("--parity", default=None, help="the port's merged parity file")
    a = ap.parse_args(argv)
    text = summary(a.json_glob, a.parity)
    with open(a.out, "w") as f:
        f.write(text)
    print(text)
    return text


if __name__ == "__main__":
    main()

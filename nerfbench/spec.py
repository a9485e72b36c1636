"""Finding a cell's parts by name.

BENCHMARK.json (at the checkout's root) names each cell's configuration and
traffic mix, and its metrics. Each part is a file of its own under this
folder, found by that name:

    configs/<config>.json   the port's argv, the settings the reference and
                            the counts read, the scene, source and cuts;
                            "family" names the model family (absent:
                            "ngp") and scene.kind the scene (absent: "ring")
    families/<family>.py    the family's weights from the seed, the
                            program's leaves, the optimizer's step groups
                            and beta1, the plain reference, the FLOP counts
                            and the encode's grid (family_of)
    scenes/<kind>.py        make_scene(spec, device): the training views
                            or a ray pool's columns, render poses and the
                            NDC flag of the scene (scene_of)
    traffic/<traffic>.json  the mix's parameters, read by traffic.py
    metrics/<metric>.py     a per-layer metric's reader
    limits/<cell>.json      the limit of each number the cell compares

A later change adds a part, a model family or a scene included, by adding
its file and its entries.

Training from a ray pool: a configuration whose argv leaves out
--no_batching trains from a pool, as the port's train_loop and main_st3d
do (pool.py): from the scene's "pool" columns where it gives them, else
from every pixel of its "images"; a scene that gives neither is refused at
build. Every span ends at the next i_print event or at the pool's end,
where the pool is reshuffled; there is no precrop. The check hands the
reference the rows its steps take (Reference.train_steps(..., rows=)),
made from the scene by Reference.pool_rows. A configuration with
--no_batching samples its images as the port's image sampler does.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str, base: str) -> dict:
    path = os.path.join(base, kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"nerfbench: no {kind} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"nerfbench: no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(name: str, base: str = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: str = HERE) -> dict:
    return _json("traffic", name, base)


def limits(cell: str, base: str = HERE) -> dict:
    return _json("limits", cell, base)


def metrics_for(bench: dict, cell: str, section: str) -> List[dict]:
    """The entries of `section` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, and those with no workloads key."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def _module(kind: str, name: str, base: str, what: str):
    """The module of <base>/<kind>/<name>.py."""
    path = os.path.join(base, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"nerfbench: no {what} {name!r} ({path})")
    mod_name = f"nerfbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE):
    """The module of metrics/<name>.py: NAME, UNIT, LAYER, MOVES and
    read(ctx) -> float or None (nothing to read)."""
    return _module("metrics", name, base, "reader for metric")


def family_of(cfg: dict, base: str = HERE):
    """The module of families/<cfg["family"]>.py ("ngp" where the
    configuration names none). It gives BETA1, initial_weights(s, seed,
    device), program_leaves(trainer), step_groups(names),
    Reference(s, scene, device, dtype=, half_batch=) (its train_steps takes
    rows=, a pool's rows, which its pool_rows(ids) makes from the scene),
    grid(s) (the encode's Grid, or None without a table),
    train_flops_per_step(s) and render_flops_per_frame(s, H, W)."""
    return _module("families", cfg.get("family", "ngp"), base, "model family")


def scene_of(cfg: dict, base: str = HERE):
    """The module of scenes/<cfg["scene"]["kind"]>.py ("ring" where the
    configuration names none): make_scene(spec, device) returns a dict,
    tensors on the device, with "H", "W", "near", "far", "bbox" (2, 3) and
    either

      * "images" (N, H, W, 3), "poses" (N, 3, 4), "K" (3, 3), "K_np",
        "focal" and "render_poses" (M, 4, 4): the training views, sampled
        under --no_batching, or as an image pool (every pixel a row, in
        image, row, column order) without it; or
      * "pool": a ray pool's columns, named as the port's
        train/driver.py::POOL_COLUMNS names them: "rays_o", "rays_d",
        "target" (each (R, 3)) and optionally "target_depth" (R,) and
        "target_grad" (R, 3), one ray a row; the configuration trains from
        them (no --no_batching) on an image-less Scene, the depth and
        gradient columns only where its argv sets --use_depth and
        --use_gradient, as main_st3d passes them.

    It may set "ndc", which the port's Scene takes. The ngp family's
    reference has no NDC path, so a scene that sets it needs a family whose
    reference has one. The depth spacing (lindisp) is the configuration's
    setting, not the scene's."""
    return _module("scenes", cfg["scene"].get("kind", "ring"), base, "scene kind")


def read_metrics(entries: List[dict], ctx: dict, base: str = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each per-layer entry whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"], base).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out

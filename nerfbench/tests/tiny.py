"""Tiny copies of the benchmark's parts for CPU runs of the harness: the
real configuration files with their sizes cut, written to a folder laid
out as nerfbench/ is (configs/, traffic/, limits/, metrics/, families/,
scenes/)."""
from __future__ import annotations

import json
import os
import shutil

from nerfbench import spec

TINY = {
    "N_rand": 32, "N_samples": 8, "N_importance": 8, "n_levels": 4, "log2_hashmap_size": 12,
    "finest_res": 64, "precrop_iters": 2, "i_print": 4, "steps_per_dispatch": 2, "chunk": 64,
}
TINY_OCC = {"occ_warmup": 4, "occ_update_every": 4, "occ_keep_schedule": "0:0.5,4:0.25",
            "occ_resolution": 32}
TINY_SCENE = {"H": 12, "W": 12, "n_train": 4, "n_render_poses": 3, "ss": 1}


def tiny_config(name: str) -> dict:
    cfg = spec.config(name)
    s = cfg["settings"]
    over = {k: v for k, v in TINY.items() if k != "n_levels" or not s["packed_layout"]}
    if s.get("use_occupancy"):
        over.update(TINY_OCC)
    for k, v in over.items():
        s[k] = v
        cfg["argv"] = cfg["argv"] + [f"--{k}", str(v)]
    cfg["scene"] = dict(cfg["scene"], **TINY_SCENE)
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = spec.traffic(name)
    tr.update(setup_steps=8, trace_warm=1, trace_units=1, check_frames=2, reference_chunk=64)
    return tr


def write_tree(root: str, configs, traffics, limits) -> str:
    """A folder with the given parts, and every metric reader, model family
    and scene kind copied."""
    for kind, parts in (("configs", configs), ("traffic", traffics), ("limits", limits)):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
        for name, body in parts.items():
            with open(os.path.join(root, kind, name + ".json"), "w") as f:
                json.dump(body, f)
    for kind in ("metrics", "families", "scenes"):
        shutil.copytree(os.path.join(spec.HERE, kind), os.path.join(root, kind),
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    return root

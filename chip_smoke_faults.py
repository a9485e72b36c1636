#!/usr/bin/env python3
"""Planted faults that chip_smoke.py's graph-against-eager gate must reject.

    python3 chip_smoke_faults.py

Runs chip_smoke.py's main path twice on one CUDA card, each time with one
fault planted in the graphed training step (in this process only; no file
changes):

  * skip_update_replay, on the flagship path: a block never replays its
    occupancy-grid update graph. The update follows the block's last
    step, so only the grid group of the gate can see it;
  * lr_frozen_at_capture, on the chair path: the step graph reads the
    learning rate of the step it was captured at, as a Python float
    captured into the graph would, instead of the schedule's value at
    each replay.

Each fault must stop the path at the gate of its first graphed window
(chip_smoke.CheckFailed). Prints one JSON line per fault with the gate's
message; exits 0 only if the gate rejected every fault.
"""
from __future__ import annotations

import json
import re
import sys


def skip_update_replay(Trainer, graphs):
    """GraphCache hands out a graph that replays nothing for the update."""
    get = graphs.GraphCache.get

    class Nothing:
        launches = {}

        def replay(self):
            pass

    def faulty(self, key, fn):
        graph = get(self, key, fn)
        return Nothing() if key == ("update",) else graph

    return graphs.GraphCache, "get", faulty


# the frozen learning rates, which the faulty graphs read at every replay
FROZEN_LR = []


def lr_frozen_at_capture(Trainer, graphs):
    """The learning rate a step graph is captured with stays its lr."""
    build = Trainer._build_block

    def faulty(self, *key):
        opt, live = self.optimizer, self.optimizer.lr_fn
        opt.init_state()
        lr0 = live(next(iter(opt.state.values()))["step"]).clone()
        FROZEN_LR.append(lr0)
        opt.lr_fn = lambda step: lr0
        try:
            return build(self, *key)  # captures the step graph on a new key
        finally:
            opt.lr_fn = live

    return Trainer, "_build_block", faulty


FAULTS = (("skip_update_replay", "flagship", skip_update_replay),
          ("lr_frozen_at_capture", "chair", lr_frozen_at_capture))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_faults: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from hashnerf_torch.train import graphs
    from hashnerf_torch.train.driver import Trainer

    chip_smoke.phase_device(torch)
    rejected = 0
    for name, path, plant in FAULTS:
        owner, attr, faulty = plant(Trainer, graphs)
        saved = getattr(owner, attr)
        setattr(owner, attr, faulty)
        try:
            chip_smoke.phase_main_path(torch, np, path, False)
            msg = None
        except chip_smoke.CheckFailed as e:
            msg = str(e)
        finally:
            setattr(owner, attr, saved)
            torch.cuda.empty_cache()
        gate_hit = msg is not None and msg.startswith("graphed block from step")
        group = re.search(r"eager steps \((\w+)\)", msg or "")
        print(json.dumps({"fault": name, "path": path, "rejected": gate_hit,
                          "group": group.group(1) if group else None, "message": msg}), flush=True)
        rejected += gate_hit
    return 0 if rejected == len(FAULTS) else 1


if __name__ == "__main__":
    sys.exit(main())

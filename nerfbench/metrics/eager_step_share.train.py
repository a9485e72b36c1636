"""Share of the traced slice's training steps that ran eagerly
(Trainer.step) and not as a step graph's replay: the program's counters
steps_eager and steps_replayed (hashnerf_torch/utils/profiling.py), which
kernels.launch_counts reads with the launches."""
NAME = "eager_step_share.train"
UNIT = "%"
LAYER = "loop and blocks"
MOVES = "train_rays_per_s"


def read(ctx):
    counts = ctx.get("launches") or {}
    if ctx["kind"] != "train" or "steps_eager" not in counts:
        return None
    steps = counts["steps_eager"] + counts["steps_replayed"]
    return 100.0 * counts["steps_eager"] / steps if steps > 0 else None

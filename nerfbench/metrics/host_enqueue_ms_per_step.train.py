"""Host milliseconds a step spent in Trainer.run_steps' block replays
(and eager remainder steps) before the span's host read, in a traced run's
untraced slice. It moves the rate only where it exceeds the device time."""
NAME = "host_enqueue_ms_per_step.train"
UNIT = "ms"
LAYER = "loop and blocks"
MOVES = "train_rays_per_s"


def read(ctx):
    sl = ctx.get("slice")
    if ctx["kind"] != "train" or not sl or sl["units"] <= 0:
        return None
    return 1e3 * sl["enqueue_s"] / sl["units"]

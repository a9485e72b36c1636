"""Share of the traced window in which no operation ran on the card:
1 - busy / window, busy the union of the device's kernels, copies and
fills inside the benchmark's `nb.window` span (trace.py)."""
NAME = "device_idle_share.train"
UNIT = "%"
LAYER = "device"
MOVES = "train_rays_per_s"


def read(ctx):
    t = ctx.get("trace")
    if not ctx.get("on_card") or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

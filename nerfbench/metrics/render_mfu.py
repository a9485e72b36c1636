"""Model FLOP utilisation of rendering: the forward FLOPs of every sample
of every pixel's ray (its family's render_flops_per_frame), times the
frames of a traced run's untraced slice, over its host-clock time, over
the peak of the declared compute type."""
from nerfbench import counts

NAME = "render_mfu"
UNIT = "%"
LAYER = "whole frame"
MOVES = "render_rays_per_s"


def read(ctx):
    sl = ctx.get("slice")
    if not ctx.get("on_card") or ctx["kind"] != "render" or not sl or sl["seconds"] <= 0:
        return None
    s = ctx["settings"]
    H, W = ctx["frame_hw"]
    return (100.0 * ctx["family"].render_flops_per_frame(s, H, W) * sl["units"] / sl["seconds"]
            / counts.peak_flops(s))

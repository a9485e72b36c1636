"""Model FLOP utilisation of training: the FLOPs the configuration's
algorithm needs a step (its family's train_flops_per_step: 2 a
multiply-add of every layer, x3 for forward and both backward products,
over the points it queries), times the steps of a traced run's untraced
slice, over the slice's host-clock time, over the peak of the declared
compute type."""
from nerfbench import counts

NAME = "train_mfu"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_rays_per_s"


def read(ctx):
    sl = ctx.get("slice")
    if not ctx.get("on_card") or ctx["kind"] != "train" or not sl or sl["seconds"] <= 0:
        return None
    s = ctx["settings"]
    return (100.0 * ctx["family"].train_flops_per_step(s) * sl["units"] / sl["seconds"]
            / counts.peak_flops(s))

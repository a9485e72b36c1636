"""Device milliseconds a frame of the field query's copies, in the traced
slice: PyTorch's concatenation kernels (CatArrayBatchedCopy*, on any
program) and the hand-written kernels that write the colour net's input
and the raw in their place (field_colour_input_*, field_raw_*), counted
together so that a replacement shows its own cost."""
from nerfbench import trace

NAME = "field_copy_ms_per_frame.render"
UNIT = "ms"
LAYER = "field query"
MOVES = "render_rays_per_s"
PATTERNS = ("catarraybatchedcopy", "field_colour_input", "field_raw")


def read(ctx):
    t = ctx.get("trace")
    if not ctx.get("on_card") or ctx["kind"] != "render" or not t or ctx["traced_units"] <= 0:
        return None
    s = trace.seconds_matching(t["ops"], PATTERNS)
    return 1e3 * s / ctx["traced_units"] if s > 0 else None

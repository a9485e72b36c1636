"""Device milliseconds of the MLPs' GEMM kernels (cuBLAS; the names below)
a frame, in the traced slice."""
from nerfbench import trace

NAME = "mlp_gemm_ms_per_frame.render"
UNIT = "ms"
LAYER = "MLPs"
MOVES = "render_rays_per_s"
PATTERNS = ("gemm", "gemv", "splitkreduce", "xmma", "cutlass")


def read(ctx):
    t = ctx.get("trace")
    if not ctx.get("on_card") or ctx["kind"] != "render" or not t or ctx["traced_units"] <= 0:
        return None
    s = trace.seconds_matching(t["ops"], PATTERNS)
    return 1e3 * s / ctx["traced_units"] if s > 0 else None

"""Device milliseconds of the MLPs' GEMM kernels (cuBLAS; the names below)
a step, in the traced slice."""
from nerfbench import trace

NAME = "mlp_gemm_ms_per_step.train"
UNIT = "ms"
LAYER = "MLPs"
MOVES = "train_rays_per_s"
PATTERNS = ("gemm", "gemv", "splitkreduce", "xmma", "cutlass")


def read(ctx):
    t = ctx.get("trace")
    if not ctx.get("on_card") or ctx["kind"] != "train" or not t or ctx["traced_units"] <= 0:
        return None
    s = trace.seconds_matching(t["ops"], PATTERNS)
    return 1e3 * s / ctx["traced_units"] if s > 0 else None

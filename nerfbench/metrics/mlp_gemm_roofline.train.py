"""The MLP GEMMs' share of the float32 compute roof in training: the FLOPs
the configuration's MLP GEMMs compute a step (its family's
train_gemm_flops_per_step, counted from the sizes, whatever runs them: the
model's FLOPs less the input gradient of the first layers, which no GEMM
computes), times the traced slice's steps, over the device time of the
kernels mlp_gemm_ms_per_step.train matches, over the compute type's peak.

It reads nothing where the program has no `mlp_points` counter (the points
query_fn handed an MLP), and nothing where that count is not the
configuration's points a step times the steps: a step that queried fewer
points than the FLOPs count would read higher. A family without
train_gemm_flops_per_step reads nothing."""
import os

from nerfbench import counts, spec, trace

NAME = "mlp_gemm_roofline.train"
UNIT = "%"
LAYER = "MLPs"
MOVES = "train_rays_per_s"
PATTERNS = spec.metric_reader("mlp_gemm_ms_per_step.train", os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))).PATTERNS


def read(ctx):
    t, launches = ctx.get("trace"), ctx.get("launches") or {}
    work = getattr(ctx.get("family"), "train_gemm_flops_per_step", None)
    if (not ctx.get("on_card") or ctx["kind"] != "train" or not t or work is None
            or "mlp_points" not in launches):
        return None
    s = ctx["settings"]
    steps = launches["steps_eager"] + launches["steps_replayed"]
    if steps <= 0 or launches["mlp_points"] != counts.train_points_per_step(s) * steps:
        return None
    gemm_s = trace.seconds_matching(t["ops"], PATTERNS)
    if gemm_s <= 0:
        return None
    return 100.0 * work(s) * steps / gemm_s / counts.peak_flops(s)

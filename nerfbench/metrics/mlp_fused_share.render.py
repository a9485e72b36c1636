"""Share of the points handed to an MLP in the traced slice's frames that
NeRFSmall's one-kernel bf16 forward answered: the program's counters
mlp_fused_points and mlp_points (hashnerf_torch/utils/profiling.py), which
kernels.launch_counts reads with the launches. It reads nothing where the
program has either counter missing, or where no point reached an MLP."""
NAME = "mlp_fused_share.render"
UNIT = "%"
LAYER = "MLPs"
MOVES = "render_rays_per_s"


def read(ctx):
    counts = ctx.get("launches") or {}
    if (ctx["kind"] != "render" or "mlp_fused_points" not in counts
            or "mlp_points" not in counts or counts["mlp_points"] <= 0):
        return None
    return 100.0 * counts["mlp_fused_points"] / counts["mlp_points"]

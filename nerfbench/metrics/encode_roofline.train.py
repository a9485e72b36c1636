"""The encode kernels' share of their roofline: the least time their work
needs at 3.35 TB/s (counts.encode_call_bytes over the points one recorded
eager step, and one grid update, queried outside the window), over the
device time of the kernels below in the traced slice. The grid updates in
the slice are counted from the forward launch counters: the launches
beyond the steps' own are the updates'."""
from nerfbench import counts, trace

NAME = "encode_roofline.train"
UNIT = "%"
LAYER = "encode kernels"
MOVES = "train_rays_per_s"
# K2, K6 (kernels/hash_encode.py) and K7, K8 (kernels/packed_encode.py)
KERNELS = ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel",
           "packed_encode_fwd_kernel", "packed_encode_bwd_kernel")


def read(ctx):
    t, enc = ctx.get("trace"), ctx.get("encode")
    if not ctx.get("on_card") or ctx["kind"] != "train" or not t or not enc:
        return None
    kernel_s = trace.seconds_matching(t["ops"], KERNELS)
    if kernel_s <= 0:
        return None
    units = ctx["traced_units"]
    work = enc["step"]["bytes"] * units
    if "update" in enc:
        launches = ctx["launches"]
        fwd = launches.get("hash_encode_fwd", 0) + launches.get("packed_encode_fwd", 0)
        updates = (fwd - enc["step"]["forward_calls"] * units) / enc["update"]["forward_calls"]
        work += enc["update"]["bytes"] * max(updates, 0.0)
    return 100.0 * work / counts.PEAK_BYTES_PER_S / kernel_s

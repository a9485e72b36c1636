"""The encode kernels' share of their roofline: the least time their work
needs at 3.35 TB/s (counts.encode_call_bytes over the points one recorded
frame queried, outside the window), over the device time of the kernels
below in the traced slice."""
from nerfbench import counts, trace

NAME = "encode_roofline.render"
UNIT = "%"
LAYER = "encode kernels"
MOVES = "render_rays_per_s"
# K2, K6 (kernels/hash_encode.py) and K7, K8 (kernels/packed_encode.py)
KERNELS = ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel",
           "packed_encode_fwd_kernel", "packed_encode_bwd_kernel")


def read(ctx):
    t, enc = ctx.get("trace"), ctx.get("encode")
    if not ctx.get("on_card") or ctx["kind"] != "render" or not t or not enc:
        return None
    kernel_s = trace.seconds_matching(t["ops"], KERNELS)
    if kernel_s <= 0:
        return None
    units = ctx["traced_units"]
    work = enc["frame"]["bytes"] * units
    return 100.0 * work / counts.PEAK_BYTES_PER_S / kernel_s

"""``dense_warp_kernel``'s share of its roofline, in percent: the least time
the card could take for the factors the traced BA iterations warped (11
fp32 planes a factor's pixel, and the kernel's operations, against the
HBM and fp32 peaks) over the kernel's profiled time."""

KERNEL = "dense_warp_kernel"


def read(ctx):
    n = ctx.units.get("iterations")
    ks = [o for o in ctx.trace.ops if KERNEL in o.name]
    if not n or not ks:
        return None
    s, c = ctx.shapes, ctx.counts
    factors = n * s["P"]
    bound = c.roofline_bound_s(c.dense_warp_flops(factors, s["H"], s["W"]),
                               c.dense_warp_bytes(factors, s["H"], s["W"]),
                               c.PEAK_FP32_FLOPS)
    took = sum(o.dur_ns for o in ks) / 1e9
    return 100.0 * bound / took

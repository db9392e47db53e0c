"""``jacobian_stack_kernel``'s share of its roofline, in percent: the least
time the card could take for the factors the traced BA iterations stacked
(22 + 2 CS fp32 planes a factor's pixel: dense_warp's seven planes, depth,
img0 and the CS planes of the code Jacobian read, the 12 + CS weighted
Jacobian rows and the weighted residual written; and the kernel's
operations, against the HBM and fp32 peaks) over the kernel's profiled
time. None where the run launched no such kernel."""

KERNEL = "jacobian_stack_kernel"


def planes(CS: int) -> int:
    """fp32 planes a factor's pixel moves: 9 + CS read, 13 + CS written."""
    return 22 + 2 * CS


def flops_per_pixel(CS: int) -> int:
    """The kernel's operations a factor's pixel: the warp Jacobians and the
    prox chain (54), the two K = 6 pose products (2 x 6 x 12), the code
    rows (CS x 2), the residual and robust weight (7) and the twelve
    weighted pose rows and rw (13); the mask's select not counted."""
    return 54 + 144 + 2 * CS + 7 + 13


def read(ctx):
    n = ctx.units.get("iterations")
    ks = [o for o in ctx.trace.ops if KERNEL in o.name]
    if not n or not ks:
        return None
    s, c = ctx.shapes, ctx.counts
    pixels = n * s["P"] * s["H"] * s["W"]
    bound = c.roofline_bound_s(flops_per_pixel(s["CS"]) * pixels,
                               4 * planes(s["CS"]) * pixels,
                               c.PEAK_FP32_FLOPS)
    took = sum(o.dur_ns for o in ks) / 1e9
    return 100.0 * bound / took

"""The BA step's share of the card's fp32 peak, in percent: the operations
an iteration needs (every factor's normal equations, the Schur solve;
``counts.ba_iteration_flops``) over the traced window's time an
iteration."""


def read(ctx):
    n = ctx.units.get("iterations")
    if not n or ctx.trace.window_s <= 0:
        return None
    s, c = ctx.shapes, ctx.counts
    flops = n * c.ba_iteration_flops(s["P"], s["K"], s["CS"], s["H"], s["W"])
    return 100.0 * flops / ctx.trace.window_s / c.PEAK_FP32_FLOPS

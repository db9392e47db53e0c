"""The training step's share of the card's bf16 peak, in percent: the
convolutions' forward and backward operations of a step
(``counts.train_conv_flops``) over the traced window's time a step."""


def read(ctx):
    n = ctx.units.get("steps")
    if not n or ctx.trace.window_s <= 0:
        return None
    s, c = ctx.shapes, ctx.counts
    flops = n * c.train_conv_flops(s["batch"], s["CS"], s["levels"],
                                   s["base_ch"], s["H"], s["W"])
    return 100.0 * flops / ctx.trace.window_s / c.PEAK_BF16_FLOPS

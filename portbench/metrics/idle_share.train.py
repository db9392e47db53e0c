"""The device's idle share of the traced window, in percent: one minus the
union of every kernel's, copy's and fill's interval over the window."""


def read(ctx):
    if not ctx.units.get("steps") or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

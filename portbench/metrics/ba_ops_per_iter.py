"""Device operations (kernels, copies, fills) a BA iteration launches, from
the profiler: the glue the host issues one by one."""


def read(ctx):
    n = ctx.units.get("iterations")
    if not n or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / n

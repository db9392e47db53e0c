"""Device operations (kernels, copies, fills) a training step launches,
from the profiler: the step's dispatch."""


def read(ctx):
    n = ctx.units.get("steps")
    if not n or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / n

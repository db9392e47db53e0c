"""The BA exchange's share of the link's peak, in percent: the bytes rank
0's steps all-reduced over the traced window (the program's counter,
``units["allreduce_bytes"]``), as a ring moves them over each card's link
a direction (2 (n - 1) / n of them), over the profiled time of rank 0's
NCCL all-reduce kernels, against ``links.PEAK_LINK_BYTES``. A kernel's
time includes its wait for the slowest rank."""
from portbench import links


def read(ctx):
    nbytes = ctx.units.get("allreduce_bytes")
    ranks = ctx.shapes.get("ranks", 1)
    ks = [o for o in ctx.trace.ops
          if "nccl" in o.name.lower() and "allreduce" in o.name.lower()]
    if not nbytes or ranks < 2 or not ks:
        return None
    took = sum(o.dur_ns for o in ks) / 1e9
    return 100.0 * links.ring_allreduce_bytes(nbytes, ranks) / took \
        / links.PEAK_LINK_BYTES

"""The card's stream time in the BA step's exchange (the program's
``ba.allreduce`` span, nested in ``ba.assemble``: the ``all_reduce`` of
the [D, D] system, its right-hand side and the statistics over the
group), in ms a BA iteration, on rank 0."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "ba.allreduce", "iterations")

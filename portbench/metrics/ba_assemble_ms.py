"""The card's stream time in the BA step's assembly (the program's
``ba.assemble`` span: the [D, D] system, the statistics, the
``all_reduce`` where there is a group, the priors and the mask), in ms a
BA iteration."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "ba.assemble", "iterations")

"""The card's idle time while the host was in the BA step's solve (gaps
between device operations opened under the program's ``ba.solve`` span,
its innermost), in ms a BA iteration."""
from portbench import spans


def read(ctx):
    return spans.idle_metric(ctx, "ba.solve", "iterations")

"""The card's idle time while the host was in the BA step's linearisation
(gaps between device operations opened under the program's
``ba.linearise`` span, its innermost), in ms a BA iteration."""
from portbench import spans


def read(ctx):
    return spans.idle_metric(ctx, "ba.linearise", "iterations")

"""The card's stream time in the BA step's solve (the program's
``ba.solve`` span: the Schur solve and the retract), in ms a BA
iteration."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "ba.solve", "iterations")

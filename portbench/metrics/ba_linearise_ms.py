"""The card's stream time in the BA step's linearisation (the program's
``ba.linearise`` span: code to proximity, ``sfm_step_batch`` over its
chunks), in ms a BA iteration."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "ba.linearise", "iterations")

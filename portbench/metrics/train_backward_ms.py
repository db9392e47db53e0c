"""The card's stream time in the training step's backward pass (the
program's ``train.backward`` span: autograd, and the ``all_reduce`` where
there is a group), in ms a step."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "train.backward", "steps")

"""The card's stream time in the training step's optimiser (the program's
``train.optimiser`` span: the clip and AdamW), in ms a step."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "train.optimiser", "steps")

"""The card's stream time in the training step's forward pass (the
program's ``train.forward`` span: ``zero_grad``, eps, ``vae_loss``), in
ms a step."""
from portbench import spans


def read(ctx):
    return spans.stream_metric(ctx, "train.forward", "steps")

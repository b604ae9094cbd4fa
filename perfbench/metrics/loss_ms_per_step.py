"""Device ms a training step of the next-token loss over the logits,
forward and backward, inside the program's `vtp::loss` span and its
`.bwd` range."""

from perfbench.metrics._spans import part_ms

SPAN = "vtp::loss"


def read(ctx):
    return part_ms(ctx, SPAN)

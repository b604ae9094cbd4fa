"""`rotary_ms.train`, `rotary_ms.serve`: device ms a training step
(forward and backward) or a served batch of the rotary embedding of q
and k, inside the program's `vtp::rotary` spans and their `.bwd`
ranges."""

from perfbench.metrics._spans import part_ms

SPAN = "vtp::rotary"


def read(ctx):
    return part_ms(ctx, SPAN)

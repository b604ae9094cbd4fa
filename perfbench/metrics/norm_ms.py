"""`norm_ms.train`, `norm_ms.serve`: device ms a training step (forward
and backward) or a served batch of the RMSNorms, the ops launched inside
the program's `vtp::norm` spans and their `vtp::norm.bwd` ranges."""

from perfbench.metrics._spans import part_ms

SPAN = "vtp::norm"


def read(ctx):
    return part_ms(ctx, SPAN)

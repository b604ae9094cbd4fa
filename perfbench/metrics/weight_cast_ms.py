"""`weight_cast_ms.train`, `weight_cast_ms.serve`: device ms a training
step (forward and backward) or a served batch of the f32 weights' casts
to the activation dtype at their use, inside the program's `vtp::cast`
spans and their `.bwd` ranges."""

from perfbench.metrics._spans import part_ms

SPAN = "vtp::cast"


def read(ctx):
    return part_ms(ctx, SPAN)

"""Device ms a training step of every operation launched inside the
program's `vtp::adamw` span (`AdamW.update`): the program's own twin of
`optimizer_ms_per_step`, which the benchmark reads from its wrapper."""

from perfbench.metrics._spans import part_ms

SPAN = "vtp::adamw"


def read(ctx):
    return part_ms(ctx, SPAN, backward=False)

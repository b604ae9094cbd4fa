"""Device time a step of the model's glue: every device operation in
the window that is neither a matmul, nor a flash kernel, nor launched by
the optimizer."""

from perfbench.metrics._common import (group_seconds, optimizer_ops,
                                       per_step_ms)


def read(ctx):
    if ctx.trace is None:
        return None
    s = group_seconds(ctx.trace, "elementwise", exclude=optimizer_ops(ctx))
    return per_step_ms(ctx, s) if s > 0 else None

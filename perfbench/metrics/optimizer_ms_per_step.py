"""Device time a step of the kernels launched inside the optimizer's
update (`AdamW.update`, inside the benchmark's `perfbench::optimizer`
span), matmuls excluded."""

from perfbench import flops
from perfbench.metrics._common import optimizer_ops, per_step_ms


def read(ctx):
    if ctx.trace is None:
        return None
    ops = [op for op in optimizer_ops(ctx)
           if flops.kernel_group(op.name) == "elementwise"]
    return per_step_ms(ctx, sum(op.dur for op in ops)) if ops else None

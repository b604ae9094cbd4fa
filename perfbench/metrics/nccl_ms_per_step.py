"""Device ms a training step in NCCL kernels (the fsdp all-gathers of
each weight at its use, the reduce-scatters of their gradients, the
gradient and loss all-reduces), on rank 0's card."""

from perfbench.metrics._common import per_step_ms
from perfbench.metrics._nccl import nccl_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    s = nccl_seconds(ctx.trace)
    return per_step_ms(ctx, s) if s > 0 else None

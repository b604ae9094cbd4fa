"""Device ms a training step in which a NCCL kernel ran on rank 0's card
and no other kernel did: the collectives' time that compute does not
hide."""

from perfbench.metrics._common import per_step_ms
from perfbench.metrics._nccl import exposed_seconds, nccl_seconds


def read(ctx):
    if ctx.trace is None or nccl_seconds(ctx.trace) <= 0:
        return None
    return per_step_ms(ctx, exposed_seconds(ctx.trace))

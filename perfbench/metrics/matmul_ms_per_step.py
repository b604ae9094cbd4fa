"""Device time a step of the matmul kernels (cuBLAS and CUTLASS names:
gemm, nvjet, xmma, cutlass)."""

from perfbench.metrics._common import group_seconds, per_step_ms


def read(ctx):
    if ctx.trace is None:
        return None
    s = group_seconds(ctx.trace, "matmul")
    return per_step_ms(ctx, s) if s > 0 else None

"""What the readers share: the device time of kernel groups in the
traced window, and the flash kernels' roofline share."""

from __future__ import annotations

from typing import Optional

from perfbench import flops

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def group_seconds(trace, group: str, exclude=()) -> float:
    ids = {id(op) for op in exclude}
    return sum(op.dur for op in trace.in_window()
               if flops.kernel_group(op.name) == group and id(op) not in ids)


def flash_roofline(ctx) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their device time, in
    percent, over the flash kernels the cell launches.  The counter
    `attention_shape` is (b, t, h, d), or with the v head dim and the
    key/value heads (b, t, h, d, d_v[, h_kv]) where they differ."""
    if ctx.trace is None:
        return None
    shape = tuple(ctx.counters["attention_shape"])
    bound_s = time_s = 0.0
    for kernel in ctx.counters["flash_kernels"]:
        ops = [op for op in ctx.trace.in_window()
               if flops.kernel_group(op.name) == kernel]
        one = flops.bound(*flops.flash_costs(kernel, *shape[:4], 2,
                                             *shape[4:]),
                          ctx.flop_peak, ctx.byte_peak)[0]
        bound_s += one * len(ops)
        time_s += sum(op.dur for op in ops)
    return 100.0 * bound_s / time_s if time_s > 0 else None


def idle(ctx) -> Optional[float]:
    """None where the trace saw no device operation."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy > 0 else None


def per_step_ms(ctx, seconds: float) -> Optional[float]:
    steps = ctx.counters.get("steps", 0)
    return 1e3 * seconds / steps if steps else None


def optimizer_ops(ctx):
    return ctx.trace.launched_in(ctx.counters["optimizer_span"])

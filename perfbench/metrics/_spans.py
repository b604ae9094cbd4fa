"""What the readers of the program's own spans share.

The program (`volcano_tpu_torch/workloads/spans.py`) opens profiler
ranges called `vtp::<part>` around its parts, and `vtp::<part>.bwd`
around each part's backward on the autograd engine's thread.  A part's
device time is that of the window's operations launched inside either
range, per training step or per served batch.  A trace with none of
the spans (a program without them) reads as nothing.
"""

from __future__ import annotations

from typing import List, Optional

PREFIX = "vtp::"
BATCH = "vtp::serve.batch"
# the ranges around a whole step, its halves, the optimizer, a served
# batch or a block: together they hold every launch, so what they alone
# hold is the glue between the parts, which `unspanned_share` counts
WHOLE = ("vtp::forward", "vtp::backward", "vtp::adamw", BATCH, "vtp::block")


def per_unit(ctx) -> int:
    """Training steps, or served batches, in the window."""
    c = ctx.counters
    return c.get("steps") or c.get("batches") or 0


def part_ms(ctx, name: str, backward: bool = True) -> Optional[float]:
    """Device ms a step (or a batch) launched inside `name`, and with
    `backward` inside `name.bwd` too."""
    if ctx.trace is None or not per_unit(ctx):
        return None
    ops = {id(op): op for op in ctx.trace.launched_in(name)}
    if backward:
        ops.update((id(op), op) for op in
                   ctx.trace.launched_in(name + ".bwd"))
    if not ops:
        return None
    return 1e3 * sum(op.dur for op in ops.values()) / per_unit(ctx)


def unspanned_share(ctx) -> Optional[float]:
    """Percent of the window's device time launched inside no part's
    range: none of the program's `vtp::` spans but those in `WHOLE`
    (an operation with no launching call counts as outside)."""
    if ctx.trace is None:
        return None
    names = {op.name for op in ctx.trace.host if op.name.startswith(PREFIX)
             and op.name.removesuffix(".bwd") not in WHOLE}
    ops = ctx.trace.in_window()
    total = sum(op.dur for op in ops)
    if not names or total <= 0:
        return None
    inside = {id(op) for name in names for op in ctx.trace.launched_in(name)}
    outside = sum(op.dur for op in ops if id(op) not in inside)
    return 100.0 * outside / total


def queue_waits_ms(ctx) -> Optional[List[float]]:
    """Each request's wait before its batch was formed: its latency less
    its batch's `vtp::serve.batch` duration, the requests paired to the
    window's batches in order by `batch_sizes`.  None where the batch
    spans do not match the batches in number."""
    c = ctx.counters
    if ctx.trace is None or not c.get("batch_sizes"):
        return None
    lo, hi = ctx.trace.window
    batches = [(a, b) for a, b in ctx.trace.spans(BATCH) if lo <= a < hi]
    sizes, lat = c["batch_sizes"], c["latency_ms"]
    if len(batches) != len(sizes) or sum(sizes) != len(lat):
        return None
    waits, j = [], 0
    for (a, b), n in zip(batches, sizes):
        waits += [ms - 1e3 * (b - a) for ms in lat[j:j + n]]
        j += n
    return waits

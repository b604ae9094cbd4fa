"""The allocator's peak over the window, in GiB
(`torch.cuda.max_memory_allocated` after a reset at its start)."""


def read(ctx):
    peak = ctx.counters.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None

"""The mean device time of one batched forward over the window, from
CUDA events around each call of the replica's forward."""


def read(ctx):
    ms = ctx.counters.get("forward_ms")
    return sum(ms) / len(ms) if ms else None

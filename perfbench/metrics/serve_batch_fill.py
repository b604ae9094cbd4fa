"""Requests a forward over max_batch, over the window's batches."""


def read(ctx):
    c = ctx.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["requests"] / (c["batches"] * c["max_batch"])

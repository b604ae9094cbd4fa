"""The serving replica's share of the card's bf16 dense peak: the model
FLOP of every request served in the traced window (padding rows not
counted) over the window's host-clock length."""


def read(ctx):
    c = ctx.counters
    if not c.get("requests"):
        return None
    return 100.0 * c["request_flops"] * c["requests"] / c["window_s"] / \
        ctx.flop_peak

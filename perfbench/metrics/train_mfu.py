"""The whole training step's share of the card's bf16 dense peak: the
model FLOP of every step in the traced window (`flops.train_flops`)
over the window's host-clock length."""


def read(ctx):
    c = ctx.counters
    if not c.get("steps"):
        return None
    return 100.0 * c["step_flops"] * c["steps"] / c["window_s"] / \
        ctx.flop_peak

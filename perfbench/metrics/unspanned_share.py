"""`unspanned_share.train`, `unspanned_share.serve`: the share of the
window's device time launched inside none of the program's part ranges
(the `vtp::` spans but the step's, its halves', AdamW's, a batch's and
a block's, which enclose every launch), which is how much of the
device's work the parts leave unnamed: the residual adds, the backward's
sums of gradients, and whatever runs between steps or batches."""

from perfbench.metrics._spans import unspanned_share


def read(ctx):
    return unspanned_share(ctx)

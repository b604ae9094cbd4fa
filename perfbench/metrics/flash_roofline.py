"""`flash_roofline.train`, `flash_roofline.serve`: the flash kernels'
share of their roofline over the traced window, the sum of each
launch's bound, max(FLOP / peak, bytes / bandwidth) at the cell's
attention shape (`flops.flash_costs`), over the sum of their device
time."""

from perfbench.metrics._common import flash_roofline


def read(ctx):
    return flash_roofline(ctx)

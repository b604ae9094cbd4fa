"""The 95th percentile over the window's requests of the wait before
each request's batch was formed: its latency less its batch's
`vtp::serve.batch` span (`_spans.queue_waits_ms`)."""

import numpy as np

from perfbench.metrics._spans import queue_waits_ms


def read(ctx):
    waits = queue_waits_ms(ctx)
    return float(np.percentile(waits, 95)) if waits else None

"""Open-loop arrivals at a fixed rate.

`poisson_schedule` gives the due times of a Poisson process at a fixed
rate over a window: the gaps are the quantiles of the exponential
distribution at (i + 0.5) / n for n = round(rate x seconds), in one
shuffled order drawn once (`ORDER`).  Every seed offers the same
arrivals; the seed changes the requests' tokens, the weights and the
sample that is checked.  At 80% of the knee a batch of 8 is padded and
served in one ~153 ms forward, so a request's latency is one or two
forwards, or three where a burst overfills a batch, and the 95th
percentile lies near that cliff: orders drawn from the seed moved it by
half (306-457 ms), and the start of a rotated order by 5% (my chip runs),
while the runs of a cell should differ by the system's noise only.
"""

from __future__ import annotations

import math
from typing import List

from perfbench.inputs import host_rng

# the host stream and the seed of the one order
ARRIVALS, ORDER = 3, 0


def poisson_schedule(rate_per_s: float, seconds: float) -> List[float]:
    """Due times in seconds from the window's start, ascending; the
    first is one gap after the start."""
    n = max(1, round(rate_per_s * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate_per_s for i in range(n)]
    host_rng(ORDER, ARRIVALS).shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        out.append(t)
    return out

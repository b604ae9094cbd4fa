"""The arrival schedule: the rate's count, exponential gaps, one order
for every seed."""

import math
import statistics

import pytest

from perfbench import arrivals


def test_schedule():
    due = arrivals.poisson_schedule(40.0, 51.0)
    assert len(due) == 2040
    assert due == sorted(due) and due[0] > 0
    gaps = [b - a for a, b in zip([0.0] + due, due)]
    # the quantiles of Exp(40): mean 1/40 up to the midpoint rule
    assert statistics.mean(gaps) == pytest.approx(1 / 40, rel=0.01)
    assert min(gaps) == pytest.approx(-math.log(1 - 0.5 / 2040) / 40)
    assert due == arrivals.poisson_schedule(40.0, 51.0)

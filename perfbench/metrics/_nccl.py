"""What the readers of the collectives share: the device time of the
NCCL kernels in the traced window (rank 0's trace on a cell over several
cards), and the part of it in which no other kernel ran."""

from __future__ import annotations

from typing import Iterable, List, Tuple

# device operations that are copies or fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


def is_nccl(op) -> bool:
    return "nccl" in op.name.lower()


def nccl_seconds(trace) -> float:
    """Device seconds of the window's NCCL kernels."""
    return sum(op.dur for op in trace.in_window() if is_nccl(op))


def _union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def exposed_seconds(trace) -> float:
    """Seconds of the window in which a NCCL kernel ran and no other
    kernel did."""
    lo, hi = trace.window

    def clipped(ops):
        return _union((max(op.start, lo), min(op.start + op.dur, hi))
                      for op in ops)

    ops = trace.in_window()
    nccl = clipped(op for op in ops if is_nccl(op))
    compute = clipped(op for op in ops if not is_nccl(op)
                      and not op.name.startswith(_NOT_KERNELS))
    total, j = 0.0, 0
    for a, b in nccl:
        covered = 0.0
        while j < len(compute) and compute[j][1] <= a:
            j += 1
        k = j
        while k < len(compute) and compute[k][0] < b:
            covered += min(b, compute[k][1]) - max(a, compute[k][0])
            k += 1
        total += (b - a) - covered
    return total

"""Shared utilities: comparator-based priority queues, rate windows.

Reference parity: pkg/scheduler/util/priority_queue.go.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Generic, Iterable, List, Optional, TypeVar

T = TypeVar("T")


class RateWindow:
    """Windowed EWMA rate over a monotonically-increasing counter —
    the one copy of the counter-delta machinery shared by the agent's
    collectors (NetAccountingCollector byte counters, GoodputCollector
    step counters).

    Semantics per fold(reading, ts):

      * a None reading leaves the window untouched: the direction
        simply spans to the next successful read (a one-sided failed
        read must not tear the other counter's window);
      * the first reading opens the window — no rate yet;
      * a reading >= the last one is a delta over dt, folded into the
        EWMA (the very first window seeds the EWMA directly);
      * a reading BELOW the last one is a counter reset, interpreted
        per *reset* policy:
          - "absolute" (byte counters): the exporter restarted; the
            new absolute value IS the delta (the bytes since the
            reset — the only defensible reading);
          - "restart"  (step counters): the SOURCE restarted (a
            drained worker resuming from a checkpoint floor) — the
            window restarts with NO delta, because crediting the
            resumed absolute step count as progress would inflate the
            rate, and a negative delta is meaningless.  The EWMA is
            retained and decays into the new windows.

    restart() forces the "restart" handling explicitly — callers with
    an out-of-band restart signal (a resize-epoch bump) call it even
    when the counter happens to land higher than the last reading.
    """

    __slots__ = ("alpha", "reset", "scale", "last", "last_ts", "rate")

    def __init__(self, alpha: float = 0.5, reset: str = "absolute",
                 scale: float = 1.0):
        if reset not in ("absolute", "restart"):
            raise ValueError(f"unknown reset policy {reset!r}")
        self.alpha = float(alpha)
        self.reset = reset
        self.scale = float(scale)       # e.g. bytes -> mbps: 8/1e6
        self.last: Optional[float] = None
        self.last_ts: Optional[float] = None
        self.rate = 0.0                 # windowed EWMA, scaled units

    def restart(self) -> None:
        """Drop the window (source restarted); the EWMA survives."""
        self.last = None
        self.last_ts = None

    def fold(self, cur: Optional[float], ts: float) -> float:
        """Fold one reading; returns the (possibly unchanged) rate."""
        if cur is None:
            return self.rate
        if self.last is None:           # first reading: no window yet
            self.last, self.last_ts = cur, ts
            return self.rate
        if cur >= self.last:
            delta = cur - self.last
        elif self.reset == "absolute":
            delta = cur                 # exporter reset: cur IS delta
        else:                           # "restart": re-open, no delta
            self.last, self.last_ts = cur, ts
            return self.rate
        dt = ts - self.last_ts if self.last_ts is not None else 0.0
        self.last, self.last_ts = cur, ts
        if dt > 0:
            inst = delta * self.scale / dt
            self.rate = inst if self.rate == 0.0 else \
                self.alpha * inst + (1 - self.alpha) * self.rate
        return self.rate


class PriorityQueue(Generic[T]):
    """Heap ordered by a less(a, b) comparator (True => a pops first).

    Insertion order breaks ties so scheduling is deterministic.
    """

    def __init__(self, less: Callable[[T, T], bool],
                 items: Iterable[T] = ()):
        self._less = less
        self._counter = itertools.count()
        self._heap: List["_Entry[T]"] = []
        for it in items:
            self.push(it)

    def push(self, item: T):
        heapq.heappush(self._heap, _Entry(item, next(self._counter), self._less))

    def pop(self) -> T:
        return heapq.heappop(self._heap).item

    def peek(self) -> T:
        return self._heap[0].item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self):
        """Drain-iterate in priority order (consumes the queue)."""
        while not self.empty():
            yield self.pop()


class _Entry(Generic[T]):
    __slots__ = ("item", "seq", "less")

    def __init__(self, item: T, seq: int, less: Callable[[T, T], bool]):
        self.item = item
        self.seq = seq
        self.less = less

    def __lt__(self, other: "_Entry[T]") -> bool:
        if self.less(self.item, other.item):
            return True
        if self.less(other.item, self.item):
            return False
        return self.seq < other.seq



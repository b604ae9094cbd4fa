"""The traced run's device trace.

`capture` runs a window under `torch.profiler` (CPU and CUDA activity),
exports the Chrome trace to a fixed file inside the checkout and reads
it back as a `Trace`: the device's operations (kernels, copies, sets)
with the host time of the call that launched each, the host's events
(operators, runtime calls and the benchmark's own `perfbench::` spans),
and the window, the span named `WINDOW`.

Spans are the benchmark's own (`span`): it records them around its calls
into the program's layers; the program records none itself.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

WINDOW = "perfbench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


@dataclasses.dataclass
class Op:
    name: str
    start: float       # seconds, the trace's clock
    dur: float
    launch: Optional[float] = None   # host time of the launching call


@dataclasses.dataclass
class Trace:
    device: List[Op]
    host: List[Op]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> List[Op]:
        lo, hi = self.window
        return [op for op in self.device if op.start < hi and
                op.start + op.dur > lo]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations inside the window."""
        lo, hi = self.window
        spans = sorted((max(op.start, lo), min(op.start + op.dur, hi))
                       for op in self.in_window())
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((op.start, op.start + op.dur) for op in self.host
                      if op.name == name)

    def launched_in(self, name: str) -> List[Op]:
        """The device operations in the window whose launching call lies
        inside a host span called `name`."""
        spans = self.spans(name)
        starts = [a for a, _ in spans]
        out = []
        for op in self.in_window():
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                out.append(op)
        return out

    def device_ops(self, n: int = 10) -> List[List]:
        """The n device operations with the most time in the window."""
        by: Dict[str, float] = defaultdict(float)
        for op in self.in_window():
            by[op.name] += op.dur
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> List[List]:
        """The device's idle time in the window by what the host was
        doing: each of the `longest` gaps is named by the innermost host
        event over its middle (the rest are "shorter gaps"); the n names
        with the most idle time."""
        import numpy as np
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [op for op in self.host if op.name != WINDOW]
        starts = np.array([op.start for op in host])
        ends = starts + np.array([op.dur for op in host])
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps[:longest]:
            mid = (a + b) / 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "host: no traced call" if not len(hit) else \
                host[int(hit[np.argmin(ends[hit] - starts[hit])])].name
            by[name] += b - a
        rest = sum(b - a for a, b in gaps[longest:])
        if rest:
            by["shorter gaps"] += rest
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}


def parse(events: Iterable[dict]) -> Trace:
    """A Trace from Chrome trace events (`export_chrome_trace`)."""
    launches: Dict[int, float] = {}
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        op = Op(ev.get("name", ""), float(ev["ts"]) * 1e-6,
                float(ev.get("dur", 0.0)) * 1e-6)
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            op.launch = corr        # resolved below
            device.append(op)
        elif cat in HOST_CATS:
            host.append(op)
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = op.start
    for op in device:
        op.launch = launches.get(op.launch)
    windows = [op for op in host if op.name == WINDOW]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} span")
    w = max(windows, key=lambda op: op.dur)
    return Trace(device, host, (w.start, w.start + w.dur))


def trace_file(workload: str) -> Path:
    from perfbench.cells import ROOT
    return ROOT / "build" / "perfbench" / f"{workload}.trace.json"


@contextlib.contextmanager
def span(name: str):
    """A host span in the trace (a no-op while nothing traces)."""
    import torch
    with torch.profiler.record_function(name):
        yield


def capture(window: Callable[[], None], workload: str) -> Trace:
    """Run `window` (which opens the `WINDOW` span itself) under the
    profiler and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        window()
    path = trace_file(workload)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    del prof
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return parse(data.get("traceEvents", data) if isinstance(data, dict)
                 else data)

"""What every run does around its driver: the outcome it returns, the
per-layer readers, the modules a run may not hold, and the last line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from typing import Any, Dict, List, Optional

from perfbench.cells import PKG, Cell

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "volcano_tpu")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values by name, the
    counters the per-layer readers read, the trace of a traced run, and
    the judgement of what the timed path produced."""
    end_to_end: Dict[str, float]
    counters: Dict[str, Any]
    attempted: int
    failed: int
    memory_peak_bytes: int
    correct: bool
    checks: Dict[str, Dict[str, float]]
    trace: Any = None


@dataclasses.dataclass
class Context:
    """What a per-layer reader gets."""
    cell: Cell
    counters: Dict[str, Any]
    trace: Any
    flop_peak: float
    byte_peak: float


def forbidden_modules(modules=None) -> List[str]:
    """The FORBIDDEN top-level names among the loaded modules, compared
    whole (`volcano_tpu_torch` is not `volcano_tpu`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN))


def reader_path(name: str):
    """perfbench/metrics/<name>.py, or where there is none the reader of
    the quantity a split name measures: `device_idle.serve` and
    `device_idle.train` are both read by `device_idle.py`."""
    path = PKG / "metrics" / f"{name}.py"
    return path if path.exists() else PKG / "metrics" / \
        f"{name.split('.')[0]}.py"


def reader(name: str):
    """The `read` of `reader_path(name)`."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(ctx: Context) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in ctx.cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(outcome: Outcome, cell: Cell, device: Dict[str, Any],
           ctx: Optional[Context]) -> Dict[str, Any]:
    """The last line's object; `ctx` is given for a traced run."""
    if ctx is None:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    else:
        metrics = per_layer(ctx)
    line: Dict[str, Any] = {
        "correct": bool(outcome.correct), "attempted": outcome.attempted,
        "failed": outcome.failed, "metrics": metrics,
        "device": dict(device, memory_peak_bytes=outcome.memory_peak_bytes)}
    if ctx is not None and outcome.trace is not None:
        line["device"]["busy_s"] = outcome.trace.busy_s()
        line["device"]["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = outcome.checks
    return line


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]

"""Prometheus-style metrics registry (reference: pkg/scheduler/metrics).

Zero-dependency: counters, gauges and summary histograms kept in-process
with a text exposition dump, so the benchmark harness and tests can
assert on scheduling latencies the same way the reference scrapes
e2e_scheduling_latency_milliseconds.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple

_lock = threading.Lock()
_observations: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], List[float]] = \
    defaultdict(list)
_counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = \
    defaultdict(float)
_gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
# Cumulative (count, sum) per summary series: the exposition must stay
# monotonic even though the quantile window below is trimmed, or
# scrapers' rate()/increase() see phantom counter resets.
_obs_totals: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                  Tuple[int, float]] = defaultdict(lambda: (0, 0.0))


def _key(name: str, labels: dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted(labels.items()))


# Per-series retention cap: summaries keep a sliding window so a
# long-running daemon emitting per-task latencies can't grow without
# bound (the exposition reports count/sum over the window).
MAX_OBSERVATIONS = 16384

# Lock-order audit opt-in (analysis/lockaudit.py): when armed, the
# four registries are wrapped so any mutation without _lock held is
# recorded as a violation — every writer in this module must stay
# inside `with _lock`, and this makes the rule mechanical.
import os as _os

if _os.environ.get("VTP_LOCK_AUDIT"):
    import sys as _sys

    from volcano_tpu_torch.analysis import lockaudit as _lockaudit
    _lockaudit.maybe_guard_metrics(_sys.modules[__name__])


def observe(name: str, value: float, **labels):
    with _lock:
        key = _key(name, labels)
        series = _observations[key]
        series.append(value)
        count, total = _obs_totals[key]
        _obs_totals[key] = (count + 1, total + value)
        if len(series) > MAX_OBSERVATIONS:
            del series[:len(series) // 2]


def inc(name: str, value: float = 1.0, **labels):
    with _lock:
        _counters[_key(name, labels)] += value


def set_gauge(name: str, value: float, **labels):
    """Point-in-time value (e.g. current unschedulable-job count)."""
    with _lock:
        _gauges[_key(name, labels)] = value


def get_gauge(name: str, **labels) -> float:
    with _lock:
        return _gauges.get(_key(name, labels), 0.0)


def clear_gauge_series(name: str):
    """Drop every labeled gauge of *name* — used before re-exporting a
    per-object family (e.g. job_share) so objects that disappeared
    don't linger as stale series (reference metrics/job.go delete)."""
    with _lock:
        for key in [k for k in _gauges if k[0] == name]:
            del _gauges[key]


def delete_labeled(**labels):
    """Drop every series (gauge/counter/summary) carrying ALL of the
    given labels — the analogue of the reference's per-object metric
    deletion when a job/queue is removed (metrics/job.go)."""
    match = set(labels.items())
    with _lock:
        for store in (_gauges, _counters, _observations, _obs_totals):
            for key in [k for k in store if match <= set(k[1])]:
                del store[key]


def swap_gauge_families(families, rows, **scope):
    """Atomically replace whole gauge families: under ONE lock, drop
    every existing series whose metric name is in *families* (one scan
    of the registry), then install *rows* ([(name, labels-dict, value)]).
    A concurrent /metrics scrape sees either the old or the new export,
    never a half-cleared family.

    *scope* labels narrow the drop to series carrying ALL of them —
    how per-node exporters (several node agents in one process, e.g.
    the bandwidth families) replace only THEIR slice of a family
    instead of clobbering each other's every sync."""
    families = set(families)
    match = set(scope.items())
    with _lock:
        for key in [k for k in _gauges
                    if k[0] in families and match <= set(k[1])]:
            del _gauges[key]
        for name, labels, value in rows:
            _gauges[_key(name, labels)] = value


def resource_gauge_rows(prefix: str, res, **labels):
    """Rows for one resource vector in the reference's per-dimension
    queue gauge shape: <prefix>_milli_cpu, <prefix>_memory_bytes, and
    <prefix>_scalar_resources{resource=...} per scalar dimension
    (metrics/queue.go).  Feed to swap_gauge_families."""
    rows = [(f"{prefix}_milli_cpu", dict(labels), res.milli_cpu),
            (f"{prefix}_memory_bytes", dict(labels), res.memory)]
    for dim, val in res.res.items():
        if dim in ("cpu", "memory", "pods"):
            continue
        rows.append((f"{prefix}_scalar_resources",
                     dict(labels, resource=dim), val))
    return rows


def get_observations(name: str, **labels) -> List[float]:
    with _lock:
        return list(_observations.get(_key(name, labels), []))


def get_counter(name: str, **labels) -> float:
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def quantile(name: str, q: float, **labels) -> float:
    obs = sorted(get_observations(name, **labels))
    if not obs:
        return 0.0
    idx = min(len(obs) - 1, int(q * len(obs)))
    return obs[idx]


def reset():
    with _lock:
        _observations.clear()
        _counters.clear()
        _gauges.clear()
        _obs_totals.clear()


def write_exposition(handler) -> None:
    """Write the Prometheus text exposition as an HTTP response on a
    BaseHTTPRequestHandler (shared by serve() and the state server)."""
    body = dump().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def serve(port: int = 0):
    """Expose /metrics over HTTP (Prometheus scrape endpoint analogue;
    reference: per-binary Prometheus registries).  Returns the server —
    call .shutdown() to stop; port 0 picks a free port
    (server.server_address[1])."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            write_exposition(self)

        def log_message(self, *args):  # quiet
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping (the exposition
    format's only three escapes): a node name or free-text reason
    carrying a quote, backslash or newline must not corrupt the
    scrape output."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)


def dump() -> str:
    """Prometheus text exposition."""
    lines = []
    with _lock:
        for (name, labels), value in sorted(_gauges.items()):
            lbl = _label_str(labels)
            lines.append(f"{name}{{{lbl}}} {value}" if lbl
                         else f"{name} {value}")
        for (name, labels), value in sorted(_counters.items()):
            lbl = _label_str(labels)
            lines.append(f"{name}{{{lbl}}} {value}" if lbl
                         else f"{name} {value}")
        for (name, labels), obs in sorted(_observations.items()):
            lbl = _label_str(labels)
            suffix = f"{{{lbl}}}" if lbl else ""
            count, total = _obs_totals[(name, labels)]
            lines.append(f"{name}_count{suffix} {count}")
            lines.append(f"{name}_sum{suffix} {total}")
    return "\n".join(lines) + "\n"

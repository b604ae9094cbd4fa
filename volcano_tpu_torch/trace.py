"""Scheduling flight recorder — span trees, phase stamps, why-pending.

The metrics registry (metrics.py) can *count*; this module *attributes*:

* **Spans**: every scheduler session opens a root span; actions, the
  per-job allocation attempts inside them, and session open/close are
  timed child spans.  Plugin callbacks (predicate / nodeOrder /
  jobOrder / ...) are aggregated per (plugin, extension point) under
  the innermost open span — one span per plugin per point, carrying a
  call count, NOT one span per call (a 20k-host predicate sweep runs
  hundreds of thousands of callbacks; per-call spans would cost more
  than the scheduling they measure).
* **Phase stamps**: lifecycle timestamps stamped on pod/podgroup
  annotations (created -> enqueued -> allocated -> bound -> admitted
  -> running) that ride the existing wire objects, so any mirror can
  decompose a pod's end-to-end latency into per-phase segments whose
  sum telescopes to the total — the reconciliation invariant
  (docs/design/tracing.md).
* **Unschedulable reasons**: free-text fit-error messages are
  normalized to a BOUNDED enum for aggregation and metric labels
  (cardinality rule: enums label metrics, free text rides only in
  trace payloads), aggregated per job as reason -> distinct-node
  count, published on the podgroup for `vtpctl explain`.
* **Ring + sampling**: completed session traces land in a bounded
  in-process ring (and are POSTed to the state server's ring in wire
  mode).  Sessions with unschedulable jobs or slower than the rolling
  p95 are always kept; the rest are 1-in-SAMPLE_EVERY sampled.

Zero-dependency and always-on: the hot-path cost is two
perf_counter() reads per plugin callback, paid only while a session
span is open on the calling thread.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import metrics

# -- lifecycle phases --------------------------------------------------

TS_PREFIX = "trace.volcano-tpu.io/ts-"
PHASES = ("created", "enqueued", "allocated", "bound", "admitted",
          "running")
# segment name -> (from stamp, to stamp); gaps telescope: the segment
# sum equals running - created whenever every stamp exists
SEGMENTS: Tuple[Tuple[str, str, str], ...] = (
    ("queue", "created", "enqueued"),
    ("schedule", "enqueued", "allocated"),
    ("bind", "allocated", "bound"),
    ("admit", "bound", "admitted"),
    ("start", "admitted", "running"),
)

PENDING_REASONS_ANNOTATION = "trace.volcano-tpu.io/pending-reasons"


def stamp_phase(annotations: Dict[str, str], phase: str,
                ts: Optional[float] = None) -> None:
    """Record a phase transition timestamp once (first writer wins: a
    retried create / re-delivered watch event must not move it)."""
    key = TS_PREFIX + phase
    if key not in annotations:
        annotations[key] = f"{time.time() if ts is None else ts:.6f}"


def phase_ts(annotations: Dict[str, str], phase: str) -> Optional[float]:
    raw = annotations.get(TS_PREFIX + phase)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def phase_segments(pod_annotations: Dict[str, str],
                   pg_annotations: Optional[Dict[str, str]] = None
                   ) -> Dict[str, float]:
    """Per-phase latency segments for one pod, in seconds.

    The `enqueued` stamp lives on the PODGROUP (one gang admission,
    not N pod writes); pass its annotations to include the queue /
    schedule split.  Stamps missing from the middle of the chain
    collapse into the next present segment (the gap is attributed to
    the first phase that can observe it), so the telescoping sum
    `running - created` holds for any stamp subset.  Small negative
    gaps (cross-process clock skew on the allocated stamp) clamp to 0
    and push the skew into the next segment — the sum is preserved.
    """
    stamps: Dict[str, float] = {}
    for phase in PHASES:
        ts = phase_ts(pod_annotations, phase)
        if ts is None and pg_annotations is not None:
            ts = phase_ts(pg_annotations, phase)
        if ts is not None:
            stamps[phase] = ts
    out: Dict[str, float] = {}
    prev: Optional[float] = stamps.get("created")
    for seg, _frm, to in SEGMENTS:
        ts = stamps.get(to)
        if prev is None or ts is None:
            continue
        out[seg] = max(0.0, ts - prev)
        prev = max(prev, ts)
    return out


def observe_phase_metrics(pod_annotations: Dict[str, str],
                          pg_annotations: Optional[Dict[str, str]] = None
                          ) -> Dict[str, float]:
    """Feed one pod's segments into sched_phase_seconds{phase=...}."""
    segs = phase_segments(pod_annotations, pg_annotations)
    for seg, dur in segs.items():
        metrics.observe("sched_phase_seconds", dur, phase=seg)
    if segs:
        metrics.observe("sched_phase_seconds", sum(segs.values()),
                        phase="e2e")
    return segs


# -- unschedulable-reason normalization --------------------------------

# The bounded enum metric labels / aggregates use.  Free-text node
# messages NEVER become labels — they ride in trace payloads and the
# podgroup annotation's `detail` samples only.
REASON_ENUM = (
    "elastic-waiting-for-capacity",
    # a serving group's SLO burst is waiting on GPUs (the scale-up is
    # pending while the serving-aware shrink frees an adjacent block)
    "serving-slo-pressure",
    # a training gang shrunk to fund that scale-up, re-placing off its
    # NVLink-adjacent domains (the elastic plugin's avoid filter)
    "serving-preemption-victim",
    "quarantined",
    "node-affinity-mismatch",
    "taint-not-tolerated",
    "node-not-ready",
    "insufficient-resources",
    "gpu-shape-mismatch",
    "nvlink-shape-mismatch",
    "port-conflict",
    "pod-limit",
    "spread-skew",
    "pod-affinity-mismatch",
    "usage-over-threshold",
    "warm-spare-reserved",
    "queue-share-exceeded",
    "scheduling-gated",
    "gang-not-ready",
    "numa-mismatch",
    # a scheduler shard lost the server's check-and-bind arbitration
    # to another shard's optimistic cross-subtree gang (per-item 409);
    # the gang re-queues through the loser's next cycle
    "cross-shard-conflict",
    # a drained gang parked by the federation router mid cross-region
    # cutover (api/elastic.py evacuate contract): the source enqueue
    # gate holds it out of INQUEUE so the local scheduler never races
    # the destination region's re-place
    "evacuating-region",
    "other",
)

# keyword -> enum, first match wins (ordered: specific before generic)
_REASON_RULES: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    # before the generic rules: an elastic gang parked at its floor
    # names the wait explicitly (actions/elastic.py records it).
    # Keyed on the message PREFIX, not the bare word "elastic" — the
    # migration predicate's "slice vacated by elastic migration" must
    # not read as a capacity wait
    (("elastic: waiting", "waiting for capacity"),
     "elastic-waiting-for-capacity"),
    # before the generic rules: the serving plugin's pressure marker
    # and the avoid-filter message a shrunk victim sees while steered
    # off the slices it freed for the serving pool
    (("serving: slo pressure",), "serving-slo-pressure"),
    (("freed for serving",), "serving-preemption-victim"),
    # before the device/insufficient rules: the flush_binds loser path
    # prefixes the server's 409 refusal ("bind overcommit: node ...")
    # with this marker when a subtree shard plan is active
    (("cross-shard",), "cross-shard-conflict"),
    # before the generic rules: the enqueue hold the federation
    # cutover stamps ("evacuating to region ...")
    (("evacuat",), "evacuating-region"),
    (("quarantin",), "quarantined"),
    (("warm spare",), "warm-spare-reserved"),
    (("node selector", "node affinity", "nodegroup", "affinity "),
     "node-affinity-mismatch"),
    (("taint",), "taint-not-tolerated"),
    (("not ready",), "node-not-ready"),
    (("hypernode", "tier", "topology"), "nvlink-shape-mismatch"),
    # before the device rule: "Insufficient cpu, nvidia.com/gpu" is a
    # resource shortfall even when a GPU dim is among the missing
    (("insufficient",), "insufficient-resources"),
    (("gpu", "chip"), "gpu-shape-mismatch"),
    (("port",), "port-conflict"),
    (("too many pods", "pod count"), "pod-limit"),
    (("skew", "spread"), "spread-skew"),
    (("anti-affinity", "pod affinity", "affinity term"),
     "pod-affinity-mismatch"),
    (("usage", "threshold"), "usage-over-threshold"),
    (("queue", "share", "quota", "deserved"), "queue-share-exceeded"),
    (("scheduling gate",), "scheduling-gated"),
    (("gang", "minavailable", "min available"), "gang-not-ready"),
    (("numa",), "numa-mismatch"),
    (("resource",), "insufficient-resources"),
)


def normalize_reason(text: str) -> str:
    """Free-text fit-error message -> bounded enum slug."""
    low = (text or "").lower()
    for keywords, slug in _REASON_RULES:
        if any(k in low for k in keywords):
            return slug
    return "other"


def aggregate_job_reasons(job) -> Tuple[Dict[str, int], Dict[str, str]]:
    """(reason -> distinct-node count, reason -> one sample message)
    from a JobInfo's recorded fit errors.  Node-less errors (queue
    share, scheduling gates, job-level messages) count as 1."""
    nodes_by_reason: Dict[str, set] = {}
    samples: Dict[str, str] = {}

    def note(reason_text: str, node_name: str) -> None:
        slug = normalize_reason(reason_text)
        nodes_by_reason.setdefault(slug, set()).add(node_name)
        samples.setdefault(slug, reason_text)

    for errs in job.fit_errors.values():
        for node_name, fe in errs.nodes.items():
            for r in set(fe.reasons()) or {"node(s) didn't fit"}:
                note(r, node_name)
        if errs.err:
            note(errs.err, "")
    jfe = getattr(job, "job_fit_errors", None)
    if jfe is not None and jfe.err and not nodes_by_reason:
        note(jfe.err, "")
    counts = {slug: len(nodes) for slug, nodes in nodes_by_reason.items()}
    return counts, samples


TOP_K_REASONS = 8


def pending_reasons_doc(counts: Dict[str, int],
                        samples: Dict[str, str]) -> dict:
    """The podgroup-annotation / trace payload shape: top-K reasons by
    node count, with one free-text sample each (detail)."""
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    top = top[:TOP_K_REASONS]
    return {
        "reasons": dict(top),
        "top": top[0][0] if top else "",
        "detail": {slug: samples.get(slug, "")[:200] for slug, _ in top},
    }


# -- span model --------------------------------------------------------

MAX_CHILDREN = 128      # per span: a churn-heavy cycle caps its tree


class Span:
    __slots__ = ("name", "kind", "labels", "start", "end", "children",
                 "agg", "dropped")

    def __init__(self, name: str, kind: str, labels: Dict[str, str]):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.start = time.time()
        self.end: Optional[float] = None
        self.children: List["Span"] = []
        # (point, plugin) -> [calls, total seconds]; folded into child
        # spans when this span closes
        self.agg: Dict[Tuple[str, str], list] = {}
        self.dropped = 0

    @property
    def duration(self) -> float:
        return (self.end or time.time()) - self.start

    def add_child(self, child: "Span") -> bool:
        if len(self.children) >= MAX_CHILDREN:
            self.dropped += 1
            return False
        self.children.append(child)
        return True

    def close(self) -> None:
        self.end = time.time()
        for (point, plugin), (calls, total) in sorted(self.agg.items()):
            child = Span(plugin, "plugin",
                         {"point": point, "calls": str(calls)})
            child.start = self.start
            child.end = self.start + total
            self.add_child(child)
        self.agg.clear()

    def to_dict(self) -> dict:
        doc = {"name": self.name, "kind": self.kind,
               "labels": dict(self.labels),
               "start": round(self.start, 6),
               "dur": round(self.duration, 6)}
        if self.children:
            doc["children"] = [c.to_dict() for c in self.children]
        if self.dropped:
            doc["dropped_children"] = self.dropped
        return doc


class _SpanCtx:
    """Context manager pushing/popping one span on the thread stack."""

    __slots__ = ("span",)

    def __init__(self, span: Optional[Span]):
        self.span = span

    def __enter__(self):
        return self.span

    def __exit__(self, *exc):
        if self.span is not None:
            _pop(self.span)
        return False


# -- tracer state ------------------------------------------------------

TRACE_RING = 256         # completed session traces kept in-process
SAMPLE_EVERY = 8         # 1-in-N for unremarkable sessions
_P95_WINDOW = 128        # rolling duration window for the slow gate

_tls = threading.local()
_lock = threading.Lock()
_ring: deque = deque(maxlen=TRACE_RING)
_durations: deque = deque(maxlen=_P95_WINDOW)
_pending: Dict[str, dict] = {}      # job key -> pending_reasons_doc
_seq = 0


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _pop(span: Span) -> None:
    stack = _stack()
    while stack:
        top = stack.pop()
        top.close()
        if top is span:
            break


def current() -> Optional[Span]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def begin_session(**labels) -> Span:
    """Open a session root span on this thread (scheduler.run_once)."""
    root = Span("session", "session",
                {k: str(v) for k, v in labels.items()})
    stack = _stack()
    del stack[:]             # a leaked previous root must not nest
    stack.append(root)
    return root


def span(name: str, kind: str = "span", **labels) -> _SpanCtx:
    """Timed child span under the innermost open span; no-op (None)
    when no session is open on this thread."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return _SpanCtx(None)
    s = Span(name, kind, {k: str(v) for k, v in labels.items()})
    if stack[-1].add_child(s):
        stack.append(s)
        return _SpanCtx(s)
    return _SpanCtx(None)


def add_plugin_time(point: str, plugin: str, dt: float) -> None:
    """Accumulate one plugin-callback timing under the innermost open
    span (the hot-path aggregation lane: O(1) dict update)."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    agg = stack[-1].agg
    slot = agg.get((point, plugin))
    if slot is None:
        agg[(point, plugin)] = [1, dt]
    else:
        slot[0] += 1
        slot[1] += dt


def note_pending(job_key: str, counts: Dict[str, int],
                 samples: Dict[str, str]) -> dict:
    """Record a job's aggregated unschedulable reasons (called by the
    job updater once per session per blocked job).  Bumps the current
    session root's unschedulable tally for the sampling gate."""
    doc = pending_reasons_doc(counts, samples)
    with _lock:
        _pending[job_key] = doc
    stack = getattr(_tls, "stack", None)
    if stack:
        root = stack[0]
        root.labels["unschedulable_jobs"] = str(
            int(root.labels.get("unschedulable_jobs", "0")) + 1)
    top = doc["top"]
    if top:
        metrics.inc("sched_unschedulable_reasons_total", reason=top)
    return doc


def clear_pending(job_key: str) -> None:
    with _lock:
        _pending.pop(job_key, None)


def retain_pending(job_keys) -> None:
    """Drop aggregate entries for jobs no longer blocked THIS session
    (deleted jobs, jobs that placed): the job updater calls this with
    the still-blocked set each cycle so the aggregate never leaks."""
    keep = set(job_keys)
    with _lock:
        for key in [k for k in _pending if k not in keep]:
            del _pending[key]


def pending_reasons() -> Dict[str, dict]:
    """Current per-job aggregate (dumper / vtpctl explain source)."""
    with _lock:
        return {k: dict(v) for k, v in _pending.items()}


def _emit_span_metrics(root: Span) -> None:
    """sched_span_seconds observations off a finished session tree:
    action spans labeled by action, plugin aggregates by plugin+point
    (both label sets are bounded enums — registered names only)."""
    def walk(s: Span) -> None:
        if s.kind == "action":
            metrics.observe("sched_span_seconds", s.duration,
                            action=s.name)
        elif s.kind == "plugin":
            metrics.observe("sched_span_seconds", s.duration,
                            plugin=s.name,
                            point=s.labels.get("point", ""))
        for c in s.children:
            walk(c)
    walk(root)
    metrics.observe("sched_span_seconds", root.duration,
                    action="session")


def _p95(values: deque) -> float:
    if not values:
        return float("inf")
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


# per-doc embedding caps: a cluster with thousands of blocked jobs
# makes every session kept — the doc (ring entry + POST /trace body)
# must stay bounded regardless
MAX_DOC_JOBS = 256
MAX_DOC_PENDING = 64


def end_session(root: Span, jobs_pending: Optional[List[str]] = None
                ) -> Optional[dict]:
    """Close the root, emit metrics, and apply the keep policy.

    Returns the trace document when the session was kept (caller may
    publish it to the state server), else None.  Keep policy: always
    for sessions that errored, saw unschedulable jobs, or ran slower
    than the rolling p95; 1-in-SAMPLE_EVERY otherwise.
    """
    global _seq
    _pop(root)               # closes any spans left open by an error
    if root.end is None:
        root.close()
    _emit_span_metrics(root)
    dur = root.duration
    unsched = int(root.labels.get("unschedulable_jobs", "0"))
    errored = "error" in root.labels
    # federated episodes are rare (in-flight cross-region gangs) but
    # every fragment is load-bearing for the /fleet_trace stitch: a
    # sampled-away placement session would leave a hole in the
    # cross-plane tree, so episode-labelled sessions are always kept
    episodic = bool(root.labels.get("episode"))
    keys = sorted(set(jobs_pending or []))
    with _lock:
        _seq += 1
        seq = _seq
        slow = dur >= _p95(_durations) and len(_durations) >= 16
        _durations.append(dur)
        keep = errored or unsched > 0 or slow or episodic \
            or seq % SAMPLE_EVERY == 1
        if not keep:
            return None
        # embed only THIS session's jobs and their aggregates, capped:
        # the global _pending can be huge and belongs to the dumper,
        # not to every per-cycle wire payload
        pending = {k: dict(_pending[k])
                   for k in keys[:MAX_DOC_PENDING] if k in _pending}
        doc = {"seq": seq, "kept_because":
               ("error" if errored else
                "unschedulable" if unsched else
                "slow" if slow else
                "episode" if episodic else "sampled"),
               "jobs": keys[:MAX_DOC_JOBS],
               "pending": pending,
               "root": root.to_dict()}
        if len(keys) > MAX_DOC_JOBS:
            doc["jobs_truncated"] = len(keys) - MAX_DOC_JOBS
        _ring.append(doc)
    metrics.inc("sched_traces_total", kept=doc["kept_because"])
    return doc


def recent_traces(limit: int = 0, job: str = "",
                  episode: str = "") -> List[dict]:
    """Newest-last kept traces; job filters to traces that touched or
    pended the given job key, episode to this plane's fragments of
    one federated causal episode."""
    with _lock:
        out = list(_ring)
    if job:
        out = [t for t in out if matches_job(t, job)]
    if episode:
        out = [t for t in out if matches_episode(t, episode)]
    if limit:
        out = out[-limit:]
    return out


def is_complete_span(span_doc) -> bool:
    """A span tree is complete when every node carries a name and a
    duration — the single definition of the never-serve-half-a-tree
    rule (state server POST /trace gate; soak drill assertion)."""
    if not isinstance(span_doc, dict) or "dur" not in span_doc \
            or "name" not in span_doc:
        return False
    return all(is_complete_span(c)
               for c in span_doc.get("children", ()))


def matches_job(trace_doc: dict, job: str) -> bool:
    """Did this kept session trace touch / pend the given job key?"""
    return (job in trace_doc.get("jobs", [])
            or job in trace_doc.get("pending", {})
            or _mentions_job(trace_doc.get("root"), job))


def _mentions_job(span_doc: Optional[dict], job: str) -> bool:
    if not span_doc:
        return False
    if span_doc.get("labels", {}).get("job") == job:
        return True
    return any(_mentions_job(c, job)
               for c in span_doc.get("children", ()))


def matches_episode(trace_doc: dict, episode: str) -> bool:
    """Is this doc a local fragment of the given causal episode?  A
    session root may carry several episodes (comma-joined label) —
    one scheduling cycle can place gangs from distinct episodes."""
    if not episode:
        return False
    if trace_doc.get("episode") == episode:
        return True
    return _mentions_episode(trace_doc.get("root"), episode)


def _mentions_episode(span_doc: Optional[dict], episode: str) -> bool:
    if not span_doc:
        return False
    raw = span_doc.get("labels", {}).get("episode", "")
    if episode in [e.strip() for e in raw.split(",") if e.strip()]:
        return True
    return any(_mentions_episode(c, episode)
               for c in span_doc.get("children", ()))


def episode_label(episodes) -> str:
    """The bounded session-root `episode` label value: sorted unique
    comma join, capped — labels ride every trace doc, so one cycle
    placing many federated gangs must not grow an unbounded string."""
    eps = sorted({e for e in episodes if e})
    return ",".join(eps[:8])


def fragment_doc(name: str, plane: str, episode: str, start: float,
                 end: float, hop: int = 0, jobs=(), labels=None,
                 children=()) -> dict:
    """A complete single-plane episode fragment in ring-doc shape —
    how the router and controllers (which run no scheduler session)
    contribute their slice of a causal episode to /traces.  Children
    are (name, start, end) triples; everything is closed at build
    time so the state server's is_complete_span gate always passes."""
    lbl = {"plane": plane, "episode": episode, "hop": str(int(hop))}
    lbl.update(labels or {})
    end = max(end, start)
    root = {"name": name, "kind": "fragment", "labels": lbl,
            "start": start, "dur": end - start}
    kids = []
    for cname, cs, ce in children:
        kids.append({"name": cname, "kind": "span", "labels": {},
                     "start": cs, "dur": max(0.0, ce - cs)})
    if kids:
        root["children"] = kids
    return {"seq": 0, "kept_because": "episode", "episode": episode,
            "jobs": sorted(set(jobs)), "pending": {}, "root": root}


def publish(cluster, doc: Optional[dict]) -> None:
    """Best-effort POST of a kept trace to the state server's ring
    (wire mode only; in-process clusters read recent_traces())."""
    if doc is None:
        return
    request = getattr(cluster, "_request", None)
    if request is None:
        return
    try:
        request("POST", "/trace", {"trace": doc}, deadline=2.0)
    except Exception:  # noqa: BLE001 — traces are advisory telemetry
        pass


def reset() -> None:
    """Test isolation: drop ring, pending aggregate and thread stack."""
    global _seq
    with _lock:
        _ring.clear()
        _durations.clear()
        _pending.clear()
        _seq = 0
    _tls.stack = []


# -- rendering (vtpctl trace / trace_report) ---------------------------

def render_waterfall(span_doc: dict, total: Optional[float] = None,
                     indent: int = 0, width: int = 28) -> List[str]:
    """Text waterfall of one span tree: offset bars + durations."""
    lines = []
    total = total or max(span_doc.get("dur", 0.0), 1e-9)
    t0 = span_doc.get("start", 0.0)

    def walk(doc: dict, depth: int) -> None:
        off = max(0.0, doc.get("start", t0) - t0)
        dur = doc.get("dur", 0.0)
        lead = int(width * min(1.0, off / total))
        bar = max(1, int(width * min(1.0, dur / total)))
        gauge = " " * lead + "#" * min(bar, width - lead)
        label = doc.get("name", "?")
        extras = [f"{k}={v}" for k, v in sorted(
            doc.get("labels", {}).items()) if v]
        lines.append(
            f"{'  ' * depth}{label:<{max(4, 24 - 2 * depth)}} "
            f"|{gauge:<{width}}| {dur * 1e3:8.2f}ms"
            + (f"  {' '.join(extras)}" if extras else ""))
        for child in doc.get("children", ()):
            walk(child, depth + 1)
        if doc.get("dropped_children"):
            lines.append(f"{'  ' * (depth + 1)}"
                         f"(+{doc['dropped_children']} spans dropped)")

    walk(span_doc, indent)
    return lines


def to_chrome_trace(traces: List[dict]) -> dict:
    """Chrome-trace/Perfetto JSON (trace event format, complete 'X'
    events in microseconds) from a list of kept session trace docs —
    load the output at chrome://tracing or ui.perfetto.dev."""
    events = []

    def walk(doc: dict, pid: int, tid: int) -> None:
        args = {k: v for k, v in doc.get("labels", {}).items() if v}
        events.append({
            "name": doc.get("name", "?"),
            "cat": doc.get("kind", "span"),
            "ph": "X",
            "ts": round(doc.get("start", 0.0) * 1e6, 1),
            "dur": round(doc.get("dur", 0.0) * 1e6, 1),
            "pid": pid, "tid": tid, "args": args,
        })
        for child in doc.get("children", ()):
            walk(child, pid, tid)

    for i, trace in enumerate(traces):
        root = trace.get("root") or {}
        walk(root, 1, i + 1)
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": i + 1, "args": {
                           "name": f"session seq={trace.get('seq')}"
                                   f" ({trace.get('kept_because')})"}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_state() -> dict:
    """The dumper's (SIGUSR2) trace section: last-N kept traces +
    the live per-job unschedulable aggregate."""
    return {"recent_traces": recent_traces(limit=8),
            "pending_reasons": pending_reasons()}


def parse_annotation(raw: str) -> Optional[dict]:
    """Tolerant parse of the pending-reasons podgroup annotation."""
    try:
        doc = json.loads(raw)
    except (TypeError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None

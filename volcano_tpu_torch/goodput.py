"""Goodput observatory — the scheduler-side half of the measurement
loop (docs/design/goodput.md).

The flight recorder (trace.py) attributes *scheduler* latency; this
module measures *workload* throughput and what the scheduler's
placements leave behind:

* **ThroughputBook** — an online per-(job, GPU-generation)
  throughput-vector estimator fed by the SchedulerCache from folded
  podgroup goodput annotations (the Gavel substrate, arxiv
  2008.09213: a job's step rate differs per GPU generation; the
  recorder LEARNS the vector from observed step rates instead of
  asking the submitter).  It also tracks measured step rate per
  WORLD SIZE, which is what the elastic action's goodput grow gate
  consumes (the minimal Pollux step, arxiv 2008.12260: decline a
  grow when the last grow's measured marginal speedup fell below
  threshold).

* **Session gauges** — per scheduling session: the NVLink
  fragmentation index per generation (largest placeable whole-domain
  block vs total idle GPUs — how much of the idle pool a
  topology-contiguous gang could actually take) and per-queue
  starvation age (oldest feasible-but-pending gang, riding the flight
  recorder's phase stamps and reason aggregation).

Cardinality rule (trace.py's): every label on the goodput_*/frag_*/
starvation_* families is bounded — generation is the GENERATIONS
enum, decision is allowed|declined, queue is the operator's queue
config.  Job keys, pod names and node names NEVER label these
families; per-job detail rides podgroup annotations and GoodputReport
objects.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api.goodput import (
    PG_ALLOCATED_S_ANNOTATION,
    PG_PRODUCTIVE_S_ANNOTATION,
    PG_STEP_RATE_ANNOTATION,
    ann_float,
    generation_of,
)
from volcano_tpu_torch.api.resource import GPU

# gauge families swapped whole per session (scheduler process only)
SESSION_GAUGE_FAMILIES = (
    "goodput_jobs", "goodput_fleet_steps_per_second",
    "goodput_fraction", "frag_index", "frag_idle_chips",
    "frag_largest_block_chips", "starvation_age_seconds",
    "starvation_pending_gangs",
)

GATE_DECISIONS = ("allowed", "declined")

# reasons that mean "the cluster could serve this gang, it just has
# not" — the starvation gauge counts gangs pending on THESE, not on
# constraints no amount of waiting fixes (affinity to a node that
# does not exist, malformed specs -> other)
_FEASIBLE_REASONS = frozenset((
    "insufficient-resources", "elastic-waiting-for-capacity",
    "gang-not-ready", "queue-share-exceeded", "nvlink-shape-mismatch",
    "warm-spare-reserved", "usage-over-threshold",
))


class _Ewma:
    __slots__ = ("rate", "updates", "last_ts", "last_value")

    def __init__(self):
        self.rate = 0.0
        self.updates = 0
        self.last_ts = 0.0
        self.last_value = None

    def fold(self, value: float, alpha: float) -> None:
        self.rate = value if self.updates == 0 else \
            alpha * value + (1 - alpha) * self.rate
        self.updates += 1
        self.last_value = value


class ThroughputBook:
    """Online per-(job, generation) and per-(job, world-size) step-
    rate estimator.  Thread-safe: the cache's watch thread writes,
    scheduler sessions and the dumper read.  One book lives on the
    SchedulerCache and is exposed to plugins/actions as
    `session.goodput` via the snapshot."""

    ALPHA = 0.3

    def __init__(self, alpha: float = ALPHA):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        # job -> generation -> _Ewma
        self._vectors: Dict[str, Dict[str, _Ewma]] = {}
        # job -> world size (slices) -> _Ewma
        self._sizes: Dict[str, Dict[int, _Ewma]] = {}

    def note(self, job: str, generation: str, rate: float,
             slices: int, ts: float = 0.0) -> bool:
        """Fold one observed step rate; returns False when the
        observation was a duplicate or vacuous.  Duplicate = same
        fold timestamp AND same value (a watch re-delivery of an
        unchanged annotation); a changed value under an unchanged
        stamp is new data — the store max-merges the stamp, so a
        behind-wall-clock node's folds move the rate, not the ts."""
        if not job or rate <= 0:
            return False
        with self._lock:
            vec = self._vectors.setdefault(job, {})
            ent = vec.setdefault(generation, _Ewma())
            if ts and ts <= ent.last_ts and rate == ent.last_value:
                return False          # watch re-delivery: no new data
            ent.fold(rate, self.alpha)
            if ts:
                ent.last_ts = max(ent.last_ts, ts)
            if slices > 0:
                sz = self._sizes.setdefault(job, {})
                sent = sz.setdefault(int(slices), _Ewma())
                sent.fold(rate, self.alpha)
                if ts:
                    sent.last_ts = max(sent.last_ts, ts)
        metrics.inc("goodput_vector_updates_total",
                    generation=generation)
        return True

    def forget(self, job: str) -> None:
        with self._lock:
            self._vectors.pop(job, None)
            self._sizes.pop(job, None)

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._vectors)

    def vector(self, job: str) -> Dict[str, float]:
        """generation -> learned steps/s for one job."""
        with self._lock:
            return {g: e.rate
                    for g, e in self._vectors.get(job, {}).items()}

    def rate(self, job: str) -> float:
        """The job's best current estimate across generations (a gang
        occupies one generation at a time; the freshest entry wins)."""
        with self._lock:
            ents = self._vectors.get(job, {})
            if not ents:
                return 0.0
            return max(ents.values(),
                       key=lambda e: (e.last_ts, e.updates)).rate

    def rate_at(self, job: str, slices: int
                ) -> Optional[Tuple[float, int]]:
        """(rate, updates) observed at the given world size."""
        with self._lock:
            ent = self._sizes.get(job, {}).get(int(slices))
            return (ent.rate, ent.updates) if ent else None

    def grow_verdict(self, job: str, cur_slices: int,
                     frac: float = 0.5,
                     min_updates: int = 2) -> Optional[bool]:
        """Should this job be granted ANOTHER slice, judged by the
        marginal throughput its LAST grow actually bought?

        Returns None with no opinion (either size unmeasured — never
        block a job the observatory has no data on), True when the
        measured speedup from the largest smaller measured size to
        the current size is at least `1 + frac * (linear - 1)`, False
        when the last grow measurably failed to pay for itself."""
        with self._lock:
            sizes = self._sizes.get(job)
            if not sizes:
                return None
            cur = sizes.get(int(cur_slices))
            if cur is None or cur.updates < min_updates:
                return None
            prevs = [s for s, e in sizes.items()
                     if s < cur_slices and e.updates >= min_updates]
            if not prevs:
                return None
            prev = max(prevs)
            prev_rate = sizes[prev].rate
            if prev_rate <= 0:
                return None
            expected = cur_slices / prev
            speedup = cur.rate / prev_rate
        return speedup >= 1.0 + frac * (expected - 1.0)

    def dump_state(self) -> dict:
        """The dumper's (SIGUSR2) goodput section."""
        with self._lock:
            return {
                "vectors": {
                    job: {g: round(e.rate, 4)
                          for g, e in vec.items()}
                    for job, vec in sorted(self._vectors.items())},
                "rates_by_world_size": {
                    job: {str(s): round(e.rate, 4)
                          for s, e in sz.items()}
                    for job, sz in sorted(self._sizes.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._vectors.clear()
            self._sizes.clear()


# -- NVLink fragmentation ----------------------------------------------

class SliceStat:
    __slots__ = ("name", "domain", "generation", "chips", "idle_chips",
                 "whole_idle")

    def __init__(self, name: str, domain: str, generation: str):
        self.name = name
        self.domain = domain
        self.generation = generation
        self.chips = 0.0
        self.idle_chips = 0.0
        self.whole_idle = True     # every host ready + fully chip-idle


def _slice_stats_from_session(ssn) -> List[SliceStat]:
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    stats: Dict[str, SliceStat] = {}
    for node in ssn.nodes.values():
        raw = node.node
        if raw is None:
            continue
        sl = raw.labels.get(GPU_CLIQUE_LABEL)
        if not sl:
            continue
        st = stats.get(sl)
        if st is None:
            st = stats[sl] = SliceStat(
                sl, raw.labels.get(IB_FABRIC_LABEL, ""),
                generation_of(raw.labels))
        chips = float(node.allocatable.get(GPU))
        used = float(node.used.get(GPU))
        st.chips += chips
        st.idle_chips += max(0.0, chips - used)
        if used > 0 or node.tasks or not node.ready:
            st.whole_idle = False
    return list(stats.values())


def _node_frag_contrib(node) -> Optional[tuple]:
    """One node's contribution to its slice's fragmentation stats:
    (slice, domain, generation, chips, idle, bad) — *bad* is 1 when
    the node breaks the slice's whole-idle property.  None for nodes
    outside any slice."""
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    raw = node.node
    if raw is None:
        return None
    sl = raw.labels.get(GPU_CLIQUE_LABEL)
    if not sl:
        return None
    chips = float(node.allocatable.get(GPU))
    used = float(node.used.get(GPU))
    bad = 1 if (used > 0 or node.tasks or not node.ready) else 0
    return (sl, raw.labels.get(IB_FABRIC_LABEL, ""),
            generation_of(raw.labels), chips,
            max(0.0, chips - used), bad)


def _slice_stats_incremental(ssn) -> Optional[List[SliceStat]]:
    """Slice stats off a per-node contribution memo kept on the
    scheduler cache, updated only for nodes the snapshot delta or
    this session's own mutations touched — the observe pass used to
    re-walk all 100k nodes every cycle.  Returns None when there is
    no cache/delta to key the memo on (bare harness sessions) so the
    caller falls back to the full walk."""
    cache = getattr(ssn, "cache", None)
    delta = getattr(cache, "last_delta", None)
    if delta is None:
        return None
    memo = getattr(cache, "_frag_memo", None)
    contrib: Dict[str, tuple]
    if memo is None or delta.full or \
            memo[0] not in (delta.gen - 1, delta.gen):
        contrib = {}
        agg: Dict[str, list] = {}
        for name, node in ssn.nodes.items():
            c = _node_frag_contrib(node)
            if c is None:
                continue
            contrib[name] = c
            _frag_fold(agg, c, 1)
    else:
        _gen, contrib, agg = memo
        changed = set(delta.changed_nodes)
        changed.update(delta.removed_nodes)
        changed.update(getattr(ssn, "touched_nodes", ()))
        for name in changed:
            old = contrib.pop(name, None)
            if old is not None:
                _frag_fold(agg, old, -1)
            node = ssn.nodes.get(name)
            if node is None:
                continue
            c = _node_frag_contrib(node)
            if c is not None:
                contrib[name] = c
                _frag_fold(agg, c, 1)
    cache._frag_memo = (delta.gen, contrib, agg)
    out = []
    for sl, row in agg.items():
        st = SliceStat(sl, row[0], row[1])
        st.chips = row[2]
        st.idle_chips = row[3]
        st.whole_idle = row[4] == 0
        out.append(st)
    return out


def _frag_fold(agg: Dict[str, list], c: tuple, sign: int) -> None:
    sl, domain, gen, chips, idle, bad = c
    row = agg.get(sl)
    if row is None:
        row = agg[sl] = [domain, gen, 0.0, 0.0, 0, 0]
    elif sign > 0:
        # a refreshed contribution carries the slice's CURRENT
        # domain/generation labels — an in-place relabel must not
        # stay attributed to the retired generation forever
        row[0], row[1] = domain, gen
    row[2] += sign * chips
    row[3] += sign * idle
    row[4] += sign * bad
    row[5] += sign            # resident node count
    if row[5] <= 0:
        agg.pop(sl, None)


def _slice_stats_from_cluster(nodes, pods) -> List[SliceStat]:
    """Same stats off raw store objects (vtpctl's path: works against
    a state file or a mirror, no scheduler required)."""
    from volcano_tpu_torch.api.resource import Resource
    from volcano_tpu_torch.api.types import TaskStatus, GPU_CLIQUE_LABEL
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    used: Dict[str, float] = {}
    occupied: Dict[str, int] = {}
    for pod in pods:
        if not pod.node_name:
            continue
        if pod.phase in (TaskStatus.BOUND, TaskStatus.RUNNING,
                         TaskStatus.RELEASING):
            used[pod.node_name] = used.get(pod.node_name, 0.0) + \
                float(pod.resource_requests().get(GPU) or 0)
            occupied[pod.node_name] = \
                occupied.get(pod.node_name, 0) + 1
    stats: Dict[str, SliceStat] = {}
    for node in nodes:
        sl = node.labels.get(GPU_CLIQUE_LABEL)
        if not sl:
            continue
        st = stats.get(sl)
        if st is None:
            st = stats[sl] = SliceStat(
                sl, node.labels.get(IB_FABRIC_LABEL, ""),
                generation_of(node.labels))
        chips = float(Resource.from_resource_list(
            node.allocatable).get(GPU))
        u = used.get(node.name, 0.0)
        st.chips += chips
        st.idle_chips += max(0.0, chips - u)
        if u > 0 or occupied.get(node.name) or node.unschedulable:
            st.whole_idle = False
    return list(stats.values())


def fragmentation(stats: List[SliceStat]) -> Dict[str, dict]:
    """Per-generation fragmentation of the idle pool.

    `largest_block_chips` is the biggest topology-placeable idle
    block: whole-idle NVLink domains are the placement unit (a
    multi-host NCCL gang cannot share a half-busy domain), and domains
    sharing an IB fabric compose into one multi-domain block.  The index is
    1 - largest_block / idle_chips: 0 when every idle chip is part of
    one placeable block, approaching 1 when idle chips are stranded
    inside busy slices or scattered across domains."""
    out: Dict[str, dict] = {}
    by_gen: Dict[str, List[SliceStat]] = {}
    for st in stats:
        by_gen.setdefault(st.generation, []).append(st)
    for gen, group in by_gen.items():
        idle = sum(s.idle_chips for s in group)
        block_by_domain: Dict[str, float] = {}
        for s in group:
            if s.whole_idle and s.chips > 0:
                block_by_domain[s.domain] = \
                    block_by_domain.get(s.domain, 0.0) + s.chips
        largest = max(block_by_domain.values(), default=0.0)
        out[gen] = {
            "idle_chips": round(idle, 1),
            "largest_block_chips": round(largest, 1),
            "index": round(1.0 - largest / idle, 4) if idle > 0
            else 0.0,
        }
    return out


# -- starvation --------------------------------------------------------

def _job_feasible(ssn, job, total_gpu: float) -> bool:
    """Could the cluster EVER serve this gang?  Pending demand within
    total capacity, and any published reasons are of the
    waiting-for-capacity kind (a gang pinned to a nonexistent node
    label is not starving, it is impossible)."""
    from volcano_tpu_torch.api.types import TaskStatus
    pending = [t for t in job.tasks_in_status(TaskStatus.PENDING)
               if not t.best_effort]
    if not pending:
        return False
    demand = sum(float(t.resreq.get(GPU)) for t in pending)
    if demand > total_gpu:
        return False
    doc = trace.pending_reasons().get(job.uid)
    if doc and doc.get("reasons"):
        return any(r in _FEASIBLE_REASONS for r in doc["reasons"])
    return True


def starvation_ages(ssn, now: Optional[float] = None
                    ) -> Dict[str, dict]:
    """queue -> {age_s, gangs, oldest} over feasible-but-pending
    gangs (phase stamps give the birth time; the flight recorder's
    reason aggregation names why each is still waiting)."""
    from volcano_tpu_torch.api.types import PodGroupPhase
    now = time.time() if now is None else now
    total_gpu = float(ssn.total_resource.get(GPU))
    out: Dict[str, dict] = {}
    for job in ssn.jobs.values():
        pg = job.podgroup
        if pg is None or pg.phase not in (PodGroupPhase.PENDING,
                                          PodGroupPhase.INQUEUE):
            continue
        if not _job_feasible(ssn, job, total_gpu):
            continue
        born = trace.phase_ts(pg.annotations, "created")
        if born is None:
            born = float(getattr(job, "creation_time", now) or now)
        age = max(0.0, now - born)
        cur = out.setdefault(job.queue, {"age_s": 0.0, "gangs": 0,
                                         "oldest": ""})
        cur["gangs"] += 1
        if age >= cur["age_s"]:
            cur["age_s"] = age
            cur["oldest"] = job.uid
    return out


# -- per-session export ------------------------------------------------

def observe_session(ssn, now: Optional[float] = None) -> dict:
    """Compute the cluster-level goodput/fragmentation/starvation
    gauges for one scheduling session and swap them into the metrics
    registry (one atomic family replace — a scrape sees either the
    previous session's export or this one's, never half).  Returns
    the computed document (the dumper embeds it)."""
    now = time.time() if now is None else now
    stats = _slice_stats_incremental(ssn)
    if stats is None:
        stats = _slice_stats_from_session(ssn)
    frag = fragmentation(stats)
    starve = starvation_ages(ssn, now)

    jobs_reporting = 0
    fleet_rate = 0.0
    alloc = prod = 0.0
    for job in ssn.jobs.values():
        pg = job.podgroup
        if pg is None:
            continue
        rate = ann_float(pg.annotations, PG_STEP_RATE_ANNOTATION)
        if rate <= 0 and PG_STEP_RATE_ANNOTATION not in pg.annotations:
            continue
        jobs_reporting += 1
        fleet_rate += rate
        alloc += ann_float(pg.annotations, PG_ALLOCATED_S_ANNOTATION)
        prod += ann_float(pg.annotations, PG_PRODUCTIVE_S_ANNOTATION)

    rows = [("goodput_jobs", {}, jobs_reporting),
            ("goodput_fleet_steps_per_second", {},
             round(fleet_rate, 3))]
    if alloc > 0:
        rows.append(("goodput_fraction", {},
                     round(min(1.0, prod / alloc), 4)))
    for gen, doc in frag.items():
        rows.append(("frag_index", {"generation": gen}, doc["index"]))
        rows.append(("frag_idle_chips", {"generation": gen},
                     doc["idle_chips"]))
        rows.append(("frag_largest_block_chips", {"generation": gen},
                     doc["largest_block_chips"]))
    for queue, doc in starve.items():
        rows.append(("starvation_age_seconds", {"queue": queue},
                     round(doc["age_s"], 3)))
        rows.append(("starvation_pending_gangs", {"queue": queue},
                     doc["gangs"]))
    metrics.swap_gauge_families(SESSION_GAUGE_FAMILIES, rows)
    return {"fragmentation": frag, "starvation": starve,
            "jobs_reporting": jobs_reporting,
            "fleet_steps_per_second": round(fleet_rate, 3),
            "goodput_fraction": (round(min(1.0, prod / alloc), 4)
                                 if alloc > 0 else None)}

"""Batched gang commit — allocate a whole gang as one statement drain.

The per-pod walk (allocate.py `_allocate_tasks`) pays, per task, one
`grouped_batch_node_order` dispatch, one `heap_best` scan over every
leaf group, one single-node `SpecCache.invalidate` re-predication and
one metrics/trace observation.  For a gang of identical controller-
stamped tasks all of that is recomputing the same answers 8192 times:
at 100k hosts the walk dominates the cycle (SCALE100K_r16.json,
allocate 6.4s of a 6.8s cycle).

This module drains the already-built SpecCache entry in ONE pass per
task spec:

  * group offsets are computed once per spec (identical tasks get
    identical `groupedBatchNodeOrder` verdicts);
  * all (score + offset) rows go into one global heap — picking a
    node is O(log n), not O(groups);
  * each popped node is filled to its capacity for the spec
    (`fit_count` over idle / future-idle) instead of being re-swept
    after every single placement.  Stacked placements beyond the
    first re-run the predicate chain once per extra pod so pod-count
    and port predicates keep their say;
  * per-task metrics/trace observations collapse into one
    `sched_gang_commit_seconds` observation per spec.

The drain is opt-in (`allocate.gangCommit: batch` under the action's
configurations) because its placement CONTRACT differs from the walk:
the walk re-scores a node after every placement, so a spread-style
scorer can alternate nodes mid-gang; the drain fills each node to
capacity in score order (the binpack/topology-compact behavior gang
workloads want).  Statement semantics are unchanged — everything still
rides `stmt.allocate`/`stmt.pipeline` and commits (or discards) with
the gang in `_finish`, and the commit still leaves the scheduler as
one idempotency-keyed `/bind_batch` per cycle (cache.flush_binds).
"""

from __future__ import annotations

import heapq
import logging
import time
from collections import deque
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api.fit_error import FitError, FitErrors
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.util import PriorityQueue

log = logging.getLogger(__name__)

_UNBOUNDED = 1 << 30


def enabled(ssn) -> bool:
    conf = ssn.conf.configurations.get("allocate", {})
    return str(conf.get("gangCommit", "walk")).lower() == "batch"


def fit_count(resreq, avail) -> int:
    """How many replicas of *resreq* fit into *avail* at once.  A
    request with no positive dimension fits without bound (the caller
    clamps to the number of waiting tasks)."""
    count = _UNBOUNDED
    for name, want in resreq.res.items():
        if want <= 0:
            continue
        have = avail.get(name)
        c = int(have / want + 1e-9)
        if c <= 0:
            return 0
        if c < count:
            count = c
    return count


def allocate_tasks_batched(ssn, queue, job, stmt, candidate_nodes,
                           record_errors: bool = True) -> Optional[int]:
    """Batched replacement for the per-pod walk.  Returns the placed
    count, or None when the batch contract cannot hold (ungrouped
    batch scorer / task-identity-dependent predicates) and the caller
    must fall back to the walk.  Non-cacheable tasks (bare pods,
    best-effort) are delegated back to the walk via task_filter."""
    from volcano_tpu_torch.actions.allocate import AllocateAction
    from volcano_tpu_torch.actions.sweep import SpecCache

    if ssn.task_dependent_predicates:
        return None
    cache = SpecCache(ssn, candidate_nodes, record_errors,
                      capacity_prefilter=True)
    if not cache.use_heap:
        return None

    # spec -> tasks.  Replicas of one spec are interchangeable under
    # the batch contract, so they keep creation (job.tasks insertion)
    # order instead of paying a comparator-heap pass over the whole
    # gang — at 8k tasks the task_order_fn dispatch per heap compare
    # was a measurable slice of the cycle.  SPECS still drain in task
    # order, decided by comparing one representative per spec.
    by_spec: Dict[str, List] = {}
    has_bare = False
    for task in job.tasks_in_status(TaskStatus.PENDING):
        if task.best_effort:
            continue
        if task.task_spec:
            by_spec.setdefault(task.task_spec, []).append(task)
        else:
            has_bare = True
    spec_order = list(by_spec)
    if len(spec_order) > 1:
        reps = PriorityQueue(ssn.task_order_fn,
                             (by_spec[s][0] for s in spec_order))
        spec_order = [t.task_spec for t in reps]

    placed = 0
    for spec in spec_order:
        tasks = by_spec[spec]
        more_specs = len(by_spec) > 1
        placed += _drain_spec(ssn, queue, job, stmt, cache, spec, tasks,
                              record_errors, more_specs)
    if has_bare:
        placed += AllocateAction._allocate_tasks(
            ssn, queue, job, stmt, candidate_nodes, record_errors,
            task_filter=lambda t: not t.task_spec)
    return placed


def _drain_spec(ssn, queue, job, stmt, cache, spec, tasks,
                record_errors: bool, more_specs: bool) -> int:
    t0 = time.perf_counter()
    proto = tasks[0]
    status = ssn.pre_predicate(proto)
    if status is not None:
        if record_errors:
            job.record_fit_error(proto, "",
                                 FitError(proto, None, statuses=[status]))
        return 0

    entry = cache.get(spec) or cache.build_entry(proto)
    group_scores = None
    if cache.has_grouped:
        # restrict scoring to the leaves this entry can actually rank
        # — a subtree shard's candidate set covers a fraction of the
        # fleet's leaves, and the binpack scorer walks domains per leaf
        group_scores = ssn.grouped_batch_node_order(
            proto, groups=set(entry["group"].values()))
    remaining = deque(tasks)
    placed = 0
    touched: List = []

    for cls, place in (("idle", stmt.allocate), ("future", stmt.pipeline)):
        if not remaining:
            break
        rows = _score_rows(entry, cls, group_scores)
        heapq.heapify(rows)
        while rows and remaining:
            _, name = heapq.heappop(rows)
            node = entry["fits"].get(name)
            if node is None:
                continue
            avail = node.idle if cls == "idle" else node.future_idle()
            cap = fit_count(proto.init_resreq, avail)
            stacked = 0
            while cap > 0 and remaining:
                task = remaining[0]
                if not ssn.allocatable(queue, task):
                    # same per-task skip as the walk: a later sibling
                    # may still clear the share once others commit
                    if record_errors:
                        errs = job.fit_errors.setdefault(task.uid,
                                                         FitErrors())
                        errs.set_error(
                            f"task would exceed queue {queue.name}'s "
                            f"deserved share")
                    remaining.popleft()
                    continue
                if stacked and ssn.predicate(proto, node) is not None:
                    # stacking re-check: resources allowed another
                    # replica but a count-style predicate (pod limit,
                    # host port) vetoed it
                    break
                remaining.popleft()
                place(task, node)
                placed += 1
                stacked += 1
                cap -= 1
            if stacked:
                touched.append(node)

    if remaining and record_errors:
        _record_leftovers(job, proto, remaining, entry, ssn)
    if more_specs:
        # other specs' cached entries must see these nodes' new state;
        # the drained spec's own entry is spent — drop it instead of
        # re-predicating every touched node against it
        cache.entries.pop(spec, None)
        for node in touched:
            cache.invalidate(node)
    metrics.observe("sched_gang_commit_seconds",
                    time.perf_counter() - t0)
    return placed


def _score_rows(entry, cls, group_scores) -> list:
    """(-(score+offset), name) rows for every node of *cls* — one
    global heap replaces the per-task per-group heap_best scan.  Tie
    order (same total) is smallest name first, exactly like
    heap_best."""
    meta = entry["meta"]
    groups = entry["group"]
    rows = []
    if group_scores:
        get_off = group_scores.get
        for name, (_gen, c, score) in meta.items():
            if c == cls:
                rows.append((-(score + get_off(groups.get(name), 0.0)),
                             name))
    else:
        for name, (_gen, c, score) in meta.items():
            if c == cls:
                rows.append((-score, name))
    return rows


def _record_leftovers(job, proto, remaining, entry, ssn) -> None:
    """Per-node Insufficient rows for tasks the drain could not seat:
    the swept-but-unseated nodes get the walk's fit_delta message, and
    the capacity-prefiltered (never-swept) nodes get the same from
    their live state — error fidelity is only paid on the failure
    path."""
    entries = []
    for node in entry["fits"].values():
        missing = node.future_idle().fit_delta(proto.resreq)
        dims = ", ".join(sorted(missing.res)) or "resources"
        entries.append((node.name, f"Insufficient {dims}"))
    by_name = ssn.nodes
    for name in entry["prefiltered"]:
        node = by_name.get(name)
        if node is None:
            continue
        missing = node.future_idle().fit_delta(proto.resreq)
        dims = ", ".join(sorted(missing.res)) or "resources"
        entries.append((name, f"Insufficient {dims}"))
    from volcano_tpu_torch.api.fit_error import unschedulable
    for task in remaining:
        for node_name, reason in entries:
            job.record_fit_error(task, node_name, FitError(
                proto, node_name, statuses=[unschedulable(reason)]))

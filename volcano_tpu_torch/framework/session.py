"""Session — one scheduling cycle's working state + extension points.

Reference parity: pkg/scheduler/framework/session.go:66-165 and
session_plugins.go (the ~40 extension-point registries with tiered
dispatch).  Dispatch semantics preserved:

- order fns: first tier/plugin giving a non-zero comparison wins.
- jobReady / allocatable / preemptive: AND across all enabled plugins.
- overused: OR.
- jobPipelined / jobStarving / jobEnqueueable: tiered PERMIT/REJECT/
  ABSTAIN voting (any reject in a tier => False; any permit => True and
  stop; all abstain => next tier).
- preemptable / reclaimable / unifiedEvictable: per-tier intersection of
  victim sets; a tier that voted with an empty intersection rejects.
"""

from __future__ import annotations

import time
import uuid
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Set

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.fit_error import StatusCode
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.conf import SchedulerConf, Tier

# vote values for tiered voting points
PERMIT = 1
ABSTAIN = 0
REJECT = -1


class EventHandler:
    """Allocate/deallocate bookkeeping hooks (drf, proportion, ...)."""

    __slots__ = ("allocate_fn", "deallocate_fn")

    def __init__(self, allocate_fn=None, deallocate_fn=None):
        self.allocate_fn = allocate_fn
        self.deallocate_fn = deallocate_fn


class Event:
    __slots__ = ("task",)

    def __init__(self, task: TaskInfo):
        self.task = task


class Session:
    def __init__(self, cache, snapshot, conf: SchedulerConf):
        self.uid = uuid.uuid4().hex[:12]
        self.cache = cache
        self.conf = conf
        self.tiers: List[Tier] = conf.tiers

        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        self.hypernodes = snapshot.hypernodes
        self.priority_classes = snapshot.priority_classes
        self.total_resource = snapshot.total_resource()
        # learned per-(job, generation) throughput vectors
        # (volcano_tpu_torch/goodput.py ThroughputBook; None in harnesses
        # that build bare snapshots) — read-only for plugins/actions
        self.goodput = getattr(snapshot, "goodput", None)

        self.plugins: Dict[str, object] = {}

        # extension-point registries: point -> plugin name -> fn
        self._fns: Dict[str, Dict[str, Callable]] = defaultdict(dict)
        self._enabled_cache: Dict[str, list] = {}
        self._raw_cache: Dict[str, list] = {}
        self.event_handlers: List[EventHandler] = []
        # Plugins whose predicate verdicts depend on TASK IDENTITY or
        # cross-node external state (not just task spec + node state)
        # must add their name here: it disables allocate's per-spec
        # predicate/score cache so every task gets a fresh sweep.
        self.task_dependent_predicates: Set[str] = set()

        # PodGroup phases dirtied this session, flushed by job_updater.
        self.dirty_jobs: Set[str] = set()

        # Objects MUTATED by this session's scheduling attempts (the 5
        # state primitives below record here).  The cache consumes
        # these at close: a touched node/job must be rebuilt from
        # cluster truth next cycle, committed or discarded — the
        # incremental snapshot's correctness hinge.
        self.touched_nodes: Set[str] = set()
        self.touched_jobs: Set[str] = set()

        # snapshot generation this session was opened over — the
        # staleness token of the process-mirror protocol: every sweep
        # row a pool worker returns is stamped with the generation it
        # was computed against (actions/procpool.py)
        self.snapshot_gen = getattr(snapshot, "gen", 0)
        # within-cycle mutation journal: the 5 state primitives append
        # one compact op each, and the process pool ships the unsent
        # suffix to its mirror workers before every fan-out — workers
        # replay the ops through their OWN session's primitives, so a
        # mid-cycle sweep sees the same in-session view the owner
        # does.  Always recorded (a tuple append per placement is
        # noise next to the placement itself).
        self.mirror_log: List[tuple] = []
        self.mirror_shipped = 0

        # gangpreempt nominations made this session (job uid -> subjob
        # name -> hypernode), consumed by allocate next cycle.
        self.nominations: Dict[str, Dict[str, str]] = {}

        self._recover_allocated_hypernodes()

    # -- setup ---------------------------------------------------------

    def _recover_allocated_hypernodes(self):
        """Crash recovery: rebuild each subjob's AllocatedHyperNode from
        the nodes its running tasks already sit on (session.go:361-444)."""
        if not self.hypernodes:
            return
        for job in self.jobs.values():
            for sub in job.sub_jobs.values():
                if sub.allocated_hypernode:
                    continue
                placed = {t.node_name for t in sub.tasks.values()
                          if t.node_name and t.occupies_resources()}
                if not placed:
                    continue
                covering = self.hypernodes.hypernodes_covering(placed)
                if covering:
                    sub.allocated_hypernode = covering[0]

    # -- registration (called by plugins in on_session_open) -----------

    def add_fn(self, point: str, plugin: str, fn: Callable):
        self._fns[point][plugin] = fn
        self._enabled_cache.pop(point, None)
        self._raw_cache.pop(point, None)

    def add_event_handler(self, handler: EventHandler):
        self.event_handlers.append(handler)

    # sugar mirroring the reference's AddXxxFn methods
    def add_job_order_fn(self, p, fn):        self.add_fn("jobOrder", p, fn)
    def add_queue_order_fn(self, p, fn):      self.add_fn("queueOrder", p, fn)
    def add_victim_queue_order_fn(self, p, fn): self.add_fn("victimQueueOrder", p, fn)
    def add_task_order_fn(self, p, fn):       self.add_fn("taskOrder", p, fn)
    def add_sub_job_order_fn(self, p, fn):    self.add_fn("subJobOrder", p, fn)
    def add_job_ready_fn(self, p, fn):        self.add_fn("jobReady", p, fn)
    def add_sub_job_ready_fn(self, p, fn):    self.add_fn("subJobReady", p, fn)
    def add_job_pipelined_fn(self, p, fn):    self.add_fn("jobPipelined", p, fn)
    def add_sub_job_pipelined_fn(self, p, fn): self.add_fn("subJobPipelined", p, fn)
    def add_job_valid_fn(self, p, fn):        self.add_fn("jobValid", p, fn)
    def add_job_enqueueable_fn(self, p, fn):  self.add_fn("jobEnqueueable", p, fn)
    def add_job_enqueued_fn(self, p, fn):     self.add_fn("jobEnqueued", p, fn)
    def add_job_starving_fn(self, p, fn):     self.add_fn("jobStarving", p, fn)
    def add_pre_predicate_fn(self, p, fn):    self.add_fn("prePredicate", p, fn)
    def add_predicate_fn(self, p, fn):        self.add_fn("predicate", p, fn)
    def add_predicate_prepare_fn(self, p, fn):
        """Optional batched twin of a predicate fn (the k8s PreFilter
        idiom): ``fn(task)`` returns a per-node callable EXACTLY
        equivalent to ``predicate(task, node)`` with every task-side
        constant hoisted out of the per-node loop.  The batch sweep
        (actions/sweep.py) uses the prepared form when the same
        plugin registered both; the tiered serial dispatch never
        calls it, so plugins without one lose nothing."""
        self.add_fn("predicatePrepare", p, fn)
    def add_node_order_fn(self, p, fn):       self.add_fn("nodeOrder", p, fn)
    def add_node_order_prepare_fn(self, p, fn):
        """Optional batched twin of a nodeOrder fn (PreScore): same
        contract as add_predicate_prepare_fn, returning a per-node
        scorer."""
        self.add_fn("nodeOrderPrepare", p, fn)
    def add_batch_node_order_fn(self, p, fn): self.add_fn("batchNodeOrder", p, fn)
    def add_grouped_batch_node_order_fn(self, p, fn):
        """Optional leaf-grouped twin of a BatchNodeOrder fn:
        fn(task, groups=None) returns {group: score} per node-group
        (session.node_group), letting allocate keep its heap fast path
        when every batch scorer provides this form.  A non-None
        `groups` is a set of group keys the caller will rank — the fn
        may skip scoring work for groups outside it (it is a
        restriction hint, never an obligation to cover every key).

        CONTRACT: fn must return a FRESH dict per call, never a
        memoized or otherwise shared mapping.  Callers treat the
        mapping as their own (grouped_batch_node_order hands it out,
        allocate's heap_best reads it across placements); a plugin
        that caches its score dict would be aliased to every caller.
        The single-plugin fast path defensively copies, but the copy
        is shallow — shared VALUES are still the plugin's problem."""
        self.add_fn("groupedBatchNodeOrder", p, fn)
    def add_hyper_node_order_fn(self, p, fn): self.add_fn("hyperNodeOrder", p, fn)
    def add_allocatable_fn(self, p, fn):      self.add_fn("allocatable", p, fn)
    def add_overused_fn(self, p, fn):         self.add_fn("overused", p, fn)
    def add_preemptive_fn(self, p, fn):       self.add_fn("preemptive", p, fn)
    def add_preemptable_fn(self, p, fn):      self.add_fn("preemptable", p, fn)
    def add_reclaimable_fn(self, p, fn):      self.add_fn("reclaimable", p, fn)
    def add_unified_evictable_fn(self, p, fn): self.add_fn("unifiedEvictable", p, fn)
    def add_victim_tasks_fn(self, p, fn):     self.add_fn("victimTasks", p, fn)

    # -- tier-walking dispatch helpers ---------------------------------

    @staticmethod
    def _timed(point: str, plugin: str, fn: Callable) -> Callable:
        """Wrap one registered callback so its runtime accumulates
        under the innermost open trace span as ONE aggregate per
        (plugin, point) — never a span per call (the dispatcher runs
        hundreds of thousands of times per cycle; trace.py keeps the
        per-call cost to two perf_counter reads + a dict update, and
        a no-op attr check when no session span is open)."""
        perf = time.perf_counter
        add = trace.add_plugin_time

        def timed(*args):
            t0 = perf()
            try:
                return fn(*args)
            finally:
                add(point, plugin, perf() - t0)
        return timed

    def _enabled_fns(self, point: str):
        """(plugin_option, fn) tiers honoring order + enable flags.

        Registrations only happen during plugin OnSessionOpen, so the
        resolved tier walk is memoized per point (the dispatcher runs
        hundreds of thousands of times per cycle).  The memoized fns
        are trace-timed wrappers (see _timed)."""
        cached = self._enabled_cache.get(point)
        if cached is not None:
            return cached
        fns = self._fns.get(point)
        result = []
        if fns:
            for tier in self.tiers:
                tier_fns = []
                for opt in tier.plugins:
                    fn = fns.get(opt.name)
                    if fn is not None and opt.is_enabled(point):
                        tier_fns.append(
                            (opt, self._timed(point, opt.name, fn)))
                if tier_fns:
                    result.append(tier_fns)
        # vtplint: disable=shared-cache-unkeyed (idempotent dispatch memo resolved on the session owner thread before any fan-out — SpecCache pre-resolves via resolved_fns; a racing GIL-atomic store publishes an equal table)
        self._enabled_cache[point] = result
        return result

    def _compare(self, point: str, a, b) -> int:
        for tier_fns in self._enabled_fns(point):
            for _, fn in tier_fns:
                r = fn(a, b)
                if r != 0:
                    return r
        return 0

    def _vote(self, point: str, *args, default: bool = True) -> bool:
        """PERMIT/REJECT/ABSTAIN tiered voting."""
        voted = False
        for tier_fns in self._enabled_fns(point):
            has_permit = False
            for _, fn in tier_fns:
                v = fn(*args)
                if v == REJECT or v is False:
                    return False
                if v == PERMIT or v is True:
                    has_permit = True
                voted = True
            if has_permit:
                return True
        return default if not voted else True

    def _all(self, point: str, *args, default: bool = True) -> bool:
        any_fn = False
        for tier_fns in self._enabled_fns(point):
            for _, fn in tier_fns:
                any_fn = True
                if not fn(*args):
                    return False
        return True if any_fn else default

    def _any(self, point: str, *args, default: bool = False) -> bool:
        any_fn = False
        for tier_fns in self._enabled_fns(point):
            for _, fn in tier_fns:
                any_fn = True
                if fn(*args):
                    return True
        return False if any_fn else default

    def _victim_intersection(self, point: str, ctx, candidates:
                             List[TaskInfo]) -> List[TaskInfo]:
        """Per-tier victim-set intersection (Preemptable/Reclaimable
        semantics: every voting plugin must agree a victim is evictable)."""
        victims = None
        for tier_fns in self._enabled_fns(point):
            tier_victims: Optional[Set[str]] = None
            for _, fn in tier_fns:
                res = fn(ctx, candidates)
                if res is None:
                    continue
                uids = {t.uid for t in res}
                tier_victims = uids if tier_victims is None \
                    else tier_victims & uids
            if tier_victims is None:
                continue
            victims = tier_victims if victims is None else victims & tier_victims
            if not victims:
                return []
        if victims is None:
            return []
        return [t for t in candidates if t.uid in victims]

    # -- public dispatchers (mirror session_plugins.go) ----------------

    def job_order_fn(self, a: JobInfo, b: JobInfo) -> bool:
        r = self._compare("jobOrder", a, b)
        if r != 0:
            return r < 0
        if a.creation_time != b.creation_time:
            return a.creation_time < b.creation_time
        return a.uid < b.uid

    def queue_order_fn(self, a: QueueInfo, b: QueueInfo) -> bool:
        r = self._compare("queueOrder", a, b)
        if r != 0:
            return r < 0
        return a.queue.creation_time < b.queue.creation_time

    def victim_queue_order_fn(self, a: QueueInfo, b: QueueInfo) -> bool:
        r = self._compare("victimQueueOrder", a, b)
        if r != 0:
            return r < 0
        return not self.queue_order_fn(a, b)

    def task_order_fn(self, a: TaskInfo, b: TaskInfo) -> bool:
        r = self._compare("taskOrder", a, b)
        if r != 0:
            return r < 0
        return a.uid < b.uid

    def sub_job_order_fn(self, a, b) -> bool:
        r = self._compare("subJobOrder", a, b)
        if r != 0:
            return r < 0
        return a.name < b.name

    def job_ready(self, job: JobInfo) -> bool:
        return self._all("jobReady", job, default=True)

    def job_pipelined(self, job: JobInfo) -> bool:
        return self._vote("jobPipelined", job, default=True)

    def job_starving(self, job: JobInfo) -> bool:
        return self._vote("jobStarving", job, default=False)

    def job_valid(self, job: JobInfo):
        """Returns None if valid, else (reason, message)."""
        for tier_fns in self._enabled_fns("jobValid"):
            for _, fn in tier_fns:
                result = fn(job)
                if result is not None:
                    return result
        return None

    def job_enqueueable(self, job: JobInfo) -> bool:
        return self._vote("jobEnqueueable", job, default=True)

    def job_enqueued(self, job: JobInfo):
        for tier_fns in self._enabled_fns("jobEnqueued"):
            for _, fn in tier_fns:
                fn(job)

    def pre_predicate(self, task: TaskInfo):
        """Raise FitError-carrying exception or return list of Status."""
        for tier_fns in self._enabled_fns("prePredicate"):
            for _, fn in tier_fns:
                st = fn(task)
                if st is not None and not st.ok:
                    return st
        return None

    def _run_predicates(self, task: TaskInfo, node: NodeInfo,
                        allow_resolvable: bool):
        """Returns (status, waved): status is the first fatal non-ok
        verdict (or None), waved is True when an evict-curable failure
        was skipped under allow_resolvable."""
        waved = False
        for tier_fns in self._enabled_fns("predicate"):
            for _, fn in tier_fns:
                st = fn(task, node)
                if st is None or st.ok:
                    continue
                if allow_resolvable and \
                        st.code is StatusCode.UNSCHEDULABLE and \
                        getattr(st, "evict_curable", False):
                    waved = True
                    continue
                return st, waved
        return None, waved

    def predicate(self, task: TaskInfo, node: NodeInfo):
        """Returns None if task fits node, else a non-ok Status."""
        return self._run_predicates(task, node, allow_resolvable=False)[0]

    def predicate_for_preempt(self, task: TaskInfo, node: NodeInfo):
        """Predicate for eviction-flavored actions (reference
        PredicateForPreemptAction): an UNSCHEDULABLE verdict the
        issuing plugin marked evict_curable passes — evicting victims
        this session can flip it — while everything else (including
        resolvable failures eviction can't observe curing, like usage
        thresholds) rejects the node as in the normal path.

        Returns (status, waved).  When waved is True a curable failure
        was skipped, and the caller MUST re-run the full predicate()
        against post-eviction state before committing a placement;
        when False the verdict already equals the full predicate's, so
        no re-check is needed."""
        return self._run_predicates(task, node, allow_resolvable=True)

    def node_order(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for tier_fns in self._enabled_fns("nodeOrder"):
            for _, fn in tier_fns:
                score += fn(task, node)
        return score

    def fn_plugin_names(self, point: str) -> set:
        """Names of plugins with enabled registrations at *point*."""
        return {opt.name for tier in self._enabled_fns(point)
                for opt, _ in tier}

    def resolved_fns(self, point: str) -> list:
        """The RAW enabled callbacks at *point*, flattened in tier
        order — the batch-sweep fast path (actions/sweep.py) calls
        these directly so the per-node cost is the plugin body alone,
        not the tier walk + trace-timing wrapper per call; the sweep
        attributes its aggregate time as one lane instead.  Resolved
        on the calling thread and memoized, so a parallel sweep's
        workers never write the dispatch caches mid-flight."""
        return [fn for _, fn in self.resolved_named_fns(point)]

    def resolved_named_fns(self, point: str) -> list:
        """(plugin name, raw fn) pairs at *point* in tier order (see
        resolved_fns); the names let the sweep pair prepare fns with
        the callbacks they accelerate."""
        cached = self._raw_cache.get(point)
        if cached is not None:
            return cached
        fns = self._fns.get(point)
        result = []
        if fns:
            for tier in self.tiers:
                for opt in tier.plugins:
                    fn = fns.get(opt.name)
                    if fn is not None and opt.is_enabled(point):
                        result.append((opt.name, fn))
        # vtplint: disable=shared-cache-unkeyed (idempotent dispatch memo resolved on the session owner thread before any fan-out; a racing GIL-atomic store publishes an equal table)
        self._raw_cache[point] = result
        return result

    def node_group(self, node_name: str):
        """Grouping key for grouped batch scoring: the node's leaf
        hypernode (None outside any hypernode / no topology)."""
        if self.hypernodes is None:
            return None
        return self.hypernodes.leaf_of_node(node_name)

    def grouped_batch_node_order(self, task: TaskInfo, groups=None):
        """Accumulated per-group batch scores ({group: score}).

        groups (optional set of group keys) restricts scoring to the
        groups the caller will actually rank — the batched gang drain
        knows its entry's leaf set, and under a subtree-partitioned
        scheduler that is a fraction of the fleet's leaves, so the
        binpack scorer need not walk every domain."""
        fns = [fn for tier_fns in
               self._enabled_fns("groupedBatchNodeOrder")
               for _, fn in tier_fns]
        if len(fns) == 1:
            # the common case (one topology plugin): skip the merge —
            # at 20k hosts the per-task dict merge over ~300 leaves
            # was a measurable slice of the gang cycle.  dict() still
            # copies: the fresh-dict contract lives in the plugin
            # (see add_grouped_batch_node_order_fn), but a future
            # memoizing scorer must degrade to a cheap shallow copy
            # here, not to silent aliasing of its cache to callers.
            return dict(fns[0](task, groups))
        totals: Dict[object, float] = defaultdict(float)
        for fn in fns:
            for group, s in fn(task, groups).items():
                totals[group] += s
        return totals

    def batch_node_order(self, task: TaskInfo,
                         nodes: List[NodeInfo]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for tier_fns in self._enabled_fns("batchNodeOrder"):
            for _, fn in tier_fns:
                for name, s in fn(task, nodes).items():
                    scores[name] += s
        return scores

    def hyper_node_order(self, job: JobInfo,
                         candidates: List[str]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for tier_fns in self._enabled_fns("hyperNodeOrder"):
            for _, fn in tier_fns:
                for name, s in fn(job, candidates).items():
                    scores[name] += s
        return scores

    def allocatable(self, queue: QueueInfo, task: TaskInfo) -> bool:
        return self._all("allocatable", queue, task, default=True)

    def overused(self, queue: QueueInfo) -> bool:
        return self._any("overused", queue, default=False)

    def preemptive(self, queue: QueueInfo, task: TaskInfo) -> bool:
        return self._all("preemptive", queue, task, default=True)

    def preemptable(self, preemptor: TaskInfo,
                    candidates: List[TaskInfo]) -> List[TaskInfo]:
        return self._victim_intersection("preemptable", preemptor, candidates)

    def reclaimable(self, reclaimer: TaskInfo,
                    candidates: List[TaskInfo]) -> List[TaskInfo]:
        return self._victim_intersection("reclaimable", reclaimer, candidates)

    def unified_evictable(self, ctx,
                          candidates: List[TaskInfo]) -> List[TaskInfo]:
        return self._victim_intersection("unifiedEvictable", ctx, candidates)

    def victim_tasks(self) -> List[TaskInfo]:
        victims: Dict[str, TaskInfo] = {}
        for tier_fns in self._enabled_fns("victimTasks"):
            for _, fn in tier_fns:
                for t in fn():
                    victims[t.uid] = t
        return list(victims.values())

    # -- state mutation primitives (Session.Allocate/Pipeline/Evict) ---

    def allocate(self, task: TaskInfo, node: NodeInfo):
        """Assign task to node with resources consumed now."""
        job = self.jobs[task.job]
        self.mirror_log.append(("alloc", job.uid, task.uid, node.name))
        task.node_name = node.name
        if task.uid in node.tasks:
            node.update_task_status(task, TaskStatus.ALLOCATED)
            job.update_task_status(task, TaskStatus.ALLOCATED)
        else:
            job.update_task_status(task, TaskStatus.ALLOCATED)
            node.add_task(task)
        self.dirty_jobs.add(job.uid)
        self.touched_jobs.add(job.uid)
        self.touched_nodes.add(node.name)
        for h in self.event_handlers:
            if h.allocate_fn:
                h.allocate_fn(Event(task))

    def pipeline(self, task: TaskInfo, node: NodeInfo):
        """Assign task onto resources that are still being released."""
        job = self.jobs[task.job]
        self.mirror_log.append(("pipe", job.uid, task.uid, node.name))
        task.node_name = node.name
        job.update_task_status(task, TaskStatus.PIPELINED)
        node.add_task(task)
        self.dirty_jobs.add(job.uid)
        self.touched_jobs.add(job.uid)
        self.touched_nodes.add(node.name)
        for h in self.event_handlers:
            if h.allocate_fn:
                h.allocate_fn(Event(task))

    def evict(self, task: TaskInfo, reason: str = ""):
        """Mark a running task as releasing (in-session view)."""
        job = self.jobs[task.job]
        self.mirror_log.append(("evict", job.uid, task.uid))
        job.update_task_status(task, TaskStatus.RELEASING)
        node = self.nodes.get(task.node_name)
        if node is not None:
            node.update_task_status(task, TaskStatus.RELEASING)
            self.touched_nodes.add(node.name)
        self.dirty_jobs.add(job.uid)
        self.touched_jobs.add(job.uid)
        for h in self.event_handlers:
            if h.deallocate_fn:
                h.deallocate_fn(Event(task))

    def deallocate(self, task: TaskInfo):
        """Undo an in-session allocate/pipeline (statement discard)."""
        job = self.jobs[task.job]
        self.mirror_log.append(("dealloc", job.uid, task.uid))
        node = self.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
            self.touched_nodes.add(node.name)
        job.update_task_status(task, TaskStatus.PENDING)
        self.touched_jobs.add(job.uid)
        task.node_name = ""
        for h in self.event_handlers:
            if h.deallocate_fn:
                h.deallocate_fn(Event(task))

    def unevict(self, task: TaskInfo,
                prev_status: Optional[TaskStatus] = None):
        """Undo an in-session evict: restore the pre-evict status."""
        restore = prev_status or TaskStatus.RUNNING
        job = self.jobs[task.job]
        self.mirror_log.append(
            ("unevict", job.uid, task.uid, restore))
        job.update_task_status(task, restore)
        node = self.nodes.get(task.node_name)
        if node is not None:
            node.update_task_status(task, restore)
            self.touched_nodes.add(node.name)
        self.touched_jobs.add(job.uid)
        for h in self.event_handlers:
            if h.allocate_fn:
                h.allocate_fn(Event(task))

    # -- misc ----------------------------------------------------------

    def statement(self):
        from volcano_tpu_torch.framework.statement import Statement
        return Statement(self)

    def pending_jobs(self) -> List[JobInfo]:
        return [j for j in self.jobs.values()
                if j.podgroup is None
                or j.podgroup.phase in (PodGroupPhase.PENDING,)]

    def set_job_pending_reason(self, job: JobInfo, reason: str, message: str):
        if job.podgroup is None:
            return
        from volcano_tpu_torch.api.podgroup import PodGroupCondition
        job.podgroup.conditions = [
            c for c in job.podgroup.conditions if c.type != "Unschedulable"]
        job.podgroup.conditions.append(PodGroupCondition(
            type="Unschedulable", status="True", reason=reason,
            message=message, transition_id=self.uid))
        self.dirty_jobs.add(job.uid)

"""Capacity plugin — spec-driven queue capacity with hierarchy.

Reference parity: plugins/capacity/capacity.go:49,450-1400 (deserved /
guarantee / capability per queue, hierarchical queue tree rooted at
"root", ancestor-aware allocatable/enqueue gates, ancestor reclaim).
Unlike proportion (weights -> water-fill), capacity takes each queue's
`deserved` straight from spec; hierarchy means every check walks the
ancestor chain so a child can never push its subtree past a parent's
deserved/capability.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import PERMIT, REJECT, EventHandler

ROOT_QUEUE = "root"


class _QueueAttr:
    __slots__ = ("queue", "deserved", "allocated", "inqueue",
                 "guarantee", "capability", "real_capability", "parent",
                 "elastic")

    def __init__(self, queue: Optional[QueueInfo]):
        self.queue = queue
        self.deserved = Resource()
        self.allocated = Resource()
        self.inqueue = Resource()
        self.elastic = Resource()
        self.guarantee = queue.guarantee if queue else Resource()
        self.capability = queue.capability if queue else None
        self.real_capability = Resource()
        self.parent: str = ""

    def share(self) -> float:
        s = 0.0
        for dim, alloc in self.allocated.res.items():
            d = self.deserved.get(dim)
            if d > 0.1:
                s = max(s, alloc / d)
            elif alloc > 0.1:
                s = max(s, float("inf"))
        return s


@register_plugin("capacity")
class CapacityPlugin(Plugin):
    name = "capacity"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.attrs: Dict[str, _QueueAttr] = {}

    # -- session wiring -------------------------------------------------

    def on_session_open(self, ssn):
        total = ssn.total_resource
        self._build_attrs(ssn, total)
        self._export_queue_metrics()

        ssn.add_queue_order_fn(self.name, self._queue_order)
        ssn.add_victim_queue_order_fn(self.name, self._victim_queue_order)
        ssn.add_allocatable_fn(self.name, self._allocatable)
        ssn.add_overused_fn(self.name, self._overused)
        ssn.add_preemptive_fn(self.name, self._preemptive)
        ssn.add_reclaimable_fn(self.name, self._reclaimable(ssn))
        ssn.add_unified_evictable_fn(self.name, self._unified_evictable(ssn))
        ssn.add_job_enqueueable_fn(self.name, self._job_enqueueable)
        ssn.add_job_enqueued_fn(self.name, self._job_enqueued)
        ssn.add_event_handler(EventHandler(
            allocate_fn=lambda e: self._on_event(ssn, e, +1),
            deallocate_fn=lambda e: self._on_event(ssn, e, -1)))

    def _build_attrs(self, ssn, total: Resource):
        # attrs for every queue + synthetic root
        root = _QueueAttr(None)
        root.deserved = total.clone()
        root.real_capability = total.clone()
        self.attrs[ROOT_QUEUE] = root
        for q in ssn.queues.values():
            if q.name == ROOT_QUEUE:
                root.queue = q
                continue
            attr = _QueueAttr(q)
            attr.parent = q.parent or ROOT_QUEUE
            self.attrs[q.name] = attr
        # guarantees reserve capacity from siblings
        total_guarantee = Resource()
        for name, attr in self.attrs.items():
            if name != ROOT_QUEUE:
                total_guarantee.add(attr.guarantee)
        for name, attr in self.attrs.items():
            if name == ROOT_QUEUE:
                continue
            rc = total.clone().sub_unchecked(total_guarantee) \
                .add(attr.guarantee)
            if attr.capability is not None:
                for dim, val in attr.capability.res.items():
                    rc.res[dim] = min(rc.res.get(dim, val), val)
            attr.real_capability = rc
            # deserved: spec value, else realCapability (no fairness cap)
            spec = attr.queue.deserved_spec if attr.queue else None
            attr.deserved = spec.clone() if spec is not None else rc.clone()
            attr.deserved.set_max(attr.guarantee)

        # usage accounting (jobs contribute to their queue + ancestors)
        for job in ssn.jobs.values():
            alloc = job.allocated()
            elastic = job.elastic_resources(alloc)
            inq = (job.min_request()
                   if job.podgroup
                   and job.podgroup.phase is PodGroupPhase.INQUEUE
                   and not job.is_ready()
                   and job.has_min_resources else None)
            for qname in self._chain(job.queue):
                attr = self.attrs[qname]
                attr.allocated.add(alloc)
                attr.elastic.add(elastic)
                if inq is not None:
                    attr.inqueue.add(inq)

    def _chain(self, queue_name: str) -> List[str]:
        """queue + ancestors up to and including root (cycle-safe)."""
        chain, seen = [], set()
        cur = queue_name
        while cur and cur not in seen and cur in self.attrs:
            chain.append(cur)
            seen.add(cur)
            cur = self.attrs[cur].parent
        if ROOT_QUEUE not in seen and ROOT_QUEUE in self.attrs:
            chain.append(ROOT_QUEUE)
        return chain

    # -- callbacks -------------------------------------------------------

    def _queue_order(self, a: QueueInfo, b: QueueInfo) -> int:
        pa = getattr(a, "priority", 0)
        pb = getattr(b, "priority", 0)
        if pa != pb:
            return -1 if pa > pb else 1
        sa = self.attrs[a.name].share() if a.name in self.attrs else 0
        sb = self.attrs[b.name].share() if b.name in self.attrs else 0
        return -1 if sa < sb else (1 if sb < sa else 0)

    def _victim_queue_order(self, a: QueueInfo, b: QueueInfo) -> int:
        """Most-over-deserved queues give back first."""
        sa = self.attrs[a.name].share() if a.name in self.attrs else 0
        sb = self.attrs[b.name].share() if b.name in self.attrs else 0
        return -1 if sa > sb else (1 if sb > sa else 0)

    def _allocatable(self, queue: QueueInfo, task: TaskInfo) -> bool:
        req = task.resreq
        for qname in self._chain(queue.name):
            attr = self.attrs[qname]
            future = attr.allocated.clone().add(req)
            if not future.less_equal_with_dimensions(attr.deserved,
                                                     req.res.keys()):
                return False
        return True

    def _export_queue_metrics(self):
        """Per-queue capacity/real-capacity/inqueue/overused gauges
        (reference metrics/queue.go, updated by the capacity plugin).
        Whole families are swapped atomically — see proportion's
        exporter for the rationale."""
        from volcano_tpu_torch import metrics
        families = {"queue_overused"}
        for metric in ("real_capacity", "inqueue", "capacity"):
            for suffix in ("_milli_cpu", "_memory_bytes",
                           "_scalar_resources"):
                families.add(f"queue_{metric}{suffix}")
        rows = []
        for name, a in self.attrs.items():
            rows.append(("queue_overused", {"queue": name},
                         1.0 if self._share_overused(a) else 0.0))
            pairs = [("real_capacity", a.real_capability),
                     ("inqueue", a.inqueue)]
            if a.capability is not None:
                pairs.append(("capacity", a.capability))
            for metric, res in pairs:
                rows.extend(metrics.resource_gauge_rows(
                    f"queue_{metric}", res, queue=name))
        metrics.swap_gauge_families(families, rows)

    @staticmethod
    def _share_overused(attr) -> bool:
        return attr.share() >= 1.0 - 1e-9

    def _overused(self, queue: QueueInfo) -> bool:
        attr = self.attrs.get(queue.name)
        return attr is not None and self._share_overused(attr)

    def _preemptive(self, queue: QueueInfo, task: TaskInfo) -> bool:
        """May this queue absorb *task* via reclaim?  Checks the
        queue's OWN capacity, and deserved on ANY requested dimension
        (capacity.go:648-683 LessEqualPartly semantics: a queue owed
        chips may reclaim them even while over on cpu)."""
        attr = self.attrs.get(queue.name)
        if attr is None:
            return True
        future = attr.allocated.clone().add(task.resreq)
        dims = list(task.resreq.res.keys())
        if not future.less_equal_with_dimensions(attr.real_capability,
                                                 dims):
            return False
        from volcano_tpu_torch.api.resource import MIN_RESOURCE
        return any(future.get(d) <= attr.deserved.get(d) + MIN_RESOURCE
                   for d in dims)

    def _reclaimable(self, ssn):
        """Hierarchical reclaim (capacity.go:500-600): a victim is
        eligible only when (a) evicting it keeps its queue at/above its
        GUARANTEE, (b) its own queue currently exceeds deserved on some
        contended dimension (childEligible), and (c) every non-root
        ancestor also exceeds deserved — the ancestor check is an
        ADDITIONAL veto against reclaiming where there is no real
        contention, never a substitute for leaf exceedance.  Running
        eviction totals update the view victim by victim."""
        from volcano_tpu_torch.api.resource import MIN_RESOURCE

        def fn(ctx, candidates: List[TaskInfo]):
            victims = []
            evicted: Dict[str, Resource] = defaultdict(Resource)

            def exceeds_on_relevant(attr, evicted_res, req) -> bool:
                """Over deserved on a dimension the VICTIM actually
                frees (reference GreaterPartlyWithRelevantDimensions) —
                surplus memory never justifies evicting a cpu-only pod."""
                current = attr.allocated.clone().sub_unchecked(evicted_res)
                return any(
                    current.get(d) > attr.deserved.get(d) + MIN_RESOURCE
                    for d in req.res)

            def guarantee_ok(attr, evicted_res, req) -> bool:
                would_be = attr.allocated.clone() \
                    .sub_unchecked(evicted_res).sub_unchecked(req)
                return attr.guarantee.less_equal(would_be,
                                                 zero="defaultZero") or \
                    attr.guarantee.is_empty()

            for t in candidates:
                job = ssn.jobs.get(t.job)
                if job is None:
                    continue
                attr = self.attrs.get(job.queue)
                if attr is None or attr.queue is None or \
                        not attr.queue.reclaimable:
                    continue
                if not guarantee_ok(attr, evicted[job.queue], t.resreq):
                    continue
                if not exceeds_on_relevant(attr, evicted[job.queue],
                                           t.resreq):
                    continue  # the leaf itself must hold surplus
                # ancestors veto only when they carry EXPLICIT deserved
                # policy; an unconfigured parent (deserved defaulted to
                # realCapability) never blocks reclaim within it
                chain = [q for q in self._chain(job.queue)
                         if q != ROOT_QUEUE and q != job.queue]
                policy_ancestors = [
                    q for q in chain
                    if self.attrs[q].queue is not None
                    and self.attrs[q].queue.deserved_spec is not None]
                if not all(exceeds_on_relevant(self.attrs[q], evicted[q],
                                               t.resreq)
                           for q in policy_ancestors):
                    continue  # an explicitly-capped ancestor lacks surplus
                victims.append(t)
                for q in self._chain(job.queue):
                    if q != ROOT_QUEUE:
                        evicted[q].add(t.resreq)
            return victims
        return fn

    def _unified_evictable(self, ssn):
        """In-queue gangpreempt is share-neutral: permit all candidates;
        only cross-queue gangreclaim filters by deserved share
        (capacity.go:607-612 keys on the EvictionContext kind)."""
        reclaim_fn = self._reclaimable(ssn)

        def fn(ctx, candidates: List[TaskInfo]):
            if not getattr(ctx, "cross_queue", True):
                return list(candidates)
            return reclaim_fn(ctx, candidates)
        return fn

    def _job_enqueueable(self, job: JobInfo) -> int:
        if not job.has_min_resources:
            return PERMIT
        min_req = job.min_request()
        for qname in self._chain(job.queue):
            attr = self.attrs[qname]
            future = attr.allocated.clone().add(attr.inqueue) \
                .add(min_req).sub_unchecked(attr.elastic)
            if not future.less_equal_with_dimensions(
                    attr.real_capability, min_req.res.keys()):
                return REJECT
        return PERMIT

    def _job_enqueued(self, job: JobInfo):
        if not job.has_min_resources:
            return
        min_req = job.min_request()
        for qname in self._chain(job.queue):
            self.attrs[qname].inqueue.add(min_req)

    def _on_event(self, ssn, event, sign: int):
        job = ssn.jobs.get(event.task.job)
        if job is None:
            return
        for qname in self._chain(job.queue):
            attr = self.attrs[qname]
            if sign > 0:
                attr.allocated.add(event.task.resreq)
            else:
                attr.allocated.sub_unchecked(event.task.resreq)
        # hierarchical queues need the root in attrs even if unused

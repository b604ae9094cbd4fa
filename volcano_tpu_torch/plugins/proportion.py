"""Proportion plugin — weight-proportional queue fair share.

Reference parity: plugins/proportion/proportion.go:268-494.  Computes a
per-queue "deserved" resource vector by weighted water-filling of the
cluster total (per dimension, capped by the queue's demand and
capability, floored by its guarantee), then gates allocation, admission
and reclaim on it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE, Resource
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import (
    ABSTAIN, PERMIT, REJECT, EventHandler,
)


class _QueueAttr:
    __slots__ = ("queue", "weight", "deserved", "allocated", "request",
                 "inqueue", "capability", "guarantee", "real_capability",
                 "elastic")

    def __init__(self, queue: QueueInfo):
        self.queue = queue
        self.weight = queue.weight
        self.deserved = Resource()
        self.allocated = Resource()
        self.request = Resource()
        self.inqueue = Resource()
        # resources running jobs hold BEYOND their gang floors — they
        # can be reclaimed without breaking any gang, so admission math
        # treats them as available (proportion.go attr.elastic)
        self.elastic = Resource()
        self.capability = queue.capability
        self.guarantee = queue.guarantee
        # cluster total minus other queues' guarantees, capped by
        # capability (proportion.go:132-138) — the admission ceiling.
        self.real_capability = Resource()

    def share(self) -> float:
        s = 0.0
        for dim, alloc in self.allocated.res.items():
            d = self.deserved.get(dim)
            if d > MIN_RESOURCE:
                s = max(s, alloc / d)
            elif alloc > MIN_RESOURCE:
                s = max(s, float("inf"))
        return s


@register_plugin("proportion")
class ProportionPlugin(Plugin):
    name = "proportion"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.attrs: Dict[str, _QueueAttr] = {}

    def on_session_open(self, ssn):
        total = ssn.total_resource
        total_guarantee = Resource()
        for q in ssn.queues.values():
            self.attrs[q.name] = _QueueAttr(q)
            total_guarantee.add(q.guarantee)
        for a in self.attrs.values():
            rc = total.clone().sub_unchecked(total_guarantee).add(a.guarantee)
            if a.capability is not None:
                # cap only the dims capability sets; unset dims unlimited
                for dim, val in a.capability.res.items():
                    rc.res[dim] = min(rc.res.get(dim, val), val)
            a.real_capability = rc

        for job in ssn.jobs.values():
            attr = self.attrs.get(job.queue)
            if attr is None:
                continue
            attr.request.add(job.total_request)
            allocated = job.allocated()
            attr.allocated.add(allocated)
            attr.elastic.add(job.elastic_resources(allocated))
            if job.podgroup and job.podgroup.phase is PodGroupPhase.INQUEUE \
                    and not job.is_ready() and job.has_min_resources:
                attr.inqueue.add(job.min_request())

        self._compute_deserved(total)
        self._export_queue_metrics()

        ssn.add_queue_order_fn(self.name, self._queue_order)
        ssn.add_allocatable_fn(self.name, self._allocatable)
        ssn.add_overused_fn(self.name, self._overused)
        ssn.add_preemptive_fn(self.name, self._preemptive)
        ssn.add_reclaimable_fn(self.name, self._reclaimable(ssn))
        ssn.add_job_enqueueable_fn(self.name, self._job_enqueueable)
        ssn.add_job_enqueued_fn(self.name, self._job_enqueued)
        ssn.add_event_handler(EventHandler(
            allocate_fn=lambda e: self._on_allocate(ssn, e),
            deallocate_fn=lambda e: self._on_deallocate(ssn, e)))

    def _export_queue_metrics(self):
        """Per-queue share/weight/deserved/allocated/request gauges
        (reference metrics/queue.go, updated by the proportion
        plugin).  Whole families are swapped atomically so deleted
        queues don't linger and a concurrent scrape never sees a
        half-cleared family."""
        from volcano_tpu_torch import metrics
        families = {"queue_share", "queue_weight"}
        rows = []
        for metric in ("deserved", "allocated", "request"):
            for suffix in ("_milli_cpu", "_memory_bytes",
                           "_scalar_resources"):
                families.add(f"queue_{metric}{suffix}")
        for name, a in self.attrs.items():
            rows.append(("queue_share", {"queue": name}, a.share()))
            rows.append(("queue_weight", {"queue": name}, a.weight))
            for metric, res in (("deserved", a.deserved),
                                ("allocated", a.allocated),
                                ("request", a.request)):
                rows.extend(metrics.resource_gauge_rows(
                    f"queue_{metric}", res, queue=name))
        metrics.swap_gauge_families(families, rows)

    def _compute_deserved(self, total: Resource):
        """Per-dimension weighted max-min fair share."""
        dims = set(total.res)
        for dim in dims:
            cap_total = total.get(dim)
            # per-queue cap: demand (request) plus guarantee floor,
            # bounded by capability
            caps = {}
            for name, a in self.attrs.items():
                demand = max(a.request.get(dim), a.guarantee.get(dim))
                if a.capability is not None and dim in a.capability.res:
                    demand = min(demand, a.capability.get(dim))
                caps[name] = demand
            got = self._water_fill(cap_total, caps,
                                   {n: a.weight for n, a in self.attrs.items()})
            for name, amount in got.items():
                if amount > 0:
                    self.attrs[name].deserved.res[dim] = amount
        # guarantee floor (a queue's guarantee is reserved even if idle)
        for a in self.attrs.values():
            a.deserved.set_max(a.guarantee)

    @staticmethod
    def _water_fill(total: float, caps: Dict[str, float],
                    weights: Dict[str, float]) -> Dict[str, float]:
        got = {n: 0.0 for n in caps}
        active = {n for n, c in caps.items() if c > MIN_RESOURCE}
        remaining = total
        while active and remaining > MIN_RESOURCE:
            tw = sum(weights[n] for n in active)
            if tw <= 0:
                break
            progressed = False
            distributed = 0.0
            for n in list(active):
                share = remaining * weights[n] / tw
                take = min(share, caps[n] - got[n])
                if take > MIN_RESOURCE:
                    got[n] += take
                    distributed += take
                    progressed = True
                if caps[n] - got[n] <= MIN_RESOURCE:
                    active.discard(n)
            remaining -= distributed
            if not progressed:
                break
        return got

    # -- callbacks -----------------------------------------------------

    def _queue_order(self, a: QueueInfo, b: QueueInfo) -> int:
        sa, sb = self.attrs[a.name].share(), self.attrs[b.name].share()
        return -1 if sa < sb else (1 if sb < sa else 0)

    def _allocatable(self, queue: QueueInfo, task: TaskInfo) -> bool:
        """Fairness gate: future usage must stay within deserved on the
        dimensions the task requests; a dim absent from deserved means
        the queue deserves none of it and blocks (reference
        LessEqualWithDimension semantics)."""
        attr = self.attrs[queue.name]
        future = attr.allocated.clone().add(task.resreq)
        return future.less_equal_with_dimensions(attr.deserved,
                                                 task.resreq.res.keys())

    def _overused(self, queue: QueueInfo) -> bool:
        return self.attrs[queue.name].share() >= 1.0 - 1e-9

    def _preemptive(self, queue: QueueInfo, task: TaskInfo) -> bool:
        """May this queue still absorb *task* via reclaim?  Same
        deserved-share math as allocatable (proportion.go:385-388)."""
        return self._allocatable(queue, task)

    def _reclaimable(self, ssn):
        def fn(ctx, candidates: List[TaskInfo]):
            victims = []
            evicted = defaultdict(lambda: Resource())
            for t in candidates:
                job = ssn.jobs.get(t.job)
                if job is None:
                    continue
                attr = self.attrs.get(job.queue)
                if attr is None or not attr.queue.reclaimable:
                    continue
                # Reference semantics (proportion.go reclaimFn): a
                # victim may be taken while the queue is still OVER its
                # deserved share in at least one dimension (progressive
                # decrement; the last victim may overshoot).  Requiring
                # the queue to stay >= deserved in EVERY dimension
                # deadlocks mixed-dimension shares: a queue hoarding
                # all the chips but little cpu would never be
                # reclaimable because evictions also lower its
                # (already-under-deserved) cpu.
                current = attr.allocated.clone() \
                    .sub_unchecked(evicted[job.queue])
                if current.less_equal(attr.deserved, zero="defaultZero"):
                    continue   # at/under deserved everywhere: protected
                victims.append(t)
                evicted[job.queue].add(t.resreq)
            return victims
        return fn

    def _job_enqueueable(self, job: JobInfo) -> int:
        """Admission is capacity-gated (realCapability), NOT fairness-
        gated: a job may enqueue beyond its queue's deserved share and
        wait for reclaim (proportion.go:404-440)."""
        attr = self.attrs.get(job.queue)
        if attr is None:
            return ABSTAIN
        if not job.has_min_resources:
            return PERMIT  # proportion.go:421-424
        min_req = job.min_request()
        # elastic resources are reclaimable without gang harm, so they
        # don't block admission (proportion.go:430)
        future = attr.allocated.clone().add(attr.inqueue).add(min_req) \
            .sub_unchecked(attr.elastic)
        if future.less_equal_with_dimensions(attr.real_capability,
                                             min_req.res.keys()):
            return PERMIT
        return REJECT

    def _job_enqueued(self, job: JobInfo):
        if not job.has_min_resources:
            return  # proportion.go:443
        attr = self.attrs.get(job.queue)
        if attr is not None:
            attr.inqueue.add(job.min_request())

    def _on_allocate(self, ssn, event):
        job = ssn.jobs.get(event.task.job)
        if job:
            attr = self.attrs.get(job.queue)
            if attr:
                attr.allocated.add(event.task.resreq)

    def _on_deallocate(self, ssn, event):
        job = ssn.jobs.get(event.task.job)
        if job:
            attr = self.attrs.get(job.queue)
            if attr:
                attr.allocated.sub_unchecked(event.task.resreq)

    def queue_deserved(self, name: str) -> Resource:
        return self.attrs[name].deserved.clone() if name in self.attrs \
            else Resource()

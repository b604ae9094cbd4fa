"""Gangpreempt action — gang-aware, domain-scoped preemption for
topology jobs.

Reference parity: actions/gangpreempt/gangpreempt.go:78,137,183.  For
each starving hard-topology job: walk candidate hypernode domains in
gradient order; inside a domain build victim Bundles (safe = beyond
minAvailable, whole = entire gang), gate them through UnifiedEvictable,
evict cumulatively cheapest-first and after each bundle simulate a full
nomination plan (dry-run placement of the preemptor onto the domain's
future-idle).  On success: commit the evictions, pin the domain into
the PodGroup nomination annotation and each planned pod's
nominatedNodeName — the NEXT allocate cycle takes the fast path
(gangpreempt.go:124-128 -> allocate.go:331-341,595-717).
"""

from __future__ import annotations

import logging
from typing import List

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.framework.statement import ALLOCATE, PIPELINE
from volcano_tpu_torch.util import PriorityQueue
from volcano_tpu_torch import metrics

from volcano_tpu_torch.actions.bundle import (
    create_job_bundles,
    sort_bundles_for_preempt,
)
from volcano_tpu_torch.actions.util import may_preempt
from volcano_tpu_torch.actions.topology_alloc import candidate_domains

log = logging.getLogger(__name__)

MAX_DOMAINS = 8  # cap per job per cycle (reference maxDomains)


class EvictContext:
    """What the UnifiedEvictable plugins see."""

    __slots__ = ("preemptor_job", "cross_queue")

    def __init__(self, preemptor_job: JobInfo, cross_queue: bool):
        self.preemptor_job = preemptor_job
        self.cross_queue = cross_queue


def _victim_candidates(ssn, job: JobInfo, domain_nodes,
                       cross_queue: bool) -> List[TaskInfo]:
    out = []
    for node in domain_nodes:
        for t in node.tasks.values():
            if t.status is not TaskStatus.RUNNING or not t.preemptable:
                continue
            vjob = ssn.jobs.get(t.job)
            if vjob is None or vjob.uid == job.uid:
                continue
            if cross_queue:
                if vjob.queue == job.queue:
                    continue
                vqueue = ssn.queues.get(vjob.queue)
                if vqueue is None or not vqueue.reclaimable:
                    continue
            else:
                if vjob.queue != job.queue or vjob.priority >= job.priority:
                    continue
            # session-held task object (node holds a clone)
            vtask = vjob.tasks.get(t.uid)
            if vtask is not None:
                out.append(vtask)
    return out


def preempt_job_in_domains(ssn, job: JobInfo, cross_queue: bool) -> bool:
    """Try each candidate domain; True once one yields a plan."""
    gradients = candidate_domains(ssn, job)
    tried = 0
    for gradient in gradients:
        for domain_name in gradient:
            if tried >= MAX_DOMAINS:
                return False
            tried += 1
            if _try_domain(ssn, job, domain_name, cross_queue):
                return True
    return False


def _try_domain(ssn, job: JobInfo, domain_name: str,
                cross_queue: bool) -> bool:
    from volcano_tpu_torch.actions.allocate import AllocateAction

    info = ssn.hypernodes.members.get(domain_name)
    if info is None:
        return False
    nodes = [ssn.nodes[n] for n in info.nodes if n in ssn.nodes]
    if not nodes:
        return False

    candidates = _victim_candidates(ssn, job, nodes, cross_queue)
    ctx = EvictContext(job, cross_queue)
    evictable = ssn.unified_evictable(ctx, candidates)
    if not evictable:
        return False
    bundles = sort_bundles_for_preempt(create_job_bundles(ssn, evictable))
    if not bundles:
        return False

    queue = ssn.queues.get(job.queue)
    stmt = ssn.statement()
    evicted_uids = set()
    for bundle in bundles:
        # bundles overlap (a job's safe bundle is a subset of its whole
        # bundle); evict only tasks not already taken
        new_victims = [v for v in bundle.tasks if v.uid not in evicted_uids]
        if not new_victims:
            continue
        for victim in new_victims:
            stmt.evict(victim, f"gang-preempted for {job.key}")
            evicted_uids.add(victim.uid)

        # nomination plan: can the preemptor fully land on future idle?
        evict_mark = len(stmt.operations)
        AllocateAction._allocate_tasks(ssn, queue, job, stmt, nodes,
                                       record_errors=False)
        if ssn.job_pipelined(job):
            # record plan, then unwind the placements — allocate
            # re-places next cycle via the nomination fast path
            plan = [(op.task, op.node_name)
                    for op in stmt.operations[evict_mark:]
                    if op.kind in (PIPELINE, ALLOCATE)]
            stmt.rollback_to(evict_mark)
            n_victims = len(stmt.operations)  # only evicts remain
            for task, node_name in plan:
                ssn.cache.nominate(task, node_name)
            for sub in job.sub_jobs.values():
                sub.nominated_hypernode = domain_name
            job.persist_nominations()
            ssn.dirty_jobs.add(job.uid)
            stmt.commit()  # evictions fire
            metrics.inc("gang_preemption_total")
            log.info("gangpreempt: job %s nominated into %s (%d victims)",
                     job.key, domain_name, n_victims)
            return True
        stmt.rollback_to(evict_mark)
    stmt.discard()
    return False


class GangPreemptAction(Action):
    name = "gangpreempt"

    cross_queue = False

    def execute(self, ssn) -> None:
        if ssn.hypernodes is None or len(ssn.hypernodes.members) <= 1:
            return
        for queue_name, queue in sorted(ssn.queues.items()):
            if self.cross_queue and ssn.overused(queue):
                # gangreclaim must not push a queue further past its
                # share (gangreclaim.go:114)
                continue
            starving = [
                job for job in ssn.jobs.values()
                if job.queue == queue_name
                and job.has_topology_constraint()
                and ssn.job_starving(job)
                and ssn.job_valid(job) is None
                and may_preempt(ssn, job)
                and not any(s.nominated_hypernode
                            for s in job.sub_jobs.values())
                and (job.podgroup is None or job.podgroup.phase in
                     (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING,
                      PodGroupPhase.UNKNOWN))
            ]
            jobs = PriorityQueue(ssn.job_order_fn, starving)
            for job in jobs:
                if self.cross_queue and not all(
                        ssn.preemptive(queue, t)
                        for t in job.tasks_in_status(TaskStatus.PENDING)
                        if not t.best_effort):
                    continue  # queue can't absorb it (gangreclaim.go:145)
                preempt_job_in_domains(ssn, job,
                                       cross_queue=self.cross_queue)


class GangReclaimAction(GangPreemptAction):
    name = "gangreclaim"

    cross_queue = True


register_action(GangPreemptAction())
register_action(GangReclaimAction())

"""Reclaim action — cross-queue fair-share enforcement.

Reference parity: actions/reclaim/reclaim.go:56.  A starving queue
(under its deserved share) reclaims resources from queues running over
their deserved share; victims chosen per node from reclaimable queues
ordered by VictimQueueOrder, gated by the Reclaimable plugin
intersection (gang floors, conformance, queue reclaimable flag).
"""

from __future__ import annotations

import logging

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.util import PriorityQueue
from volcano_tpu_torch import metrics

from volcano_tpu_torch.actions.preempt import select_victims_on_node
from volcano_tpu_torch.actions.util import may_preempt

log = logging.getLogger(__name__)


class ReclaimAction(Action):
    name = "reclaim"

    def execute(self, ssn) -> None:
        for queue_name, queue in sorted(ssn.queues.items()):
            if ssn.overused(queue):
                continue
            starving = [
                job for job in ssn.jobs.values()
                if job.queue == queue_name
                and ssn.job_starving(job)
                and ssn.job_valid(job) is None
                # preemptionPolicy: Never bars reclaim too (reclaim.go:144)
                and may_preempt(ssn, job)
                and (job.podgroup is None or job.podgroup.phase in
                     (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING,
                      PodGroupPhase.UNKNOWN))
            ]
            if not starving:
                continue
            jobs = PriorityQueue(ssn.job_order_fn, starving)
            for job in jobs:
                if job.has_topology_constraint():
                    continue  # gangreclaim owns topology jobs
                self._reclaim_for_job(ssn, queue, job)

    def _reclaim_for_job(self, ssn, queue, job: JobInfo):
        stmt = ssn.statement()
        tasks = PriorityQueue(ssn.task_order_fn,
                              (t for t in job.tasks_in_status(TaskStatus.PENDING)
                               if not t.best_effort))
        for task in tasks:
            if not ssn.job_starving(job):
                break  # gang floor met — stop reclaiming (reclaim.go:127)
            # may this queue still absorb the task? (reclaim.go:149)
            if not ssn.preemptive(queue, task):
                continue
            self._reclaim_for_task(ssn, stmt, queue, task)
        if ssn.job_pipelined(job):
            stmt.commit()
            metrics.inc("reclaim_commits_total")
        else:
            stmt.discard()

    @staticmethod
    def _reclaim_for_task(ssn, stmt, queue, task: TaskInfo) -> bool:
        for node in ssn.nodes.values():
            if not node.ready:
                continue
            status, waved = ssn.predicate_for_preempt(task, node)
            if status is not None:
                continue
            if task.init_resreq.less_equal(node.future_idle()) and \
                    (not waved or ssn.predicate(task, node) is None):
                stmt.pipeline(task, node)
                return True
            candidates = []
            for t in node.tasks.values():
                if t.status is not TaskStatus.RUNNING or not t.preemptable:
                    continue
                vjob = ssn.jobs.get(t.job)
                if vjob is None or vjob.queue == queue.name:
                    continue
                vqueue = ssn.queues.get(vjob.queue)
                if vqueue is None or not vqueue.reclaimable:
                    continue
                candidates.append(t)
            victims = ssn.reclaimable(task, candidates)
            chosen = select_victims_on_node(ssn, task, node, victims)
            if chosen is None:
                continue
            mark = len(stmt.operations)
            for victim in chosen:
                vjob = ssn.jobs.get(victim.job)
                vtask = vjob.tasks.get(victim.uid) if vjob else victim
                stmt.evict(vtask or victim, f"reclaimed by queue {queue.name}")
            # evictions must cure the curable failure waved through by
            # predicate_for_preempt, or this evicts every cycle
            # without ever placing the reclaimer
            if waved and ssn.predicate(task, node) is not None:
                stmt.rollback_to(mark)
                continue
            metrics.inc("pod_reclaim_total", len(chosen))
            stmt.pipeline(task, node)
            return True
        return False


register_action(ReclaimAction())

"""Preempt action — in-queue, priority-based preemption.

Reference parity: actions/preempt/preempt.go:101-712 (starving jobs
preempt lower-priority tasks in the same queue; k8s-style dry-run
victim selection per node; preemptor pipelines onto the releasing
resources).  Hard-topology jobs are skipped here — gangpreempt owns
them (preempt.go:130-135).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.util import PriorityQueue
from volcano_tpu_torch import metrics

log = logging.getLogger(__name__)


from volcano_tpu_torch.actions.util import may_preempt, victim_sort_key


def select_victims_on_node(ssn, preemptor: TaskInfo, node,
                           candidates: List[TaskInfo]
                           ) -> Optional[List[TaskInfo]]:
    """Dry-run victim selection: smallest prefix of *candidates* whose
    eviction lets *preemptor* fit node.future_idle (preempt.go
    SelectVictimsOnNode)."""
    if not candidates:
        return None
    chosen: List[TaskInfo] = []
    freed = node.future_idle()
    for victim in sorted(candidates, key=victim_sort_key(ssn)):
        chosen.append(victim)
        freed.add(victim.resreq)
        if preemptor.init_resreq.less_equal(freed):
            return chosen
    return None


class PreemptAction(Action):
    name = "preempt"

    def execute(self, ssn) -> None:
        for queue_name, queue in sorted(ssn.queues.items()):
            starving = [
                job for job in ssn.jobs.values()
                if job.queue == queue_name
                and ssn.job_starving(job)
                and not job.has_topology_constraint()
                and ssn.job_valid(job) is None
                and may_preempt(ssn, job)
                and (job.podgroup is None or job.podgroup.phase in
                     (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING,
                      PodGroupPhase.UNKNOWN))
            ]
            if not starving:
                continue
            jobs = PriorityQueue(ssn.job_order_fn, starving)
            for job in jobs:
                self._preempt_for_job(ssn, queue, job)

    def _preempt_for_job(self, ssn, queue, job: JobInfo):
        stmt = ssn.statement()
        tasks = PriorityQueue(ssn.task_order_fn,
                              (t for t in job.tasks_in_status(TaskStatus.PENDING)
                               if not t.best_effort))
        for task in tasks:
            if not ssn.job_starving(job):
                break  # gang floor met — stop evicting (preempt.go)
            # no queue-share gate: in-queue preemption leaves the
            # queue's total allocation unchanged (reference preempt.go
            # never consults Preemptive)
            self._preempt_for_task(ssn, stmt, queue, job, task)
        if ssn.job_pipelined(job):
            stmt.commit()
            metrics.inc("preemption_victims_total")
        else:
            stmt.discard()

    @staticmethod
    def _preempt_for_task(ssn, stmt, queue, job: JobInfo,
                          task: TaskInfo) -> bool:
        job_priority = job.priority
        for node in ssn.nodes.values():
            if not node.ready:
                continue
            status, waved = ssn.predicate_for_preempt(task, node)
            if status is not None:
                continue
            # no eviction needed if it already fits future idle — but
            # when a curable failure was waved through, the FULL
            # predicate must agree (releasing resources doesn't cure
            # it); with nothing waved the verdicts are identical and
            # re-running the chain would be pure duplicate work
            if task.init_resreq.less_equal(node.future_idle()) and \
                    (not waved or ssn.predicate(task, node) is None):
                stmt.pipeline(task, node)
                return True
            candidates = [
                t for t in node.tasks.values()
                if t.status is TaskStatus.RUNNING
                and t.job != task.job
                and t.preemptable
                and (ssn.jobs[t.job].priority if t.job in ssn.jobs else
                     t.priority) < job_priority
                and (ssn.jobs[t.job].queue == queue.name
                     if t.job in ssn.jobs else False)
            ]
            victims = ssn.preemptable(task, candidates)
            chosen = select_victims_on_node(ssn, task, node, victims)
            if chosen is None:
                continue
            mark = len(stmt.operations)
            for victim in chosen:
                # evict through the session view of the victim task
                vjob = ssn.jobs.get(victim.job)
                vtask = vjob.tasks.get(victim.uid) if vjob else victim
                stmt.evict(vtask or victim,
                           f"preempted by {task.key}")
            # the evictions must actually cure whatever curable failure
            # was waved through (e.g. an occupied NUMA cell): otherwise
            # we'd evict fresh victims every cycle without ever binding
            if waved and ssn.predicate(task, node) is not None:
                stmt.rollback_to(mark)
                continue
            metrics.inc("pod_preemption_total", len(chosen))
            stmt.pipeline(task, node)
            return True
        return False


register_action(PreemptAction())

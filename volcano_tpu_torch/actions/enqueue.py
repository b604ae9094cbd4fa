"""Enqueue action — gang admission gate.

Reference parity: actions/enqueue/enqueue.go:44.  Pending PodGroups are
promoted to Inqueue only when every JobEnqueueable voter (overcommit /
proportion / capacity / sla / resourcequota) permits, so the allocate
action never wastes cycles on jobs the cluster can't hold.
"""

from __future__ import annotations

import logging

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.util import PriorityQueue

log = logging.getLogger(__name__)


class EnqueueAction(Action):
    name = "enqueue"

    def execute(self, ssn) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api import elastic as eapi
        jobs_per_queue = {}
        for job in ssn.jobs.values():
            if job.podgroup is None or \
                    job.podgroup.phase is not PodGroupPhase.PENDING:
                continue
            if eapi.evacuating(job.podgroup):
                # cross-region evacuation hold (api/elastic.py): the
                # drained gang belongs to the federation cutover now —
                # admitting it would race the destination region's
                # re-place against a local one
                metrics.inc("sched_unschedulable_reasons_total",
                            reason="evacuating-region")
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None or not queue.is_open():
                continue
            jobs_per_queue.setdefault(
                queue.name, PriorityQueue(ssn.job_order_fn)).push(job)

        queues = PriorityQueue(ssn.queue_order_fn,
                               (ssn.queues[qn] for qn in jobs_per_queue))
        while not queues.empty():
            queue = queues.pop()
            jobs = jobs_per_queue[queue.name]
            if jobs.empty():
                continue
            job = jobs.pop()
            if ssn.job_enqueueable(job):
                job.podgroup.phase = PodGroupPhase.INQUEUE
                # lifecycle stamp: ONE gang admission timestamp on the
                # podgroup (not N pod writes); pods inherit it in the
                # e2e phase decomposition (trace.phase_segments)
                trace.stamp_phase(job.podgroup.annotations, "enqueued")
                ssn.job_enqueued(job)
                ssn.dirty_jobs.add(job.uid)
                log.debug("enqueued job %s", job.key)
            queues.push(queue)


register_action(EnqueueAction())

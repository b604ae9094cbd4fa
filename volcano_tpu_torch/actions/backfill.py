"""Backfill action — place BestEffort (no-request) tasks.

Reference parity: actions/backfill/backfill.go.  Best-effort tasks
don't consume accounted resources, so each is bound individually as
soon as any predicate-passing node exists — no gang gating.
"""

from __future__ import annotations

import logging

from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.framework.plugins import Action, register_action

from volcano_tpu_torch.actions.util import predicate_nodes, prioritize_nodes

log = logging.getLogger(__name__)


class BackfillAction(Action):
    name = "backfill"

    def execute(self, ssn) -> None:
        for job in ssn.jobs.values():
            # cheap emptiness probe FIRST: on a steady fleet the
            # per-job gang-validity walk below cost more than every
            # other action combined, for jobs with nothing to backfill
            pending = job.task_status_index.get(TaskStatus.PENDING)
            if not pending:
                continue
            if job.podgroup is not None and \
                    job.podgroup.phase is PodGroupPhase.PENDING and \
                    "enqueue" in ssn.conf.actions:
                continue
            if ssn.job_valid(job) is not None:
                continue
            for task in list(pending.values()):
                if not task.best_effort:
                    continue
                nodes = predicate_nodes(ssn, task,
                                        list(ssn.nodes.values()))
                node = prioritize_nodes(ssn, task, nodes)
                if node is None:
                    continue
                stmt = ssn.statement()
                stmt.allocate(task, node)
                stmt.commit()


register_action(BackfillAction())

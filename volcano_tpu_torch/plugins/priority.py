"""Priority plugin (reference: plugins/priority/priority.go:69-178)."""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import ABSTAIN, REJECT


@register_plugin("priority")
class PriorityPlugin(Plugin):
    name = "priority"

    def on_session_open(self, ssn):
        ssn.add_task_order_fn(self.name, self._task_order)
        ssn.add_job_order_fn(self.name, self._job_order)
        ssn.add_preemptable_fn(self.name, self._preemptable(ssn))
        ssn.add_job_starving_fn(self.name, self._job_starving)

    @staticmethod
    def _task_order(a: TaskInfo, b: TaskInfo) -> int:
        return -1 if a.priority > b.priority else (1 if b.priority > a.priority else 0)

    @staticmethod
    def _job_order(a: JobInfo, b: JobInfo) -> int:
        return -1 if a.priority > b.priority else (1 if b.priority > a.priority else 0)

    def _preemptable(self, ssn):
        def fn(preemptor: TaskInfo, candidates: List[TaskInfo]):
            pjob = ssn.jobs.get(preemptor.job)
            p_prio = pjob.priority if pjob else preemptor.priority
            return [t for t in candidates
                    if (ssn.jobs[t.job].priority if t.job in ssn.jobs
                        else t.priority) < p_prio]
        return fn

    @staticmethod
    def _job_starving(job: JobInfo) -> int:
        """Priority only abstains/rejects: a job with nothing pending
        cannot be starving (priority.go:178)."""
        from volcano_tpu_torch.api.types import TaskStatus
        return ABSTAIN if job.tasks_in_status(TaskStatus.PENDING) else REJECT

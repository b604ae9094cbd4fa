"""Gang plugin — the all-or-nothing core.

Reference parity: pkg/scheduler/plugins/gang/gang.go:84-250.  Registers
JobValid (schedulable tasks >= minAvailable), JobReady/JobPipelined
(including per-task-spec and subgroup minima), JobOrder (starving gangs
first), JobStarving, and the eviction veto that refuses to break a
victim job's gang floor (gang.go:113-118).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import PERMIT, REJECT


@register_plugin("gang")
class GangPlugin(Plugin):
    name = "gang"

    def on_session_close(self, ssn):
        """Record unschedulable gangs + unready task counts at session
        end (gang.go OnSessionClose: unScheduleJobCount metrics and
        Unschedulable events)."""
        from volcano_tpu_torch import metrics
        unready_tasks = 0
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if not job.tasks or job.is_ready():
                continue
            unschedulable_jobs += 1
            unready_tasks += max(
                0, job.min_available - job.ready_task_num())
            ssn.cache.record_event(
                job.key, "Unschedulable",
                job.fit_error() or
                f"{job.ready_task_num()}/{job.min_available} tasks ready")
        # gauges: the CURRENT unschedulable population, not a running
        # total (reference metrics.go:166-180 uses .Set)
        metrics.set_gauge("unschedule_job_count", unschedulable_jobs)
        metrics.set_gauge("unschedule_task_count", unready_tasks)

    def on_session_open(self, ssn):
        ssn.add_job_valid_fn(self.name, self._job_valid)
        ssn.add_job_ready_fn(self.name, self._job_ready)
        ssn.add_job_pipelined_fn(self.name, self._job_pipelined)
        ssn.add_job_starving_fn(self.name, self._job_starving)
        ssn.add_job_order_fn(self.name, self._job_order)
        ssn.add_preemptable_fn(self.name,
                               lambda ctx, cands: self._gang_guard(ssn, cands))
        ssn.add_reclaimable_fn(self.name,
                               lambda ctx, cands: self._gang_guard(ssn, cands))
        # Gang-aware (bundle-based) eviction manages MinAvailable via the
        # safe/whole bundle split itself, so UnifiedEvictable permits all
        # candidates (gang.go:133-137) — unlike the per-task guard above.
        ssn.add_unified_evictable_fn(self.name,
                                     lambda ctx, cands: list(cands))

    @staticmethod
    def _job_valid(job: JobInfo):
        if job.valid_task_num() < job.min_available:
            return ("NotEnoughPods",
                    f"job {job.key} has {job.valid_task_num()} schedulable "
                    f"tasks, minAvailable={job.min_available}")
        if not job.check_task_min_available():
            return ("NotEnoughTaskPods",
                    f"job {job.key} cannot satisfy per-task minAvailable "
                    f"{job.task_min_available}")
        return None

    @staticmethod
    def _job_ready(job: JobInfo) -> bool:
        if not job.is_ready():
            return False
        if not job.check_task_min_available_ready():
            return False
        return all(sub.is_ready() for sub in job.sub_jobs.values()
                   if sub.min_member > 0)

    @staticmethod
    def _job_pipelined(job: JobInfo) -> int:
        ok = (job.is_pipelined()
              and job.check_task_min_available_pipelined()
              and all(sub.is_pipelined() for sub in job.sub_jobs.values()
                      if sub.min_member > 0))
        return PERMIT if ok else REJECT

    @staticmethod
    def _job_starving(job: JobInfo) -> int:
        return PERMIT if job.is_starving() else REJECT

    @staticmethod
    def _job_order(a: JobInfo, b: JobInfo) -> int:
        """Jobs still chasing their gang floor sort before satisfied
        ones (gang.go JobOrderFn)."""
        a_ready, b_ready = a.is_ready(), b.is_ready()
        if a_ready and not b_ready:
            return 1
        if b_ready and not a_ready:
            return -1
        return 0

    @staticmethod
    def _gang_guard(ssn, candidates: List[TaskInfo]) -> List[TaskInfo]:
        """Allow evicting only tasks beyond each victim job's gang floor."""
        victims: List[TaskInfo] = []
        evicted_per_job: Dict[str, int] = defaultdict(int)
        for task in candidates:
            job = ssn.jobs.get(task.job)
            if job is None:
                victims.append(task)
                continue
            occupied = job.ready_task_num()
            if occupied - evicted_per_job[task.job] > job.min_available:
                victims.append(task)
                evicted_per_job[task.job] += 1
        return victims

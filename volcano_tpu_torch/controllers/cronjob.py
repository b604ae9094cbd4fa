"""CronJob controller — cron-scheduled vcjobs.

Reference parity: pkg/controllers/cronjob (batch/v1alpha1 CronJob:
schedule + concurrencyPolicy Allow|Forbid|Replace, job.go:508).
Includes a dependency-free 5-field cron matcher.
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional

from volcano_tpu_torch.api.pod import new_uid
from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES
from volcano_tpu_torch.api.vcjob import VCJob
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)


def _match_field(spec: str, value: int, minimum: int = 0) -> bool:
    """One cron field: '*', '*/n', 'a', 'a-b', 'a,b,c' combinations."""
    for part in spec.split(","):
        part = part.strip()
        if part == "*":
            return True
        if part.startswith("*/"):
            try:
                step = int(part[2:])
            except ValueError:
                continue
            if step > 0 and (value - minimum) % step == 0:
                return True
        elif "-" in part:
            try:
                lo, hi = (int(x) for x in part.split("-", 1))
            except ValueError:
                continue
            if lo <= value <= hi:
                return True
        else:
            try:
                if int(part) == value:
                    return True
            except ValueError:
                continue
    return False


def cron_field_valid(spec: str, lo: int, hi: int) -> bool:
    """Syntax + bounds check for one cron field ('*', '*/n', 'a',
    'a-b', comma lists) — the admission-time twin of _match_field."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            return False
        if part == "*":
            continue
        if part.startswith("*/"):
            try:
                step = int(part[2:])
            except ValueError:
                return False
            if step <= 0:
                return False
        elif "-" in part:
            try:
                a, b = (int(x) for x in part.split("-", 1))
            except ValueError:
                return False
            if not (lo <= a <= b <= hi):
                return False
        else:
            try:
                v = int(part)
            except ValueError:
                return False
            if not lo <= v <= hi:
                return False
    return True


def cron_matches(schedule: str, ts: Optional[float] = None) -> bool:
    """minute hour day-of-month month day-of-week."""
    fields = schedule.split()
    if len(fields) != 5:
        return False
    t = time.localtime(ts)
    dow = (t.tm_wday + 1) % 7   # cron: 0 = Sunday
    values = (t.tm_min, t.tm_hour, t.tm_mday, t.tm_mon, dow)
    minima = (0, 0, 1, 1, 0)
    for i, (f, v, m) in enumerate(zip(fields, values, minima)):
        if _match_field(f, v, m):
            continue
        # standard cron accepts 7 as a Sunday alias in day-of-week
        if i == 4 and v == 0 and _match_field(f, 7, m):
            continue
        return False
    return True


@dataclass
class CronJob:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    schedule: str = "* * * * *"
    concurrency_policy: str = "Allow"   # Allow | Forbid | Replace
    suspend: bool = False
    job_template: Optional[VCJob] = None
    successful_jobs_history_limit: int = 3

    last_schedule_time: float = 0.0
    active_jobs: List[str] = field(default_factory=list)
    finished_jobs: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@register_controller("cronjob")
class CronJobController(Controller):
    name = "cronjob"

    def initialize(self, cluster):
        super().initialize(cluster)
        if not hasattr(cluster, "cronjobs"):
            cluster.cronjobs = {}

    def sync(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        for cron in list(self.cluster.cronjobs.values()):
            try:
                self.sync_cron(cron, now)
            except Exception:  # noqa: BLE001
                log.exception("cronjob %s sync failed", cron.key)

    def sync_cron(self, cron: CronJob, now: float) -> None:
        before = (list(cron.active_jobs), list(cron.finished_jobs),
                  cron.last_schedule_time)
        self._reconcile(cron, now)
        if (cron.active_jobs, cron.finished_jobs,
                cron.last_schedule_time) != before:
            self.cluster.put_object("cronjob", cron)

    def _reconcile(self, cron: CronJob, now: float) -> None:
        # prune finished runs from active list; enforce history limit
        finished = []
        still_active = []
        for key in cron.active_jobs:
            job = self.cluster.vcjobs.get(key)
            if job is None:
                continue
            if job.phase in FINISHED_JOB_PHASES:
                finished.append(key)
            else:
                still_active.append(key)
        cron.active_jobs = still_active
        cron.finished_jobs.extend(finished)
        while len(cron.finished_jobs) > cron.successful_jobs_history_limit:
            victim = cron.finished_jobs.pop(0)
            self.cluster.delete_vcjob(victim)

        if cron.suspend or cron.job_template is None:
            return
        # fire at most once per matching minute
        if not cron_matches(cron.schedule, now):
            return
        if now - cron.last_schedule_time < 60:
            return

        if cron.active_jobs:
            if cron.concurrency_policy == "Forbid":
                log.info("cronjob %s: run skipped (Forbid, %d active)",
                         cron.key, len(cron.active_jobs))
                return
            if cron.concurrency_policy == "Replace":
                for key in cron.active_jobs:
                    self.cluster.delete_vcjob(key)
                cron.active_jobs = []

        job = copy.deepcopy(cron.job_template)
        job.name = f"{cron.name}-{int(now)}"
        job.namespace = cron.namespace
        job.uid = new_uid()
        self.cluster.add_vcjob(job)
        cron.active_jobs.append(job.key)
        cron.last_schedule_time = now
        log.info("cronjob %s fired %s", cron.key, job.key)

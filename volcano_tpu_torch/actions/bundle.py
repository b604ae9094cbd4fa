"""Victim bundles for gang-aware eviction.

Reference parity: actions/utils/bundle.go:53,232,248 (CreateJobBundles:
SAFE bundles hold only tasks beyond the victim job's gang floor so the
victim survives; WHOLE bundles take the entire job down.  Sorted for
preemption by type then ROI so the cheapest sufficient eviction wins).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.actions.util import victim_sort_key

SAFE = "safe"
WHOLE = "whole"


@dataclass
class Bundle:
    job_uid: str
    kind: str
    tasks: List[TaskInfo] = field(default_factory=list)
    freed: Resource = field(default_factory=Resource)
    job_priority: int = 0

    def add(self, task: TaskInfo):
        self.tasks.append(task)
        self.freed.add(task.resreq)


def create_job_bundles(ssn, candidates: List[TaskInfo]) -> List[Bundle]:
    """Group candidate victims by job into SAFE and WHOLE bundles.

    SAFE: up to (occupying - minAvailable) cheapest tasks — eviction
    keeps the victim's gang intact.  WHOLE: every occupying task of the
    job, valid only when ALL of them are in the candidate set (you
    can't take a gang half down).
    """
    by_job: Dict[str, List[TaskInfo]] = defaultdict(list)
    for t in candidates:
        by_job[t.job].append(t)

    bundles: List[Bundle] = []
    for job_uid, tasks in by_job.items():
        job = ssn.jobs.get(job_uid)
        if job is None:
            b = Bundle(job_uid, SAFE)
            for t in tasks:
                b.add(t)
            bundles.append(b)
            continue
        occupying = [t for t in job.tasks.values()
                     if t.occupies_resources()]
        surplus = len(occupying) - job.min_available
        ordered = sorted(tasks, key=victim_sort_key(ssn))
        if surplus > 0:
            safe = Bundle(job_uid, SAFE, job_priority=job.priority)
            for t in ordered[:surplus]:
                safe.add(t)
            if safe.tasks:
                bundles.append(safe)
        if len(tasks) >= len(occupying) and occupying:
            whole = Bundle(job_uid, WHOLE, job_priority=job.priority)
            for t in ordered:
                whole.add(t)
            bundles.append(whole)
    return bundles


def sort_bundles_for_preempt(bundles: List[Bundle]) -> List[Bundle]:
    """SAFE before WHOLE; lower-priority victims first; smaller freed
    first (cumulative eviction stops as soon as the plan fits, so
    cheap-first minimizes collateral damage)."""
    return sorted(bundles, key=lambda b: (
        0 if b.kind == SAFE else 1,
        b.job_priority,
        sum(b.freed.res.values()),
    ))

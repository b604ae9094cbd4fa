"""Garbage collector — TTL cleanup of finished jobs.

Reference parity: pkg/controllers/garbagecollector/garbagecollector.go
(ttlSecondsAfterFinished).
"""

from __future__ import annotations

import logging
import time

from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES as FINISHED
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)


@register_controller("garbagecollector")
class GarbageCollector(Controller):
    name = "garbagecollector"

    def sync(self) -> None:
        now = time.time()
        snap = self.cluster.list_all()
        for job in snap.vcjobs:
            ttl = job.ttl_seconds_after_finished
            if ttl is None or job.phase not in FINISHED:
                continue
            finished_at = job.finish_time or job.creation_time
            if now - finished_at >= ttl:
                log.info("gc: deleting finished job %s (ttl %ds)",
                         job.key, ttl)
                self.cluster.delete_vcjob(job.key)
                self.cluster.delete_podgroup(job.key)
                for pod in list(self.cluster.pods.values()):
                    if pod.owner == job.uid:
                        self.cluster.delete_pod(pod.key)
                # drop the job's labeled metric series (job_retry_counts
                # etc.) with the object, reference metrics/job.go delete
                from volcano_tpu_torch import metrics
                metrics.delete_labeled(job=job.key)

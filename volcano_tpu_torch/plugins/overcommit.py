"""Overcommit plugin — admit jobs up to factor x cluster capacity.

Reference parity: plugins/overcommit/overcommit.go:112,136.
"""

from __future__ import annotations

from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import PERMIT, REJECT

DEFAULT_FACTOR = 1.2


@register_plugin("overcommit")
class OvercommitPlugin(Plugin):
    name = "overcommit"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.factor = float(self.arguments.get("overcommit-factor",
                                               DEFAULT_FACTOR))
        self.idle = Resource()
        self.inqueue = Resource()

    def on_session_open(self, ssn):
        total = ssn.total_resource.clone().multi(self.factor)
        used = Resource()
        for job in ssn.jobs.values():
            used.add(job.allocated())
            if job.podgroup and job.podgroup.phase is PodGroupPhase.INQUEUE \
                    and not job.is_ready() and job.has_min_resources:
                self.inqueue.add(job.min_request())
        self.idle = total.sub_unchecked(used)
        ssn.add_job_enqueueable_fn(self.name, self._job_enqueueable)
        ssn.add_job_enqueued_fn(self.name, self._job_enqueued)

    def _job_enqueueable(self, job: JobInfo) -> int:
        if not job.has_min_resources:
            # no declared minResources => always admit; the gang floor
            # is enforced at allocate time (overcommit.go:117-121)
            return PERMIT
        future = self.inqueue.clone().add(job.min_request())
        return PERMIT if future.less_equal(self.idle, zero="defaultInfinity") \
            else REJECT

    def _job_enqueued(self, job: JobInfo):
        if job.has_min_resources:
            self.inqueue.add(job.min_request())

"""Resourcequota plugin — namespace quota check at enqueue.

Reference parity: plugins/resourcequota/resourcequota.go:55,97.
Quotas are registered on the cluster as config_maps under key
"resourcequota/<namespace>" with resource-list values.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import ABSTAIN, PERMIT, REJECT


def quota_key(namespace: str) -> str:
    return f"resourcequota/{namespace}"


@register_plugin("resourcequota")
class ResourceQuotaPlugin(Plugin):
    name = "resourcequota"

    def on_session_open(self, ssn):
        self.ssn = ssn
        self.pending_by_ns: Dict[str, Resource] = defaultdict(Resource)
        ssn.add_job_enqueueable_fn(self.name, self._job_enqueueable)
        ssn.add_job_enqueued_fn(self.name, self._job_enqueued)

    def _quota(self, namespace: str):
        cm = getattr(self.ssn.cache.cluster, "config_maps", {})
        raw = cm.get(quota_key(namespace))
        if not raw:
            return None
        return Resource.from_resource_list(raw)

    def _used(self, namespace: str) -> Resource:
        used = Resource()
        for job in self.ssn.jobs.values():
            if job.namespace == namespace:
                used.add(job.allocated())
        return used

    def _job_enqueueable(self, job: JobInfo) -> int:
        quota = self._quota(job.namespace)
        if quota is None:
            return ABSTAIN
        future = self._used(job.namespace) \
            .add(self.pending_by_ns[job.namespace]) \
            .add(job.min_request())
        if future.less_equal(quota, zero="defaultInfinity"):
            return PERMIT
        return REJECT

    def _job_enqueued(self, job: JobInfo):
        if self._quota(job.namespace) is not None:
            self.pending_by_ns[job.namespace].add(job.min_request())

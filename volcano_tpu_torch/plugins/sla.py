"""SLA plugin — job waiting-time escalation.

Reference parity: plugins/sla/sla.go:134-153 (jobs past their SLA
waiting time jump the order and force admission).  Argument:
  sla-waiting-time: seconds (global), or per-job annotation
  sla.volcano-tpu.io/waiting-time.
"""

from __future__ import annotations

import time

from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import ABSTAIN, PERMIT

WAITING_TIME_ANNOTATION = "sla.volcano-tpu.io/waiting-time"


@register_plugin("sla")
class SLAPlugin(Plugin):
    name = "sla"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        raw = self.arguments.get("sla-waiting-time")
        self.global_waiting = float(raw) if raw is not None else None

    def _waiting_time(self, job: JobInfo):
        if job.podgroup is not None:
            raw = job.podgroup.annotations.get(WAITING_TIME_ANNOTATION)
            if raw:
                try:
                    return float(raw)
                except ValueError:
                    pass
        return self.global_waiting

    def _breached(self, job: JobInfo) -> bool:
        waiting = self._waiting_time(job)
        if waiting is None:
            return False
        return time.time() - job.creation_time >= waiting

    def on_session_open(self, ssn):
        ssn.add_job_order_fn(self.name, self._job_order)
        ssn.add_job_enqueueable_fn(self.name, self._job_enqueueable)
        ssn.add_job_pipelined_fn(self.name, self._job_pipelined)

    def _job_order(self, a: JobInfo, b: JobInfo) -> int:
        ba, bb = self._breached(a), self._breached(b)
        if ba and not bb:
            return -1
        if bb and not ba:
            return 1
        return 0

    def _job_enqueueable(self, job: JobInfo) -> int:
        return PERMIT if self._breached(job) else ABSTAIN

    def _job_pipelined(self, job: JobInfo) -> int:
        return PERMIT if self._breached(job) else ABSTAIN

"""CDP plugin — cooldown protection after pod start.

Reference parity: plugins/cdp/cdp.go:108-109 (freshly started pods are
shielded from preemption/reclaim for a cooldown window).  Argument:
  cooldown-time: seconds (default 600); per-pod override annotation
  volcano-tpu.io/cooldown-time.
"""

from __future__ import annotations

import time
from typing import List

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

COOLDOWN_ANNOTATION = "volcano-tpu.io/cooldown-time"
START_TIME_ANNOTATION = "volcano-tpu.io/start-time"
DEFAULT_COOLDOWN = 600.0


@register_plugin("cdp")
class CDPPlugin(Plugin):
    name = "cdp"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.cooldown = float(self.arguments.get("cooldown-time",
                                                 DEFAULT_COOLDOWN))

    def on_session_open(self, ssn):
        ssn.add_preemptable_fn(self.name, self._filter)
        ssn.add_reclaimable_fn(self.name, self._filter)

    def _in_cooldown(self, task: TaskInfo) -> bool:
        raw = task.pod.annotations.get(START_TIME_ANNOTATION)
        if raw is None:
            return False
        try:
            start = float(raw)
            window = float(task.pod.annotations.get(
                COOLDOWN_ANNOTATION, self.cooldown))
        except ValueError:
            return False
        return time.time() - start < window

    def _filter(self, ctx, candidates: List[TaskInfo]) -> List[TaskInfo]:
        return [t for t in candidates if not self._in_cooldown(t)]

"""TDM plugin — time-division multiplexing of revocable nodes.

Reference parity: plugins/tdm/tdm.go:300-306.  Nodes labeled with a
revocable zone are lent to preemptable ("revocable") jobs during the
zone's active window; when the window closes, their revocable pods are
shuffled off (VictimTasks).  Arguments:
  tdm.revocable-zone.<zone>: "start-end" 24h window, e.g. "0:00-6:00"
  (or "*" for always active).
"""

from __future__ import annotations

import time
from typing import List, Optional

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.types import REVOCABLE_ZONE_ANNOTATION
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

REVOCABLE_ZONE_LABEL = "volcano-tpu.io/revocable-zone"
MAX_SCORE = 100.0


def _window_active(window: str, now: Optional[float] = None) -> bool:
    if window.strip() == "*":
        return True
    try:
        start_s, end_s = window.split("-")
        t = time.localtime(now)
        cur = t.tm_hour * 60 + t.tm_min
        def minutes(s):
            h, m = s.strip().split(":")
            return int(h) * 60 + int(m)
        start, end = minutes(start_s), minutes(end_s)
    except ValueError:
        return False
    if start <= end:
        return start <= cur < end
    return cur >= start or cur < end  # overnight window


@register_plugin("tdm")
class TDMPlugin(Plugin):
    name = "tdm"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        prefix = "tdm.revocable-zone."
        self.zones = {k[len(prefix):]: str(v)
                      for k, v in self.arguments.items()
                      if k.startswith(prefix)}

    def _zone_active(self, zone: str) -> bool:
        return _window_active(self.zones.get(zone, ""))

    @staticmethod
    def _task_revocable(task: TaskInfo) -> bool:
        return task.pod.annotations.get(
            REVOCABLE_ZONE_ANNOTATION) is not None

    def on_session_open(self, ssn):
        self.ssn = ssn
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_victim_tasks_fn(self.name, self._victims)
        ssn.add_preemptable_fn(self.name, self._preemptable)

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        zone = node.labels.get(REVOCABLE_ZONE_LABEL)
        if not zone:
            return None  # normal node
        if not self._task_revocable(task):
            return unschedulable(
                "revocable node only takes revocable tasks", "tdm",
                resolvable=False)
        if not self._zone_active(zone):
            return unschedulable(
                f"revocable zone {zone!r} outside active window", "tdm")
        return None

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        # steer revocable tasks toward revocable nodes in-window
        zone = node.labels.get(REVOCABLE_ZONE_LABEL)
        if zone and self._task_revocable(task) and self._zone_active(zone):
            return MAX_SCORE
        return 0.0

    def _victims(self) -> List[TaskInfo]:
        """Revocable pods on nodes whose window has closed."""
        out = []
        for node in self.ssn.nodes.values():
            zone = node.labels.get(REVOCABLE_ZONE_LABEL)
            if not zone or self._zone_active(zone):
                continue
            for t in node.tasks.values():
                if t.occupies_resources() and self._task_revocable(t):
                    job = self.ssn.jobs.get(t.job)
                    victim = job.tasks.get(t.uid) if job else None
                    out.append(victim or t)
        return out

    def _preemptable(self, ctx, candidates: List[TaskInfo]):
        # revocable tasks are always fair game
        revocable = [t for t in candidates if self._task_revocable(t)]
        return revocable if revocable else None

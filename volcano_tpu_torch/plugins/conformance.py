"""Conformance plugin — never evict critical system pods.

Reference parity: plugins/conformance/conformance.go:65-68.
"""

from __future__ import annotations

from typing import List

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

_CRITICAL_NAMESPACES = {"kube-system"}
_CRITICAL_PRIORITY_CLASSES = {"system-cluster-critical",
                              "system-node-critical"}


@register_plugin("conformance")
class ConformancePlugin(Plugin):
    name = "conformance"

    def on_session_open(self, ssn):
        ssn.add_preemptable_fn(self.name, self._evictable)
        ssn.add_reclaimable_fn(self.name, self._evictable)
        ssn.add_unified_evictable_fn(self.name, self._evictable)

    @staticmethod
    def _evictable(ctx, candidates: List[TaskInfo]) -> List[TaskInfo]:
        return [t for t in candidates
                if t.namespace not in _CRITICAL_NAMESPACES
                and t.pod.priority_class not in _CRITICAL_PRIORITY_CLASSES]

"""Usage plugin — filter/score by real node utilization.

Reference parity: plugins/usage/usage.go:186-187 (thresholds against
metrics-source readings).  The metrics source is pluggable
(volcano_tpu_torch.metrics_source); the node agent publishes usage into node
annotations as the default source.
"""

from __future__ import annotations

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

CPU_USAGE_ANNOTATION = "usage.volcano-tpu.io/cpu"      # 0..1 fraction
MEM_USAGE_ANNOTATION = "usage.volcano-tpu.io/memory"
DEFAULT_CPU_THRESHOLD = 0.8
DEFAULT_MEM_THRESHOLD = 0.8
MAX_SCORE = 100.0


def node_usage(node: NodeInfo, annotation: str) -> float:
    if node.node is None:
        return 0.0
    try:
        return float(node.node.annotations.get(annotation, 0.0))
    except ValueError:
        return 0.0


@register_plugin("usage")
class UsagePlugin(Plugin):
    name = "usage"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        thresholds = self.arguments.get("thresholds", {})
        self.cpu_threshold = float(thresholds.get("cpu",
                                                  DEFAULT_CPU_THRESHOLD))
        self.mem_threshold = float(thresholds.get("mem",
                                                  DEFAULT_MEM_THRESHOLD))
        # reference conf key "usage.weight" (usage.go)
        self.weight = float(self.arguments.get("usage.weight", 1))

    def on_session_open(self, ssn):
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        if node_usage(node, CPU_USAGE_ANNOTATION) > self.cpu_threshold:
            return unschedulable("node cpu usage over threshold", "usage")
        if node_usage(node, MEM_USAGE_ANNOTATION) > self.mem_threshold:
            return unschedulable("node memory usage over threshold", "usage")
        return None

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        used = max(node_usage(node, CPU_USAGE_ANNOTATION),
                   node_usage(node, MEM_USAGE_ANNOTATION))
        return self.weight * MAX_SCORE * (1.0 - min(1.0, used))

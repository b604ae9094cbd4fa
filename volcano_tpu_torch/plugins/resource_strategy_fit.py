"""Resource-strategy-fit plugin — per-resource scoring strategy mix.

Reference parity: plugins/resource-strategy-fit/
resource_strategy_fit.go:266,274 (each resource type independently
scored MostAllocated or LeastAllocated with its own weight).
Arguments:
  resourceStrategyFitWeight: 10
  resources:
    nvidia.com/gpu: {type: MostAllocated, weight: 2}
    cpu:            {type: LeastAllocated, weight: 1}

Scarce-resource avoidance (sra.go:94-142): nodes carrying configured
scarce resources score LOWER, steering pods that don't need them away
— on GPU clusters, keeps CPU-only pods off GPU hosts so whole NVLink
domains stay free for gangs.  Arguments:
  sra.weight: 5
  sra.resources: "nvidia.com/gpu"
  sra.resources.nvidia.com/gpu: 1       # per-resource weight
"""

from __future__ import annotations

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE, GPU
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

MAX_SCORE = 100.0

# GPU default: pack GPUs (keep whole hosts free); spread cpu.
DEFAULT_STRATEGY = {
    GPU: {"type": "MostAllocated", "weight": 2},
    "cpu": {"type": "LeastAllocated", "weight": 1},
}


@register_plugin("resource-strategy-fit")
class ResourceStrategyFitPlugin(Plugin):
    name = "resource-strategy-fit"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.weight = float(self.arguments.get("resourceStrategyFitWeight", 1))
        self.strategies = dict(DEFAULT_STRATEGY)
        for dim, spec in dict(self.arguments.get("resources", {})).items():
            self.strategies[dim] = {
                "type": spec.get("type", "LeastAllocated"),
                "weight": float(spec.get("weight", 1)),
            }
        # scarce-resource avoidance (reference sra.go calculateSraWeight)
        self.sra_weight = float(self.arguments.get("sra.weight", 0))
        self.sra_resources = {}
        for dim in str(self.arguments.get("sra.resources", "")).split(","):
            dim = dim.strip()
            if dim:
                w = float(self.arguments.get(f"sra.resources.{dim}", 1))
                self.sra_resources[dim] = w if w >= 0 else 1.0

    def on_session_open(self, ssn):
        ssn.add_node_order_fn(self.name, self._score)

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        return self._fit_score(task, node) + self._sra_score(task, node)

    def _sra_score(self, task: TaskInfo, node: NodeInfo) -> float:
        """1 - (present scarce-resource weight / total weight), scaled
        (reference sra.go:94-142 sraScore/resourceSraScore)."""
        if not self.sra_weight or not self.sra_resources:
            return 0.0
        weight_sum = sum(self.sra_resources.values())
        if weight_sum <= 0:
            return 0.0
        present = sum(
            w for dim, w in self.sra_resources.items()
            if node.allocatable.get(dim) > MIN_RESOURCE)
        return self.sra_weight * MAX_SCORE * (1.0 - present / weight_sum)

    def _fit_score(self, task: TaskInfo, node: NodeInfo) -> float:
        total, weights = 0.0, 0.0
        for dim, req in task.resreq.res.items():
            strategy = self.strategies.get(dim)
            if strategy is None or req < MIN_RESOURCE:
                continue
            alloc = node.allocatable.get(dim)
            if alloc < MIN_RESOURCE:
                continue
            frac = min(1.0, (node.used.get(dim) + req) / alloc)
            w = strategy["weight"]
            if strategy["type"] == "MostAllocated":
                total += w * frac
            else:
                total += w * (1.0 - frac)
            weights += w
        if weights == 0:
            return 0.0
        return self.weight * MAX_SCORE * total / weights

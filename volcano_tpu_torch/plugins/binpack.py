"""Binpack plugin — prefer filling nodes to reduce fragmentation.

Reference parity: plugins/binpack/binpack.go:193.  On GPU clusters this
keeps partial hosts packed so whole hosts and NVLink domains stay free
for gang jobs — give the nvidia.com/gpu dimension a high weight in
arguments:
  binpack.weight: 10
  binpack.resources: "cpu, memory, nvidia.com/gpu"
  binpack.resources.nvidia.com/gpu: 20
"""

from __future__ import annotations

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import CPU, MEMORY, MIN_RESOURCE, GPU
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

MAX_SCORE = 100.0


@register_plugin("binpack")
class BinpackPlugin(Plugin):
    name = "binpack"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.weight = float(self.arguments.get("binpack.weight", 1))
        self.dim_weights = {CPU: 1.0, MEMORY: 1.0, GPU: 5.0}
        # reference key aliases (binpack.go:40,42)
        if "binpack.cpu" in self.arguments:
            self.dim_weights[CPU] = float(self.arguments["binpack.cpu"])
        if "binpack.memory" in self.arguments:
            self.dim_weights[MEMORY] = float(self.arguments["binpack.memory"])
        for key, val in self.arguments.items():
            if key.startswith("binpack.resources."):
                self.dim_weights[key[len("binpack.resources."):]] = float(val)

    def on_session_open(self, ssn):
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_node_order_prepare_fn(self.name, self._prepare)

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        total, weight_sum = 0.0, 0.0
        for dim, req in task.resreq.res.items():
            alloc = node.allocatable.get(dim)
            if alloc < MIN_RESOURCE or req < MIN_RESOURCE:
                continue
            w = self.dim_weights.get(dim, 1.0)
            used = node.used.get(dim)
            total += w * ((used + req) / alloc)
            weight_sum += w
        if weight_sum == 0:
            return 0.0
        return self.weight * MAX_SCORE * total / weight_sum

    def _prepare(self, task: TaskInfo):
        """Batched _score (PreScore): the request rows and their
        weights are fixed per task (equivalence pinned in
        test_sweep.py)."""
        rows = [(dim, req, self.dim_weights.get(dim, 1.0))
                for dim, req in task.resreq.res.items()
                if req >= MIN_RESOURCE]
        factor = self.weight * MAX_SCORE

        def score(node: NodeInfo) -> float:
            total, weight_sum = 0.0, 0.0
            alloc_get = node.allocatable.res.get
            used_get = node.used.res.get
            for dim, req, w in rows:
                alloc = alloc_get(dim, 0.0)
                if alloc < MIN_RESOURCE:
                    continue
                total += w * ((used_get(dim, 0.0) + req) / alloc)
                weight_sum += w
            if weight_sum == 0:
                return 0.0
            return factor * total / weight_sum

        return score

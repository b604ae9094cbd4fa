"""Nodegroup plugin — queue -> nodegroup affinity.

Reference parity: plugins/nodegroup/nodegroup.go:293,338 (nodes carry
the nodegroup label; queues declare affinity/anti-affinity to groups
via annotations).  Queue annotations:
  nodegroup.volcano-tpu.io/affinity:      "g1,g2" (required)
  nodegroup.volcano-tpu.io/anti-affinity: "g3"    (forbidden)
"""

from __future__ import annotations

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.types import NODEGROUP_LABEL
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

AFFINITY_ANNOTATION = "nodegroup.volcano-tpu.io/affinity"
ANTI_AFFINITY_ANNOTATION = "nodegroup.volcano-tpu.io/anti-affinity"
MAX_SCORE = 100.0


@register_plugin("nodegroup")
class NodeGroupPlugin(Plugin):
    name = "nodegroup"

    def on_session_open(self, ssn):
        self.ssn = ssn
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)

    def _queue_rules(self, task: TaskInfo):
        job = self.ssn.jobs.get(task.job)
        queue = self.ssn.queues.get(job.queue) if job else None
        if queue is None:
            return None, None
        ann = queue.queue.annotations
        affinity = {g.strip() for g in
                    ann.get(AFFINITY_ANNOTATION, "").split(",") if g.strip()}
        anti = {g.strip() for g in
                ann.get(ANTI_AFFINITY_ANNOTATION, "").split(",") if g.strip()}
        return (affinity or None), (anti or None)

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        affinity, anti = self._queue_rules(task)
        group = node.labels.get(NODEGROUP_LABEL, "")
        if anti and group in anti:
            return unschedulable(
                f"node group {group!r} is anti-affine to queue",
                "nodegroup", resolvable=False)
        if affinity and group not in affinity:
            return unschedulable(
                f"node group {group!r} not in queue affinity {sorted(affinity)}",
                "nodegroup", resolvable=False)
        return None

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        affinity, _ = self._queue_rules(task)
        if not affinity:
            return 0.0
        return MAX_SCORE if node.labels.get(NODEGROUP_LABEL, "") in affinity \
            else 0.0

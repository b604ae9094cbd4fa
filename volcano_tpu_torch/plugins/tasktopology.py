"""Task-topology plugin — affinity buckets within one job.

Reference parity: plugins/task-topology/topology.go:345-349 (job
annotations declare task-pair affinity/anti-affinity; tasks are
bucketed and buckets steer task order + node scoring so co-located
pairs land together).  Job (podgroup) annotations:
  task-topology.volcano-tpu.io/affinity:      "ps/worker;a/b"
  task-topology.volcano-tpu.io/anti-affinity: "worker/worker"
"""

from __future__ import annotations

from typing import List, Set, Tuple

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

AFFINITY_ANNOTATION = "task-topology.volcano-tpu.io/affinity"
ANTI_AFFINITY_ANNOTATION = "task-topology.volcano-tpu.io/anti-affinity"
MAX_SCORE = 100.0


def _parse_pairs(raw: str) -> List[Tuple[str, str]]:
    pairs = []
    for part in raw.split(";"):
        if "/" in part:
            a, b = part.split("/", 1)
            if a.strip() and b.strip():
                pairs.append((a.strip(), b.strip()))
    return pairs


@register_plugin("task-topology")
class TaskTopologyPlugin(Plugin):
    name = "task-topology"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        # reference conf key "task-topology.weight" (topology.go)
        self.weight = float(self.arguments.get("task-topology.weight", 1))

    def on_session_open(self, ssn):
        self.ssn = ssn
        ssn.add_task_order_fn(self.name, self._task_order)
        ssn.add_node_order_fn(self.name, self._score)

    def _rules(self, job: JobInfo):
        if job.podgroup is None:
            return [], []
        ann = job.podgroup.annotations
        return (_parse_pairs(ann.get(AFFINITY_ANNOTATION, "")),
                _parse_pairs(ann.get(ANTI_AFFINITY_ANNOTATION, "")))

    def _task_order(self, a: TaskInfo, b: TaskInfo) -> int:
        """Keep tasks of the same spec adjacent so the node scorer sees
        affine partners placed first."""
        if a.job == b.job and a.task_spec != b.task_spec:
            return -1 if a.task_spec < b.task_spec else 1
        return 0

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        job = self.ssn.jobs.get(task.job)
        if job is None:
            return 0.0
        affinity, anti = self._rules(job)
        if not affinity and not anti:
            return 0.0
        specs_on_node: Set[str] = {
            t.task_spec for t in node.tasks.values()
            if t.job == task.job and t.occupies_resources()}
        score = 0.0
        for a, b in affinity:
            partner = b if task.task_spec == a else (
                a if task.task_spec == b else None)
            if partner and partner in specs_on_node:
                score += MAX_SCORE
        for a, b in anti:
            partner = b if task.task_spec == a else (
                a if task.task_spec == b else None)
            if partner is None:
                continue
            if partner == task.task_spec:
                if task.task_spec in specs_on_node:
                    score -= MAX_SCORE
            elif partner in specs_on_node:
                score -= MAX_SCORE
        return self.weight * score

"""NodeInfo — per-node scheduling state.

Reference parity: pkg/scheduler/api/node_info.go:52-101 (Idle / Used /
Releasing / Pipelined accounting, FutureIdle, oversubscription, task
add/remove/status transitions, taints).  GPU addition: each node
carries its NVLink domain membership, the domain's shape and its host
index so the device layer can do domain math without re-parsing
labels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, TYPE_CHECKING

from volcano_tpu_torch.api.pod import Taint
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import (
    GPU_CLIQUE_LABEL,
    GPU_DOMAIN_SHAPE_LABEL,
    GPU_HOST_INDEX_LABEL,
    TaskStatus,
)

if TYPE_CHECKING:
    from volcano_tpu_torch.api.job_info import TaskInfo  # noqa: F401


@dataclass
class Node:
    """Cluster node object (corev1.Node analogue)."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    allocatable: Dict[str, object] = field(default_factory=dict)
    capacity: Dict[str, object] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False
    images: List[str] = field(default_factory=list)
    # ^ container images present in the node's local cache
    #   (corev1.NodeStatus.Images analogue; scored by nodeorder's
    #   imagelocality.weight scorer)


class NodeInfo:
    """Scheduler-side view of one node with resource accounting.

    Invariant maintained across task transitions:
      allocatable == idle + used            (used includes releasing)
      futureIdle() == idle + releasing - pipelined
    """

    def __init__(self, node: Optional[Node] = None, name: str = ""):
        self.node: Optional[Node] = node
        self.name: str = node.name if node else name
        if node is not None:
            # memoize the quantity parse on the node object (replaced
            # wholesale by watch events, so staleness is impossible);
            # re-parsing every snapshot dominated 5k-host cycle cost
            parsed = node.__dict__.get("_parsed_res")
            if parsed is None:
                parsed = (Resource.from_resource_list(node.allocatable),
                          Resource.from_resource_list(
                              node.capacity or node.allocatable))
                node._parsed_res = parsed
            self.allocatable = parsed[0].clone()
            self.capability = parsed[1].clone()
        else:
            self.allocatable = Resource()
            self.capability = Resource()
        self.idle = self.allocatable.clone()
        # reclaimable slack the node agent measured from real usage —
        # usable ONLY by best-effort-QoS tasks (reference
        # node_info.go:83-89 OversubscriptionResource)
        self.oversubscription = Resource()
        if node is not None:
            from volcano_tpu_torch.api.types import (
                OVERSUBSCRIPTION_CPU_ANNOTATION,
            )
            raw = node.annotations.get(OVERSUBSCRIPTION_CPU_ANNOTATION)
            if raw:
                try:
                    extra = float(raw)
                    if extra > 0:
                        self.oversubscription = Resource({"cpu": extra})
                except ValueError:
                    pass
        self.used = Resource()
        self.releasing = Resource()
        self.pipelined = Resource()
        self.tasks: Dict[str, "TaskInfo"] = {}
        # host-port multiset (port -> holder count) maintained by
        # add/remove_task so the ports predicate is O(task ports), not
        # O(tasks on node) per check
        self.occupied_ports: Dict[int, int] = {}
        # Conflict-aware binder optimistic-concurrency token
        # (reference api/node_info.go:100 BindGeneration).
        self.bind_generation: int = 0
        self.others: Dict[str, object] = {}   # device registry payloads

    # -- GPU identity --------------------------------------------------

    @property
    def labels(self) -> Dict[str, str]:
        return self.node.labels if self.node else {}

    @property
    def nvlink_domain(self) -> str:
        return self.labels.get(GPU_CLIQUE_LABEL, "")

    @property
    def domain_shape(self) -> str:
        return self.labels.get(GPU_DOMAIN_SHAPE_LABEL, "")

    @property
    def host_index(self) -> int:
        try:
            return int(self.labels.get(GPU_HOST_INDEX_LABEL, "-1"))
        except ValueError:
            return -1

    # -- state --------------------------------------------------------

    @property
    def ready(self) -> bool:
        return bool(self.node and self.node.ready and not self.node.unschedulable)

    @property
    def taints(self) -> List[Taint]:
        return self.node.taints if self.node else []

    def future_idle(self) -> Resource:
        """Resources available after in-flight releases complete, minus
        resources already promised to pipelined tasks."""
        return (self.idle.clone().add(self.releasing)
                .sub_unchecked(self.pipelined))

    def oversub_remaining(self) -> Resource:
        """Unconsumed oversubscription slack: the published slack minus
        whatever BE work has already overdrafted past allocatable."""
        overdraft, _ = self.used.diff(self.allocatable)
        return self.oversubscription.clone().sub_unchecked(overdraft)

    # -- task accounting ----------------------------------------------

    def add_task(self, task: "TaskInfo"):
        """Account *task* onto this node.

        The node stores a CLONE of the task so later job-side status
        mutations cannot desync node accounting (reference node_info.go
        AddTask "Node will hold a copy of task").  Scheduler-initiated
        placements (ALLOCATED/BINDING) must fit exactly and raise on
        overflow; replayed pods (RUNNING/BOUND observed from the
        cluster) clamp instead so cache rebuild survives a node whose
        allocatable shrank under existing pods.
        """
        if task.uid in self.tasks:
            raise KeyError(f"task {task.key} already on node {self.name}")
        req = task.resreq
        if task.status is TaskStatus.RELEASING:
            self.releasing.add(req)
            self.idle.sub_unchecked(req)
            self.used.add(req)
        elif task.status is TaskStatus.PIPELINED:
            self.pipelined.add(req)
        elif task.occupies_resources():
            from volcano_tpu_torch.api.types import (
                QOS_BEST_EFFORT, QOS_LEVEL_ANNOTATION,
            )
            budget = self.idle
            if task.pod.annotations.get(QOS_LEVEL_ANNOTATION) == \
                    QOS_BEST_EFFORT:
                # only BE tasks may overdraft into measured slack
                budget = self.idle.clone().add(self.oversub_remaining())
            if task.status in (TaskStatus.ALLOCATED, TaskStatus.BINDING) \
                    and not req.less_equal(budget):
                raise ValueError(
                    f"node {self.name} has insufficient idle "
                    f"{self.idle} for task {task.key} requiring {req}")
            self.idle.sub_unchecked(req)
            self.used.add(req)
        task.node_name = self.name
        self.tasks[task.uid] = task.clone()
        for c in task.pod.containers:
            for port in c.ports:
                self.occupied_ports[port] = \
                    self.occupied_ports.get(port, 0) + 1

    def remove_task(self, task: "TaskInfo"):
        existing = self.tasks.pop(task.uid, None)
        if existing is None:
            return
        for c in existing.pod.containers:
            for port in c.ports:
                left = self.occupied_ports.get(port, 0) - 1
                if left > 0:
                    self.occupied_ports[port] = left
                else:
                    self.occupied_ports.pop(port, None)
        req = existing.resreq
        if existing.status is TaskStatus.RELEASING:
            self.releasing.sub_unchecked(req)
            self.idle.add(req)
            self.used.sub_unchecked(req)
        elif existing.status is TaskStatus.PIPELINED:
            self.pipelined.sub_unchecked(req)
        elif existing.occupies_resources():
            self.idle.add(req)
            self.used.sub_unchecked(req)

    def update_task_status(self, task: "TaskInfo", status: TaskStatus):
        """Remove+re-add under the new status to keep accounting exact.

        Dispatches the removal on the node's OWN copy of the task (whose
        status may lag the caller's), then re-adds under *status*.
        """
        self.remove_task(task)
        task.status = status
        self.add_task(task)

    def clone(self) -> "NodeInfo":
        c = NodeInfo.__new__(NodeInfo)
        c.node = self.node
        c.name = self.name
        c.allocatable = self.allocatable.clone()
        c.capability = self.capability.clone()
        c.idle = self.idle.clone()
        c.used = self.used.clone()
        c.releasing = self.releasing.clone()
        c.pipelined = self.pipelined.clone()
        c.oversubscription = self.oversubscription.clone()
        c.tasks = dict(self.tasks)
        c.occupied_ports = dict(self.occupied_ports)
        c.bind_generation = self.bind_generation
        c.others = dict(self.others)
        return c

    def __repr__(self):
        return (f"NodeInfo({self.name}, idle={self.idle}, used={self.used}, "
                f"tasks={len(self.tasks)})")

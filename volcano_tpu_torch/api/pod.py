"""Minimal pod model.

The framework is a standalone control plane; this Pod type is the unit of
work the scheduler binds and the job controller materializes.  It carries
exactly the fields the scheduling stack consumes (reference: corev1.Pod
as used by pkg/scheduler/api/pod_info.go and job controller pod
templates) — requests, placement constraints, lifecycle phase.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import TaskStatus

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}-{uuid.uuid4().hex[:8]}"


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"      # Equal | Exists
    value: str = ""
    effect: str = ""             # NoSchedule | PreferNoSchedule | NoExecute | ""

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    command: Optional[List[str]] = None
    requests: Dict[str, object] = field(default_factory=dict)
    limits: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    """One inter-pod (anti-)affinity term (k8s PodAffinityTerm
    analogue, reference predicates.go:212-388 wrapping the upstream
    interpodaffinity plugin).

    selector: label -> allowed values (AND across keys, OR within a
    key's list — same shape as Pod.affinity_node_terms).  A node
    satisfies the term when a matching assigned pod exists in the same
    topology domain (nodes sharing the node-label `topology_key`).
    namespaces: where matching pods are searched; empty = the incoming
    pod's own namespace.  weight: only meaningful for preferred terms.
    """

    selector: Dict[str, List[str]] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)
    weight: int = 1

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) in vals
                   for k, vals in self.selector.items())


@dataclass
class PreferredNodeTerm:
    """One preferredDuringScheduling node-affinity term (k8s
    PreferredSchedulingTerm analogue; scored by nodeorder's
    nodeaffinity.weight scorer, reference nodeorder.go:51-52).

    term: label -> allowed values, same shape as one entry of
    Pod.affinity_node_terms.  weight: added to the node's score when
    the term matches.
    """

    weight: int = 1
    term: Dict[str, List[str]] = field(default_factory=dict)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) in vals for k, vals in self.term.items())


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)

    node_name: str = ""                      # binding target once bound
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity_node_terms: Optional[List[Dict[str, List[str]]]] = None
    # ^ simplified nodeAffinity: OR over terms; each term is a map of
    #   label -> allowed values (AND within a term).
    preferred_node_affinity: List[PreferredNodeTerm] = \
        field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    # inter-pod affinity (plugins/interpodaffinity.py)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = field(default_factory=list)
    preferred_pod_affinity: List[PodAffinityTerm] = \
        field(default_factory=list)
    preferred_pod_anti_affinity: List[PodAffinityTerm] = \
        field(default_factory=list)
    priority: int = 0
    priority_class: str = ""
    scheduler_name: str = "volcano-tpu"
    scheduling_gates: List[str] = field(default_factory=list)
    preemptable: bool = True

    phase: TaskStatus = TaskStatus.PENDING
    exit_code: Optional[int] = None   # main container exit, when terminated
    status_message: str = ""
    nominated_node: str = ""
    owner: str = ""                          # vcjob uid that owns this pod
    task_spec: str = ""                      # task (replica-group) name
    task_index: int = 0

    def resource_requests(self) -> Resource:
        """Aggregate container requests; init containers take per-dim max
        (k8s effective-request semantics).

        The parse is memoized per pod object (requests are immutable
        after creation; watch events replace the whole instance): at
        5k-host scale the per-snapshot quantity re-parsing dominated
        snapshot cost.  A clone is returned so callers can mutate."""
        cached = self.__dict__.get("_resreq_cache")
        if cached is None:
            cached = Resource()
            for c in self.containers:
                cached.add(Resource.from_resource_list(c.requests))
            for c in self.init_containers:
                cached.set_max(Resource.from_resource_list(c.requests))
            self._resreq_cache = cached
        return cached.clone()

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_best_effort(self) -> bool:
        return self.resource_requests().is_empty()

    def is_terminated(self) -> bool:
        return self.phase in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)

    def clone(self) -> "Pod":
        import copy
        return copy.deepcopy(self)


def make_pod(name: str, namespace: str = "default",
             requests: Optional[Dict[str, object]] = None,
             labels: Optional[Dict[str, str]] = None,
             annotations: Optional[Dict[str, str]] = None,
             node_name: str = "",
             phase: TaskStatus = TaskStatus.PENDING,
             priority: int = 0,
             **kwargs) -> Pod:
    """Test/controller helper to build a single-container pod."""
    return Pod(
        name=name, namespace=namespace,
        labels=dict(labels or {}), annotations=dict(annotations or {}),
        containers=[Container(requests=dict(requests or {}))],
        node_name=node_name, phase=phase, priority=priority, **kwargs,
    )

"""Cluster backend interface.

The scheduler talks to the cluster only through this interface
(reference: the k8s clientset + informers behind pkg/scheduler/cache).
Implementations: FakeCluster (tests/benchmarks — the KWOK analogue);
a real deployment would back this with an apiserver client.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.api.hypernode import HyperNode
from volcano_tpu_torch.api.node_info import Node
from volcano_tpu_torch.api.pod import Pod
from volcano_tpu_torch.api.podgroup import PodGroup
from volcano_tpu_torch.api.queue import Queue


@dataclass
class PriorityClass:
    name: str
    value: int = 0
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"


@dataclass
class ClusterSnapshot:
    """Raw cluster objects as of one point in time."""

    pods: List[Pod] = field(default_factory=list)
    nodes: List[Node] = field(default_factory=list)
    podgroups: List[PodGroup] = field(default_factory=list)
    queues: List[Queue] = field(default_factory=list)
    hypernodes: List[HyperNode] = field(default_factory=list)
    priority_classes: List[PriorityClass] = field(default_factory=list)
    vcjobs: List[object] = field(default_factory=list)  # VCJob


class Cluster(abc.ABC):
    """The apiserver surface the scheduler AND controllers need.

    Implementations must also expose live mapping views used by
    controllers and plugins:
      pods / podgroups / queues / hypernodes / vcjobs  (key -> object)
      services / config_maps / secrets                 (plugin artifacts)
    """

    @abc.abstractmethod
    def list_all(self) -> ClusterSnapshot:
        """Return the current cluster objects (read-only view)."""

    @abc.abstractmethod
    def bind_pod(self, namespace: str, name: str, node_name: str,
                 ts_alloc: Optional[float] = None) -> None:
        """POST pods/binding analogue.  Raises on conflict/missing.
        ts_alloc optionally carries the scheduler's placement-decision
        wall time for the `allocated` lifecycle stamp (trace.py)."""

    def bind_pods(self, binds) -> List[Optional[str]]:
        """Batch bind: `binds` is [(namespace, name, node_name), ...]
        — items may carry a 4th element, the ts_alloc decision stamp;
        returns a per-item list of None (bound) or an error string,
        NEVER raising — per-item failure semantics match the per-pod
        path (a conflict on one pod must not veto its gang-mates, the
        discipline flush_binds already had).  The default loops
        bind_pod; wire backends override with ONE request so a 256-pod
        gang's binds don't cost 256 HTTP round-trips."""
        errors: List[Optional[str]] = []
        for item in binds:
            namespace, name, node_name = item[0], item[1], item[2]
            ts_alloc = item[3] if len(item) > 3 else None
            try:
                self.bind_pod(namespace, name, node_name,
                              ts_alloc=ts_alloc)
                errors.append(None)
            except Exception as e:  # noqa: BLE001 — per-item verdicts
                errors.append(str(e) or type(e).__name__)
        return errors

    @abc.abstractmethod
    def evict_pod(self, namespace: str, name: str, reason: str = "") -> None:
        """Graceful eviction: mark pod terminating; the 'kubelet' side
        completes deletion asynchronously (FakeCluster does it on tick)."""

    @abc.abstractmethod
    def nominate_pod(self, namespace: str, name: str, node_name: str) -> None:
        """Persist status.nominatedNodeName for a pipelined pod."""

    @abc.abstractmethod
    def update_podgroup_status(self, pg: PodGroup) -> None:
        """Flush PodGroup phase/conditions."""

    @abc.abstractmethod
    def record_event(self, obj_key: str, reason: str, message: str) -> None:
        """Event recorder analogue."""

    # -- controller surface -------------------------------------------

    @abc.abstractmethod
    def watch(self, fn) -> None:
        """Register fn(kind, obj) for object change notifications."""

    @abc.abstractmethod
    def unwatch(self, fn) -> None:
        """Detach a watcher registered with watch()."""

    @abc.abstractmethod
    def add_hypernode(self, hn: HyperNode) -> None:
        """Create/update a HyperNode CR (discovery controller)."""

    @abc.abstractmethod
    def delete_hypernode(self, name: str) -> None:
        """Delete a HyperNode CR."""

    @abc.abstractmethod
    def add_pod(self, pod: Pod) -> None:
        """Create a pod (job controller materialization)."""

    @abc.abstractmethod
    def delete_pod(self, key: str) -> None:
        """Force-delete a pod by ns/name key."""

    @abc.abstractmethod
    def add_podgroup(self, pg: PodGroup) -> None:
        """Create a PodGroup CR."""

    @abc.abstractmethod
    def delete_podgroup(self, key: str) -> None:
        """Delete a PodGroup CR."""

    @abc.abstractmethod
    def add_vcjob(self, job):
        """Create a vcjob, applying the admission chain; returns the
        (possibly mutated) stored object or raises AdmissionError."""

    @abc.abstractmethod
    def update_vcjob(self, job) -> None:
        """Persist vcjob spec/status changes."""

    @abc.abstractmethod
    def delete_vcjob(self, key: str) -> None:
        """Delete a vcjob by ns/name key."""

    # -- generic object store ------------------------------------------
    # One create/update + delete pair covering every registered kind
    # (cache/kinds.py) so controllers and plugins persist through the
    # SAME seam regardless of backend (in-memory or wire).  Mirrors the
    # reference's dynamic clientset over the CRD scheme.

    @abc.abstractmethod
    def put_object(self, kind: str, obj, key: Optional[str] = None):
        """Create or update an object of `kind`; returns the stored
        object (admission may mutate for admission-gated kinds)."""

    @abc.abstractmethod
    def delete_object(self, kind: str, key: str) -> None:
        """Delete by key; no-op when absent."""

    def get_objects(self, kind: str) -> Dict[str, object]:
        """Read view of a kind's store (key -> object)."""
        from volcano_tpu_torch.cache.kinds import KINDS
        return getattr(self, KINDS[kind].attr)

    # -- command bus (bus/v1alpha1 Command analogue) -------------------
    # Default in-memory implementation; backends may override to
    # persist Commands as CRs.

    def add_command(self, target_key: str, action: str) -> None:
        if not hasattr(self, "commands"):
            self.commands = []
        self.commands.append({"target": target_key, "action": action})

    def drain_commands(self, target_key: str):
        cmds = getattr(self, "commands", [])
        mine = [c for c in cmds if c["target"] == target_key]
        self.commands = [c for c in cmds if c["target"] != target_key]
        return mine

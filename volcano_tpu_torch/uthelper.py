"""Declarative scheduler test harness.

Reference parity: pkg/scheduler/uthelper/helper.go (TestCommonStruct):
declare pods/nodes/podgroups/queues/hypernodes/priority-classes and the
plugin tiers under test, run actions against a fake cluster, then
assert expected binds/evictions/pipelines.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from volcano_tpu_torch.api.hypernode import HyperNode
from volcano_tpu_torch.api.node_info import Node
from volcano_tpu_torch.api.pod import Pod, make_pod
from volcano_tpu_torch.api.podgroup import PodGroup
from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.api.types import (
    GROUP_NAME_ANNOTATION,
    PodGroupPhase,
    TaskStatus,
)
from volcano_tpu_torch.cache.cache import SchedulerCache
from volcano_tpu_torch.cache.cluster import PriorityClass
from volcano_tpu_torch.cache.fake_cluster import FakeCluster
from volcano_tpu_torch.conf import load_conf
from volcano_tpu_torch.framework.framework import close_session, open_session
from volcano_tpu_torch.framework.plugins import get_action


class TestContext:
    """Build a fake cluster + scheduler and run actions over it."""

    __test__ = False  # not a pytest collection target

    def __init__(self,
                 nodes: Sequence[Node] = (),
                 pods: Sequence[Pod] = (),
                 podgroups: Sequence[PodGroup] = (),
                 queues: Sequence[Queue] = (),
                 hypernodes: Sequence[HyperNode] = (),
                 priority_classes: Sequence[PriorityClass] = (),
                 conf=None,
                 actions: str = "enqueue, allocate, backfill",
                 cluster: Optional[FakeCluster] = None):
        # a prebuilt cluster (e.g. simulator.make_gpu_cluster) may be
        # passed directly; declared objects are added on top of it
        self.cluster = cluster if cluster is not None else FakeCluster()
        for n in nodes:
            self.cluster.add_node(n)
        for q in queues:
            self.cluster.add_queue(q)
        for pg in podgroups:
            self.cluster.add_podgroup(pg)
        for p in pods:
            self.cluster.add_pod(p)
        for hn in hypernodes:
            self.cluster.add_hypernode(hn)
        for pc in priority_classes:
            self.cluster.add_priority_class(pc)

        if conf is None:
            conf = {"actions": actions,
                    "tiers": [
                        {"plugins": [{"name": "priority"}, {"name": "gang"},
                                     {"name": "conformance"}]},
                        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                                     {"name": "predicates"},
                                     {"name": "proportion"},
                                     {"name": "nodeorder"},
                                     {"name": "binpack"}]},
                    ]}
        self.conf = load_conf(conf)
        self.cache = SchedulerCache(self.cluster)
        self.last_session = None

    def run(self, actions: Optional[List[str]] = None):
        """One scheduling cycle; returns the (closed) session."""
        ssn = open_session(self.cache, self.conf)
        try:
            for name in actions or self.conf.actions:
                action = get_action(name)
                assert action is not None, f"unknown action {name}"
                action.execute(ssn)
        finally:
            close_session(ssn)
        self.last_session = ssn
        return ssn

    # -- assertion helpers --------------------------------------------

    @property
    def bind_map(self) -> Dict[str, str]:
        return {key: node for key, node in self.cluster.binds}

    def expect_bind_num(self, n: int):
        assert len(self.cluster.binds) == n, \
            f"expected {n} binds, got {self.cluster.binds}"

    def expect_bind(self, pod_key: str, node_name: Optional[str] = None):
        bm = self.bind_map
        assert pod_key in bm, f"{pod_key} not bound (binds={bm})"
        if node_name is not None:
            assert bm[pod_key] == node_name, \
                f"{pod_key} bound to {bm[pod_key]}, expected {node_name}"

    def expect_evict_num(self, n: int):
        assert len(self.cluster.evictions) == n, \
            f"expected {n} evictions, got {self.cluster.evictions}"

    def expect_podgroup_phase(self, key: str, phase: PodGroupPhase):
        pg = self.cluster.podgroups[key]
        assert pg.phase is phase, \
            f"podgroup {key} phase {pg.phase}, expected {phase}"


def gang_job(name: str, namespace: str = "default", queue: str = "default",
             replicas: int = 3, min_available: Optional[int] = None,
             requests: Optional[dict] = None, pg_phase=PodGroupPhase.PENDING,
             priority_class: str = "", network_topology=None,
             sub_group_policies=(), labels_per_pod=None,
             running_on: Optional[List[str]] = None):
    """Build (podgroup, [pods]) for a gang job — test convenience.

    running_on: node names; if given, pods are materialized as Running
    on those nodes (wrap-around), simulating an already-placed job.
    """
    pg = PodGroup(name=name, namespace=namespace, queue=queue,
                  min_member=min_available if min_available is not None
                  else replicas,
                  priority_class=priority_class,
                  network_topology=network_topology,
                  sub_group_policies=list(sub_group_policies))
    pg.phase = pg_phase
    pods = []
    for i in range(replicas):
        pod = make_pod(
            f"{name}-{i}", namespace=namespace,
            requests=dict(requests or {"cpu": 1}),
            annotations={GROUP_NAME_ANNOTATION: name},
            labels=dict((labels_per_pod or (lambda _i: {}))(i)) if callable(labels_per_pod)
            else dict(labels_per_pod or {}),
        )
        pod.task_spec = "worker"
        pod.task_index = i
        if running_on:
            pod.node_name = running_on[i % len(running_on)]
            pod.phase = TaskStatus.RUNNING
        pods.append(pod)
    return pg, pods

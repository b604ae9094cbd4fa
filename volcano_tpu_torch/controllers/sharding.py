"""Sharding controller — partition nodes between schedulers.

Reference parity: pkg/controllers/sharding/sharding_controller.go:55
(+ policies and node-utilization tracking).  Policies:
- label:   nodes labeled volcano-tpu.io/shard=agent go to the agent
           scheduler, everything else to batch.
- fraction: a fixed fraction of nodes outside any NVLink domain goes
           to the agent scheduler (NVLink-domain GPU hosts always stay
           with batch — gang machinery owns them).
"""

from __future__ import annotations

import logging
from typing import List

from volcano_tpu_torch.api.shard import (
    AGENT_SCHEDULER,
    BATCH_SCHEDULER,
    NodeShard,
)
from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

SHARD_LABEL = "volcano-tpu.io/shard"


@register_controller("sharding")
class ShardingController(Controller):
    name = "sharding"

    def __init__(self, policy: str = "label", agent_fraction: float = 0.25):
        self.policy = policy
        self.agent_fraction = agent_fraction

    def initialize(self, cluster):
        super().initialize(cluster)
        if not hasattr(cluster, "nodeshards"):
            cluster.nodeshards = {}

    def sync(self) -> None:
        snap = self.cluster.list_all()
        agent_nodes: List[str] = []
        batch_nodes: List[str] = []
        candidates = sorted(snap.nodes, key=lambda n: n.name)
        if self.policy == "label":
            for node in candidates:
                if node.labels.get(SHARD_LABEL) == "agent":
                    agent_nodes.append(node.name)
                else:
                    batch_nodes.append(node.name)
        else:  # fraction policy over non-GPU nodes
            non_gpu = [n for n in candidates
                       if not n.labels.get(GPU_CLIQUE_LABEL)]
            take = int(len(non_gpu) * self.agent_fraction)
            agent_set = {n.name for n in non_gpu[:take]}
            for node in candidates:
                (agent_nodes if node.name in agent_set
                 else batch_nodes).append(node.name)

        desired = {
            "batch": NodeShard(name="batch", scheduler=BATCH_SCHEDULER,
                               nodes=batch_nodes),
            "agent": NodeShard(name="agent", scheduler=AGENT_SCHEDULER,
                               nodes=agent_nodes),
        }
        # persist only real changes: shard churn invalidates both
        # schedulers' candidate orderings (and crosses the wire)
        current = getattr(self.cluster, "nodeshards", {}) or {}
        for name, shard in desired.items():
            old = current.get(name)
            if old is None or old.scheduler != shard.scheduler or \
                    list(old.nodes) != shard.nodes:
                self.cluster.put_object("nodeshard", shard)


def shard_nodes_for(cluster, scheduler_name: str) -> List[str]:
    """Node names assigned to *scheduler_name* (empty = no sharding)."""
    shards = getattr(cluster, "nodeshards", {}) or {}
    for shard in shards.values():
        if shard.scheduler == scheduler_name:
            return list(shard.nodes)
    return []

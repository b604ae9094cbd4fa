"""NodeShard CRD (shard/v1alpha1 analogue).

Reference parity: staging/.../shard/v1alpha1/types.go:32-54 — partitions
nodes between the batch scheduler and the agent (fast-path) scheduler.
Shard modes (pkg/util/util.go:41-43): none | soft | hard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from volcano_tpu_torch.api.pod import new_uid

BATCH_SCHEDULER = "volcano-tpu"
AGENT_SCHEDULER = "volcano-tpu-agent"

SHARD_MODE_NONE = "none"
SHARD_MODE_SOFT = "soft"    # prefer own shard, may spill
SHARD_MODE_HARD = "hard"    # own shard only


@dataclass
class NodeShard:
    name: str
    uid: str = field(default_factory=new_uid)
    scheduler: str = BATCH_SCHEDULER
    nodes: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return self.name

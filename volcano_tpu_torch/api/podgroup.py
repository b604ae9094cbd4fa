"""PodGroup CRD type (scheduling/v1beta1 analogue).

Reference parity: staging/.../scheduling/v1beta1/types.go:173-223
(PodGroupSpec incl. networkTopology + subGroupPolicy) and PodGroupStatus.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.api.pod import new_uid
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import (
    DEFAULT_QUEUE,
    NetworkTopologyMode,
    PodGroupPhase,
)


@dataclass
class NetworkTopologySpec:
    """Topology placement constraint for a (sub)group.

    mode=hard: all tasks must land within one hypernode domain at tier
    <= highest_tier_allowed.  mode=soft: prefer lower tiers, allow spill.
    On GPUs, tier 1 is one NVLink domain; tier 2+ crosses the
    InfiniBand fabric.  highest_tier_allowed=None means unbounded: the
    gradient search still prefers the lowest tier that fits, so the
    group stays NVLink-local when
    possible but never becomes unschedulable by spanning.
    """

    mode: NetworkTopologyMode = NetworkTopologyMode.HARD
    highest_tier_allowed: Optional[int] = 1


@dataclass
class SubGroupPolicy:
    """Secondary gang: named subgroup with its own minMember + topology
    (types.go:217-223).  Tasks opt in via the subgroup label."""

    name: str = ""
    min_member: int = 0
    network_topology: Optional[NetworkTopologySpec] = None


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""
    transition_id: str = ""


@dataclass
class PodGroup:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    # spec
    min_member: int = 1
    min_task_member: Dict[str, int] = field(default_factory=dict)
    min_resources: Optional[Resource] = None
    queue: str = DEFAULT_QUEUE
    priority_class: str = ""
    network_topology: Optional[NetworkTopologySpec] = None
    sub_group_policies: List[SubGroupPolicy] = field(default_factory=list)

    # status
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    creation_time: float = field(default_factory=time.time)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "PodGroup":
        import copy
        return copy.deepcopy(self)

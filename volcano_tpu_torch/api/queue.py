"""Queue CRD type (scheduling/v1beta1 Queue analogue).

Reference parity: staging/.../scheduling/v1beta1/types.go:459-519
(weight, capability, reclaimable, guarantee, deserved, priority, parent,
dequeue strategy) + Queue status state machine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from volcano_tpu_torch.api.pod import new_uid
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import QueueState

DEQUEUE_FIFO = "fifo"
DEQUEUE_TRAVERSE = "traverse"


@dataclass
class Queue:
    name: str
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    # spec
    weight: int = 1
    capability: Optional[Resource] = None      # hard cap (unset dim = unlimited)
    guarantee: Optional[Resource] = None       # floor reserved for this queue
    deserved: Optional[Resource] = None        # capacity-plugin deserved share
    reclaimable: bool = True
    priority: int = 0
    parent: str = ""                           # hierarchical queues
    # reference default is traverse (types.go:503,519): a blocked head
    # job does NOT starve the rest of the queue unless fifo is chosen
    dequeue_strategy: str = DEQUEUE_TRAVERSE

    # status
    state: QueueState = QueueState.OPEN
    creation_time: float = field(default_factory=time.time)

    @property
    def key(self) -> str:
        return self.name

    def is_open(self) -> bool:
        return self.state == QueueState.OPEN

    def clone(self) -> "Queue":
        import copy
        return copy.deepcopy(self)

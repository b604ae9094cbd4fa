"""QueueInfo — scheduler-side queue view.

Reference parity: pkg/scheduler/api/queue_info.go:36.
"""

from __future__ import annotations

from typing import Dict, Optional

from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import QueueState


class QueueInfo:
    def __init__(self, queue: Queue):
        self.queue = queue
        self.name = queue.name
        self.uid = queue.uid
        self.weight = max(1, queue.weight)
        self.reclaimable = queue.reclaimable
        self.priority = queue.priority
        self.parent = queue.parent

    @property
    def capability(self) -> Optional[Resource]:
        return self.queue.capability

    @property
    def guarantee(self) -> Resource:
        return self.queue.guarantee.clone() if self.queue.guarantee else Resource()

    @property
    def deserved_spec(self) -> Optional[Resource]:
        return self.queue.deserved

    def is_open(self) -> bool:
        return self.queue.state == QueueState.OPEN

    def is_leaf(self, all_queues: Dict[str, "QueueInfo"]) -> bool:
        return not any(q.parent == self.name for q in all_queues.values())

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    def __repr__(self):
        return f"QueueInfo({self.name}, weight={self.weight})"

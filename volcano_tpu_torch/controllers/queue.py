"""Queue controller — queue state machine + podgroup counts.

Reference parity: pkg/controllers/queue (Open/Closed/Closing/Unknown
state machine in queue/state; status counts of owned podgroups).
"""

from __future__ import annotations

import logging
from collections import defaultdict

from volcano_tpu_torch.api.types import PodGroupPhase, QueueState
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)


@register_controller("queue")
class QueueController(Controller):
    name = "queue"

    def sync(self) -> None:
        snap = self.cluster.list_all()
        groups_per_queue = defaultdict(list)
        for pg in snap.podgroups:
            groups_per_queue[pg.queue].append(pg)

        for queue in snap.queues:
            owned = groups_per_queue.get(queue.name, [])
            if queue.state is QueueState.CLOSING:
                # a closing queue flips Closed once no podgroups remain
                active = [pg for pg in owned
                          if pg.phase not in (PodGroupPhase.COMPLETED,)]
                if not active:
                    queue.state = QueueState.CLOSED
                    self.cluster.put_object("queue", queue)
                    log.info("queue %s closed", queue.name)
            elif queue.state is QueueState.UNKNOWN:
                queue.state = QueueState.OPEN
                self.cluster.put_object("queue", queue)

    def close_queue(self, name: str) -> None:
        queue = self.cluster.queues.get(name)
        if queue is None:
            return
        queue.state = QueueState.CLOSING
        self.cluster.put_object("queue", queue)
        self.sync()

    def open_queue(self, name: str) -> None:
        queue = self.cluster.queues.get(name)
        if queue is not None:
            queue.state = QueueState.OPEN
            self.cluster.put_object("queue", queue)

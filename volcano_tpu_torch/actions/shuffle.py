"""Shuffle action — evict running tasks chosen by VictimTasks plugins.

Reference parity: actions/shuffle/shuffle.go (rescheduling / tdm feed
victims; shuffle just executes the evictions).
"""

from __future__ import annotations

import logging

from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch import metrics

log = logging.getLogger(__name__)


class ShuffleAction(Action):
    name = "shuffle"

    def execute(self, ssn) -> None:
        victims = ssn.victim_tasks()
        if not victims:
            return
        stmt = ssn.statement()
        for task in victims:
            stmt.evict(task, "shuffled for rebalancing")
            metrics.inc("shuffle_victims_total")
        stmt.commit()


register_action(ShuffleAction())

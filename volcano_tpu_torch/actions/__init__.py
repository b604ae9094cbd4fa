"""Scheduling actions (reference: pkg/scheduler/actions/factory.go).

Importing this package registers every action the default conf names
(enqueue, allocate, elastic, backfill).  preempt, reclaim, gangpreempt
and shuffle are not ported yet: a conf naming them gets the
scheduler's handling of an unknown action (a warning, and the action
is skipped).
"""

import volcano_tpu_torch.actions.enqueue      # noqa: F401
import volcano_tpu_torch.actions.allocate     # noqa: F401
import volcano_tpu_torch.actions.backfill     # noqa: F401
import volcano_tpu_torch.actions.elastic      # noqa: F401

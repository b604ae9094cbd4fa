"""Scheduling actions (reference: pkg/scheduler/actions/factory.go).

Importing this package registers every action.
"""

import volcano_tpu_torch.actions.enqueue      # noqa: F401
import volcano_tpu_torch.actions.allocate     # noqa: F401
import volcano_tpu_torch.actions.backfill     # noqa: F401
import volcano_tpu_torch.actions.preempt      # noqa: F401
import volcano_tpu_torch.actions.reclaim      # noqa: F401
import volcano_tpu_torch.actions.gangpreempt  # noqa: F401
import volcano_tpu_torch.actions.shuffle      # noqa: F401
import volcano_tpu_torch.actions.elastic      # noqa: F401

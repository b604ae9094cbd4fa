"""Serving plugin — the scheduler's awareness of SLO pressure.

Two concerns (controllers/serving.py makes the scale decisions, the
elastic machinery executes them; this plugin keeps the SCHEDULING
cycle coherent with a serving scale-up in flight):

  topology anchor export   a serving gang whose scale-up is waiting
      for chips (pending tasks, gang not ready) publishes its pool —
      the slices its replicas occupied before the drain, stamped by
      the autoscaler as PG_POOL_SLICES — onto the session as
      `ssn.serving_anchor_slices`.  The elastic action's shrink reads
      it and ranks training victims by hypernode-LCA proximity to
      that pool instead of lowest-priority-anywhere, so the eviction
      frees an ICI-contiguous block NEXT TO the serving replicas
      (arxiv 2411.11560's headline placement property) rather than a
      random equally-sized hole across the DCN fabric.

  named wait               the same gang gets the bounded
      `serving-slo-pressure` pending reason (via the fit-error
      message the trace enum rules normalize), so `vtpctl explain`
      says WHY the group is pending — an SLO burst funding a
      preemption — instead of `other`.

Deliberately NOT here: victim selection itself (actions/elastic.py —
decisions stay in actions), and replica math (controllers/serving.py).
"""

from __future__ import annotations

from typing import Set

from volcano_tpu_torch.api import serving as sapi
from volcano_tpu_torch.api.fit_error import FitErrors
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin


@register_plugin("serving")
class ServingPlugin(Plugin):
    name = "serving"

    def on_session_open(self, ssn):
        self.ssn = ssn
        anchors: Set[str] = set()
        for job in ssn.jobs.values():
            pg = job.podgroup
            if pg is None or not sapi.is_serving(pg):
                continue
            pending = [t for t in
                       job.tasks_in_status(TaskStatus.PENDING)
                       if not t.best_effort]
            if not pending or ssn.job_ready(job):
                continue        # serving and healthy: nothing to flag
            anchors.update(sapi.pool_slices(pg))
            # name the wait with the bounded enum (specific rule in
            # trace._REASON_RULES maps the "serving:" prefix)
            errs = job.fit_errors.setdefault(pending[0].uid,
                                             FitErrors())
            if not errs.err:
                errs.set_error(
                    "serving: slo pressure — scale-up awaiting chips "
                    "near the replica pool")
        # empty set = no serving pressure (or none with a known pool):
        # the elastic action falls back to idle-domain affinity
        ssn.serving_anchor_slices = anchors

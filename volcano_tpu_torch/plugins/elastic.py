"""Elastic plugin — the scheduler's enforcement half of elastic gangs.

Three concerns (actions/elastic.py makes the decisions,
controllers/elastic.py executes them; this plugin keeps the OTHER
actions coherent with an in-flight resize):

  shrink-before-preempt   while any elastic shrink decision is in
      flight (a podgroup carries desired-slices < slices), capacity
      is already en route to the starving job — gangpreempt/
      gangreclaim must NOT also evict someone for it.  The plugin
      REJECTs jobStarving for every job that session, which empties
      the preemptors' starving list until the shrink has freed the
      slices (or the decision was cleared).  One cycle of patience
      replaces an eviction: the shrink victim keeps its progress via
      checkpoint-resume, the evicted victim would have lost its pods.

  migration steering      a gang being live-migrated carries
      avoid-slices (its OLD slices): this plugin filters those hosts
      for the gang's own tasks during re-placement so the migration
      actually moves — otherwise the freshly-drained slices are the
      emptiest targets and the gang would land right back.
      Resolvable for everyone else: other work may take the vacated
      slices immediately (that is the point of a defrag migration).

  resized-gang priority   a resizing gang rides the failover plugin's
      REQUEUED fast lane (the elastic controller stamps the same
      annotation the failover controller uses), so re-placement after
      a drain sorts first without a second priority mechanism.
"""

from __future__ import annotations

import time
from typing import Dict, Set

from volcano_tpu_torch.api import elastic as eapi
from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin


@register_plugin("elastic")
class ElasticPlugin(Plugin):
    name = "elastic"

    def on_session_open(self, ssn):
        self.ssn = ssn
        now = time.time()
        # job uid -> set of slice names its re-placement must avoid
        self._avoid: Dict[str, Set[str]] = {}
        # job uids whose avoid preference funds a serving scale-up
        self._serving_victims: Set[str] = set()
        shrink_in_flight = False
        for job in ssn.jobs.values():
            pg = job.podgroup
            if pg is None or not eapi.is_elastic(pg):
                continue
            desired = eapi.desired_slices(pg)
            # a STALE decision (no elastic controller consuming it)
            # must not hold the preemptors back forever — the veto
            # only stands while the shrink is actually live
            if desired is not None and \
                    desired < eapi.current_slices(pg) and \
                    not eapi.decision_stale(pg, now):
                shrink_in_flight = True
            # ...and while the controller is EXECUTING a shrink (the
            # durable resizing marker, cleared at resume), the freed
            # slices are seconds away — still no reason to evict
            if pg.annotations.get(
                    eapi.ELASTIC_RESIZING_ANNOTATION) == \
                    eapi.RESIZE_SHRINK:
                shrink_in_flight = True
            avoid = set(eapi.avoid_slices(pg))
            if avoid:
                self._avoid[job.uid] = avoid
                from volcano_tpu_torch.api import serving as sapi
                if pg.annotations.get(sapi.VICTIM_ANNOTATION):
                    self._serving_victims.add(job.uid)
        if shrink_in_flight:
            ssn.add_job_starving_fn(self.name, self._not_starving)
        if self._avoid:
            ssn.add_predicate_fn(self.name, self._predicate)

    @staticmethod
    def _not_starving(job: JobInfo) -> bool:
        # REJECT starves the gangpreempt/gangreclaim candidate lists
        # while shrink capacity is en route (one drain is cheaper than
        # one eviction; the decision clears if the shrink fails)
        return False

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        avoid = self._avoid.get(task.job)
        if not avoid or node.node is None:
            return None
        if node.node.labels.get(GPU_CLIQUE_LABEL) in avoid:
            msg = "slice vacated by elastic migration"
            if task.job in self._serving_victims:
                # distinguishable wait for `vtpctl explain`: this gang
                # shrank to fund a serving scale-up and is steered off
                # the NVLink-adjacent block it freed
                msg = "slice freed for serving scale-up"
            return unschedulable(msg, self.name)
        return None

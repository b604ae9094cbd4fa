"""Failover plugin — the scheduler's half of the slice-failover loop.
A slice is one NVLink domain (GPU_CLIQUE_LABEL).

Three concerns (controllers/failover.py owns declare/drain; this
plugin owns re-placement):

  quarantine filter   a host whose slice the failover controller
      quarantined (NODE_QUARANTINED_UNTIL annotation in the future)
      is infeasible for EVERY task — the requeued gang must not land
      back on the sick slice, and no new work should either.
      Unresolvable: preemption cannot cure a broken NVLink domain.

  requeued priority   gangs the controller drained off a failed slice
      (REQUEUED podgroup annotation) sort before everything else in
      the allocation order — recovery time is gang-idle time, so the
      requeued gang goes first.

  warm spares         `failover.warmSpares: N` reserves the N least-
      loaded fully-idle slices per topology shape for failover
      traffic: ordinary gangs are filtered off them, requeued gangs
      (and any work once nothing else fits — spares are a preference,
      not a brick wall: the filter is resolvable) may take them.
      Default 0 (off): spare capacity is rent, not a default.

Reference analogues: topology-aware preemptive scheduling for
co-located LLM workloads (arxiv 2411.11560) — recovery placement
respects the same topology constraints as initial placement.
"""

from __future__ import annotations

import time
from typing import Dict, List, Set

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE, GPU
from volcano_tpu_torch.api.types import (GPU_CLIQUE_LABEL,
                                         GPU_DOMAIN_SHAPE_LABEL)
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin


@register_plugin("failover")
class FailoverPlugin(Plugin):
    name = "failover"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.warm_spares = int(self.arguments.get(
            "failover.warmSpares", 0))
        self.now = time.time

    def on_session_open(self, ssn):
        self.ssn = ssn
        self._spares = self._pick_spares(ssn) if self.warm_spares \
            else set()
        ssn.add_job_order_fn(self.name, self._job_order)
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_predicate_prepare_fn(self.name, self._prepare)

    # -- requeued gangs first ------------------------------------------

    @staticmethod
    def _is_requeued(job: JobInfo) -> bool:
        from volcano_tpu_torch.api.slicehealth import REQUEUED_ANNOTATION
        return job.podgroup is not None and \
            job.podgroup.annotations.get(REQUEUED_ANNOTATION) == "true"

    def _job_order(self, a: JobInfo, b: JobInfo) -> int:
        ra, rb = self._is_requeued(a), self._is_requeued(b)
        if ra and not rb:
            return -1
        if rb and not ra:
            return 1
        return 0

    # -- quarantine filter + spare reservation -------------------------

    def _quarantined(self, node: NodeInfo) -> bool:
        from volcano_tpu_torch.api.slicehealth import (
            NODE_QUARANTINED_UNTIL_ANNOTATION)
        if node.node is None:
            return False
        try:
            until = float(node.node.annotations.get(
                NODE_QUARANTINED_UNTIL_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            return False
        return until > self.now()

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        if self._quarantined(node):
            # unresolvable: evicting pods cannot mend a sick slice
            return unschedulable(
                "node's slice is quarantined after failure",
                self.name, resolvable=False)
        if self._spares and node.name in self._spares:
            job = self.ssn.jobs.get(task.job)
            if job is None or not self._is_requeued(job):
                # resolvable: when nothing else fits, backfill/preempt
                # passes may still consider the spare rather than
                # leave work pending forever
                return unschedulable(
                    "node reserved as failover warm spare", self.name)
        return None

    def _prepare(self, task: TaskInfo):
        """Batched _predicate (PreFilter): the task's job + requeued
        flag are resolved once per sweep instead of per node; the
        quarantine annotation check stays per node, per call time
        (equivalence pinned in test_sweep.py)."""
        spares = self._spares
        spare_applies = False
        if spares:
            job = self.ssn.jobs.get(task.job)
            spare_applies = job is None or not self._is_requeued(job)

        def check(node: NodeInfo):
            if self._quarantined(node):
                return unschedulable(
                    "node's slice is quarantined after failure",
                    self.name, resolvable=False)
            if spare_applies and node.name in spares:
                return unschedulable(
                    "node reserved as failover warm spare", self.name)
            return None

        return check

    def _pick_spares(self, ssn) -> Set[str]:
        """The N least-loaded fully-idle slices per topology shape.
        Idle = no task on any host and no GPUs used — a spare must be
        whole, a partially-busy slice can't host a slice-sized gang
        anyway."""
        by_slice: Dict[str, List[NodeInfo]] = {}
        for n in ssn.nodes.values():
            sl = (n.node.labels.get(GPU_CLIQUE_LABEL)
                  if n.node is not None else None)
            if sl:
                by_slice.setdefault(sl, []).append(n)
        idle_by_shape: Dict[str, List[str]] = {}
        for sl, nodes in by_slice.items():
            if any(not n.ready or n.tasks
                   or n.used.get(GPU) > MIN_RESOURCE
                   or self._quarantined(n) for n in nodes):
                continue
            shape = nodes[0].node.labels.get(GPU_DOMAIN_SHAPE_LABEL, "?")
            idle_by_shape.setdefault(shape, []).append(sl)
        reserved: Set[str] = set()
        for shape, slices in idle_by_shape.items():
            for sl in sorted(slices)[:self.warm_spares]:
                reserved.update(n.name for n in by_slice[sl])
        return reserved

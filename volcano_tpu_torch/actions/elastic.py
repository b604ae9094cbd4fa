"""Elastic action — world size as a scheduler decision.

Runs AFTER allocate (fixed-size placement first; elasticity spends
what is left) and BEFORE gangpreempt/backfill (a shrink that frees a
slice must pre-empt the pre-emptor: evicting a gang loses its pods,
shrinking one loses nothing — it checkpoints and resumes smaller).
A slice is one NVLink domain (a tier-1 hypernode, GPU_CLIQUE_LABEL).

Per cycle, over the post-allocate state:

  grow     whole idle slices beyond what pending gangs need are handed
           to running elastic jobs below their max-slices, in job
           order.  A slice only counts when every host is ready,
           untainted by quarantine, and chip-idle — elastic growth
           must absorb stranded capacity, not race real placements.

  shrink   when pending gangs cannot fit idle capacity, running
           elastic jobs above min-slices shed slices to cover the
           deficit — victims picked TOPOLOGY-AWARE: prefer shedding
           slices in the domain (IB fabric) that already holds the most
           idle GPUs, so the freed block is contiguous with existing
           idle and a multi-slice pending gang lands in ONE domain.

  fit      a PENDING elastic job above its floor that cannot place at
           its current size is resized DOWN to what idle capacity can
           hold (spec-only — nothing to drain, it never started);
           pending at the floor with no capacity records the bounded
           `elastic-waiting-for-capacity` reason so `vtpctl explain`
           names the wait instead of `other`.

Decisions are annotation stamps on the podgroup (desired-slices +
resize-reason); controllers/elastic.py executes them via the
checkpoint-drain-resume path.  Flap damping: a job resized less than
`elastic.cooldownSeconds` ago (action configuration, default 30) is
not re-decided.

Reference analogues: Singularity transparent resize (arxiv
2202.07848); Pollux-style elastic goodput scheduling (arxiv
2008.12260).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import elastic as eapi
from volcano_tpu_torch.api.fit_error import FitErrors
from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus, GPU_CLIQUE_LABEL
from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.util import PriorityQueue

log = logging.getLogger(__name__)

DEFAULT_COOLDOWN_S = 30.0
# goodput grow gate (the minimal Pollux step): a further grow is
# declined when the LAST grow's measured speedup fell below
# 1 + frac * (linear - 1) — with 0.5, growing 1 -> 2 slices must have
# bought at least 1.5x measured steps/s before a third slice is
# granted.  A job the observatory has no data on is never blocked.
GROW_MARGINAL_FRACTION = 0.5


class SliceView:
    """One slice as the elastic action sees it this session."""

    __slots__ = ("name", "domain", "nodes", "chips", "idle_chips",
                 "busy", "quarantined")

    def __init__(self, name: str, domain: str):
        self.name = name
        self.domain = domain
        self.nodes: List = []
        self.chips = 0.0
        self.idle_chips = 0.0
        self.busy = False
        self.quarantined = False

    @property
    def idle(self) -> bool:
        return not self.busy and not self.quarantined and self.chips > 0


def _quarantined(node) -> bool:
    from volcano_tpu_torch.api.slicehealth import (
        NODE_QUARANTINED_UNTIL_ANNOTATION)
    if node.node is None:
        return False
    try:
        until = float(node.node.annotations.get(
            NODE_QUARANTINED_UNTIL_ANNOTATION, 0) or 0)
    except (TypeError, ValueError):
        return False
    return until > time.time()


def slice_views(ssn) -> Dict[str, SliceView]:
    """slice name -> SliceView over the session's node snapshot."""
    out: Dict[str, SliceView] = {}
    for node in ssn.nodes.values():
        if node.node is None:
            continue
        sl = node.node.labels.get(GPU_CLIQUE_LABEL)
        if not sl:
            continue
        view = out.get(sl)
        if view is None:
            view = out[sl] = SliceView(
                sl, node.node.labels.get(IB_FABRIC_LABEL, ""))
        view.nodes.append(node)
        chips = float(node.allocatable.get(GPU))
        used = float(node.used.get(GPU))
        view.chips += chips
        view.idle_chips += max(0.0, chips - used)
        if node.tasks or used > 0 or not node.ready:
            view.busy = True
        if _quarantined(node):
            view.quarantined = True
    return out


def job_slices(ssn, job: JobInfo) -> List[str]:
    """Slices the job's placed tasks currently occupy."""
    names = set()
    for task in job.tasks.values():
        if task.status in (TaskStatus.ALLOCATED, TaskStatus.BINDING,
                           TaskStatus.BOUND, TaskStatus.RUNNING) \
                and task.node_name:
            node = ssn.nodes.get(task.node_name)
            if node is not None and node.node is not None:
                sl = node.node.labels.get(GPU_CLIQUE_LABEL)
                if sl:
                    names.add(sl)
    return sorted(names)


def _chips_per_slice(job: JobInfo, pg) -> float:
    """Chips one slice of this job's world costs: pods-per-slice x
    per-pod GPU request (pods-per-slice = replicas / current slices,
    invariant across resizes — admission validates divisibility)."""
    tasks = list(job.tasks.values())
    if not tasks:
        return 0.0
    per_pod = max(float(t.resreq.get(GPU)) for t in tasks)
    cur = eapi.current_slices(pg)
    per_slice_pods = max(1, len(tasks) // max(1, cur))
    return per_pod * per_slice_pods


class ElasticAction(Action):
    name = "elastic"

    def execute(self, ssn) -> None:
        elastic_jobs = [
            j for j in ssn.jobs.values()
            if j.podgroup is not None and eapi.is_elastic(j.podgroup)]
        if not elastic_jobs:
            return
        conf = ssn.conf.configurations.get("elastic", {})
        try:
            cooldown = float(conf.get("elastic.cooldownSeconds",
                                      DEFAULT_COOLDOWN_S))
        except (TypeError, ValueError):
            cooldown = DEFAULT_COOLDOWN_S
        self._gate_on = str(conf.get("elastic.goodputGateGrow",
                                     "true")).lower() not in (
            "false", "0", "no", "off")
        try:
            self._gate_frac = float(conf.get(
                "elastic.growMarginalFraction", GROW_MARGINAL_FRACTION))
        except (TypeError, ValueError):
            self._gate_frac = GROW_MARGINAL_FRACTION
        now = time.time()
        slices = slice_views(ssn)
        idle = [s for s in slices.values() if s.idle]

        # pending demand in chips: gang-blocked jobs whose pending
        # tasks allocate could not place this cycle (the capacity a
        # shrink must produce / a grow must NOT consume)
        pending_jobs = []
        pending_chips = 0.0
        for job in ssn.jobs.values():
            pg = job.podgroup
            if pg is None or pg.phase not in (PodGroupPhase.PENDING,
                                              PodGroupPhase.INQUEUE):
                continue
            if eapi.evacuating(pg):
                # a gang drained (or draining) for a cross-region
                # cutover is LEAVING: its held pods are not demand
                # this region should shrink donors to fund
                continue
            pending = [t for t in
                       job.tasks_in_status(TaskStatus.PENDING)
                       if not t.best_effort]
            if not pending or ssn.job_ready(job):
                continue
            pending_jobs.append(job)
            pending_chips += sum(float(t.resreq.get(GPU))
                                 for t in pending)

        decided = self._shrink_pending_to_fit(ssn, pending_jobs, idle,
                                              cooldown, now)
        # ONE resize in flight at a time: while any elastic gang is
        # mid-drain, its vacated slices read as idle — deciding a new
        # grow/shrink against them double-spends the same capacity
        # and the fleet oscillates (gang A grows into gang B's drain,
        # B re-places into A's, forever).  Pending-to-fit above is
        # exempt: it only ever shrinks a gang toward what exists.
        # DEMAND-side gangs are exempt too: a gang requeued by its
        # own grow (the serving scale-up path) is pending precisely
        # FOR the capacity this cycle must produce — counting it
        # would wedge the funding shrink below until the cooldown
        # expires and pending-to-fit reverts the grow instead.  Its
        # vacated slices are already subtracted from the deficit, so
        # nothing is double-spent.
        demand = {id(j) for j in pending_jobs}
        if any(self._in_flight(j.podgroup) for j in elastic_jobs
               if id(j) not in demand):
            return
        # slices reserved for pending fixed demand are not growable
        reserve = pending_chips
        grow_pool = []
        for s in sorted(idle, key=lambda s: (s.domain, s.name)):
            if s.name in decided:
                continue
            if reserve > 0:
                reserve -= s.chips
                continue
            grow_pool.append(s)
        self._grow(ssn, elastic_jobs, grow_pool, cooldown, now)
        # the deficit is recomputed against IN-FLIGHT DRAINS at
        # decision time: a demand-side gang requeued by its own grow
        # (the serving scale-up path) still OCCUPIES its old slices
        # while the drain executes — they read busy, not idle, yet
        # the restart is guaranteed to vacate them before the gang
        # re-places.  Counting those chips as neither idle nor freed
        # inflated the deficit by the gang's whole old footprint and
        # over-evicted training victims (a 2->3 serving grow funded 3
        # slices instead of 1, self-correcting only a cooldown later
        # via regrow).  Credit the draining chips up front instead.
        draining = self._draining_chips(ssn, pending_jobs, now)
        deficit = pending_chips - sum(s.chips for s in idle) - draining
        if deficit > 0:
            self._shrink(ssn, elastic_jobs, slices, idle, deficit,
                         cooldown, now)

    # -- decision plumbing ---------------------------------------------

    def _draining_chips(self, ssn, pending_jobs, now: float) -> float:
        """Chips that in-flight drains of DEMAND-SIDE gangs are about
        to free: every node-holding task (allocated/bound/running, or
        already releasing) of a pending elastic gang whose resize or
        requeue is executing.  These are exactly the gangs the
        in-flight barrier exempts — their teardown is the other half
        of the capacity this cycle's deficit must produce."""
        from volcano_tpu_torch.api.types import ALLOCATED_TASK_STATUSES
        holding = ALLOCATED_TASK_STATUSES | {TaskStatus.RELEASING}
        freed = 0.0
        for job in pending_jobs:
            pg = job.podgroup
            if pg is None or not eapi.is_elastic(pg) or \
                    not self._in_flight(pg, now):
                continue
            freed += sum(float(t.resreq.get(GPU))
                         for t in job.tasks.values()
                         if t.status in holding and t.node_name)
        return freed

    @staticmethod
    def _in_flight(pg, now: Optional[float] = None) -> bool:
        from volcano_tpu_torch.api.types import PodGroupPhase
        from volcano_tpu_torch.api.slicehealth import REQUEUED_ANNOTATION
        # A desired decision counts only while FRESH: with no elastic
        # controller alive to execute it, the decision must expire
        # rather than freeze the loop (and the preempt veto) forever.
        # REQUEUED counts only while the gang is NOT running: a
        # failover/resize in progress keeps capacity in flux, but a
        # stale marker on a running gang (controller restarted before
        # clearing it) must not freeze the decision loop.
        now = time.time() if now is None else now
        return ((eapi.desired_slices(pg) is not None
                 and not eapi.decision_stale(pg, now))
                or eapi.ELASTIC_RESIZING_ANNOTATION in pg.annotations
                or bool(eapi.avoid_slices(pg))
                or (pg.annotations.get(REQUEUED_ANNOTATION) == "true"
                    and pg.phase is not PodGroupPhase.RUNNING))

    @staticmethod
    def _cooling(pg, cooldown: float, now: float) -> bool:
        try:
            last = float(pg.annotations.get(
                eapi.ELASTIC_LAST_RESIZE_TS_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            return False
        return bool(cooldown) and now - last < cooldown

    def _stamp(self, ssn, job: JobInfo, desired: int, kind: str,
               detail: str) -> None:
        pg = job.podgroup
        prev = eapi.desired_slices(pg)
        pg.annotations[eapi.ELASTIC_DESIRED_SLICES_ANNOTATION] = \
            str(desired)
        pg.annotations[eapi.ELASTIC_RESIZE_REASON_ANNOTATION] = kind
        if prev != desired or eapi.ELASTIC_DECIDED_TS_ANNOTATION \
                not in pg.annotations:
            # first-stamp time of THIS desired value: re-deciding the
            # same value must not refresh it, or an unexecuted
            # decision could never go stale
            pg.annotations[eapi.ELASTIC_DECIDED_TS_ANNOTATION] = \
                f"{time.time():.3f}"
        ssn.cache.update_podgroup_status(pg)
        ssn.cache.record_event(
            job.key, "ElasticDecision",
            f"{kind} to {desired} slice(s): {detail}")
        metrics.inc("elastic_decisions_total", kind=kind)
        log.info("elastic: %s %s -> %d slices (%s)", kind, job.key,
                 desired, detail)

    # -- grow -----------------------------------------------------------

    def _grow(self, ssn, elastic_jobs, pool: List[SliceView],
              cooldown: float, now: float) -> None:
        from volcano_tpu_torch.api import serving as sapi
        growable = PriorityQueue(ssn.job_order_fn)
        for job in elastic_jobs:
            pg = job.podgroup
            rng = eapi.elastic_range(pg)
            if rng is None or pg.phase is not PodGroupPhase.RUNNING:
                continue
            # serving groups size from TRAFFIC, not from idle chips:
            # the SLO autoscaler (controllers/serving.py) owns their
            # replica count — greedy absorption would hand a quiet
            # group chips it must immediately shed
            if sapi.is_serving(pg):
                continue
            if self._in_flight(pg) or self._cooling(pg, cooldown, now):
                continue
            if eapi.current_slices(pg) < rng[1]:
                growable.push(job)
        for job in growable:
            if not pool:
                break
            pg = job.podgroup
            cur = eapi.current_slices(pg)
            if not self._grow_pays(ssn, job, pg, cur):
                continue
            per_slice = _chips_per_slice(job, pg)
            usable = [s for s in pool if s.chips >= per_slice > 0]
            take = min(eapi.elastic_range(pg)[1] - cur, len(usable))
            if take <= 0:
                continue
            taken = usable[:take]
            for s in taken:
                pool.remove(s)
            self._stamp(ssn, job, cur + take, eapi.RESIZE_GROW,
                        f"absorbing {take} idle slice(s) "
                        f"({', '.join(s.name for s in taken)})")

    def _grow_pays(self, ssn, job: JobInfo, pg, cur: int) -> bool:
        """Goodput grow gate (closed loop over the observatory):
        consult the session's ThroughputBook for the measured marginal
        throughput the job's LAST grow bought.  Declining is a
        per-cycle decision, not a latch — once the measured rate at
        the current size improves (or the data ages into a better
        EWMA), the gate reopens.  No data -> no opinion -> allow:
        greedy absorption stays the cold-start behavior."""
        book = getattr(ssn, "goodput", None)
        if not self._gate_on or book is None:
            return True
        verdict = book.grow_verdict(pg.key, cur, self._gate_frac)
        if verdict is None:
            return True
        if verdict:
            metrics.inc("goodput_gated_grows_total",
                        decision="allowed")
            return True
        metrics.inc("goodput_gated_grows_total", decision="declined")
        ssn.cache.record_event(
            job.key, "ElasticGrowDeclined",
            f"measured marginal throughput below threshold at {cur} "
            f"slice(s); idle capacity left for better scalers")
        log.info("elastic: grow of %s declined by goodput gate at %d "
                 "slice(s)", job.key, cur)
        return False

    # -- shrink (running victims, topology-aware) ------------------------

    @staticmethod
    def _slice_leaf(ssn, view: SliceView) -> Optional[str]:
        """Leaf hypernode hosting a slice (tier-1: hypernode == NVLink
        domain, so any member node resolves it)."""
        hn = getattr(ssn, "hypernodes", None)
        if hn is None:
            return None
        for node in view.nodes:
            leaf = hn.leaf_of_node(node.name)
            if leaf:
                return leaf
        return None

    def _serving_tier(self, ssn, slices, anchor_leaves,
                      job: JobInfo, slice_name: str) -> float:
        """NVLink/IB distance (hypernode LCA tier; lower = closer) from
        one of the victim's slices to the nearest serving-pool slice."""
        view = slices.get(slice_name)
        if view is None:
            return math.inf
        leaf = self._slice_leaf(ssn, view)
        if leaf is None:
            return math.inf
        hn = ssn.hypernodes
        return min((hn.lca_tier_of_leaves(leaf, al)
                    for al in anchor_leaves), default=math.inf)

    def _shrink(self, ssn, elastic_jobs, slices, idle, deficit: float,
                cooldown: float, now: float) -> None:
        from volcano_tpu_torch.api import serving as sapi
        victims = []
        for job in elastic_jobs:
            pg = job.podgroup
            rng = eapi.elastic_range(pg)
            if rng is None or pg.phase is not PodGroupPhase.RUNNING:
                continue
            # serving groups are never donors: shedding a replica to
            # fund generic pending demand trades a latency SLO for
            # queue progress — only their own autoscaler shrinks them
            if sapi.is_serving(pg):
                continue
            if self._in_flight(pg) or self._cooling(pg, cooldown, now):
                continue
            cur = eapi.current_slices(pg)
            if cur > rng[0]:
                victims.append(job)
        if not victims:
            return
        # topology-aware ordering: idle chips already concentrate in
        # some domain — shed slices THERE first, so freed + idle form
        # one contiguous block a multi-slice gang can take whole
        idle_by_domain: Dict[str, float] = {}
        for s in idle:
            idle_by_domain[s.domain] = \
                idle_by_domain.get(s.domain, 0.0) + s.chips

        def domain_affinity(job: JobInfo) -> float:
            return max((idle_by_domain.get(slices[sl].domain, 0.0)
                        for sl in job_slices(ssn, job)
                        if sl in slices), default=0.0)

        # lowest-allocation-priority victims shed first (reverse job
        # order), then stable-sorted so the topology key dominates
        by_priority = list(PriorityQueue(ssn.job_order_fn, victims))
        by_priority.reverse()

        # serving burst preemption (plugins/serving.py exported the
        # anchor): rank victims by hypernode-LCA proximity of their
        # occupied slices to the SERVING POOL, so the eviction frees
        # an NVLink-contiguous block next to the replicas — not merely
        # an equally-sized hole anywhere.  Without an anchor, fall
        # back to idle-domain affinity (freed + idle form one block).
        anchors = {s for s in getattr(ssn, "serving_anchor_slices",
                                      ()) or () if s in slices}
        anchor_leaves = []
        if anchors and getattr(ssn, "hypernodes", None) is not None:
            anchor_leaves = [
                leaf for leaf in (self._slice_leaf(ssn, slices[a])
                                  for a in anchors)
                if leaf is not None]
        serving_mode = bool(anchor_leaves)

        def pool_tier(job: JobInfo) -> float:
            return min((self._serving_tier(ssn, slices, anchor_leaves,
                                           job, sl)
                        for sl in job_slices(ssn, job)),
                       default=math.inf)

        if serving_mode:
            ranked = sorted(by_priority, key=pool_tier)
        else:
            ranked = sorted(by_priority,
                            key=lambda j: -domain_affinity(j))
        for job in ranked:
            if deficit <= 0:
                break
            pg = job.podgroup
            rng = eapi.elastic_range(pg)
            cur = eapi.current_slices(pg)
            per_slice = _chips_per_slice(job, pg)
            if per_slice <= 0:
                continue
            want = math.ceil(deficit / per_slice)
            take = min(cur - rng[0], want)
            if take <= 0:
                continue
            deficit -= take * per_slice
            detail = f"freeing {take} slice(s) for pending demand"
            if serving_mode:
                # steer the victim's re-placement OFF its slices
                # nearest the serving pool: the avoid preference
                # (elastic plugin predicate, yield-guarded by the
                # controller) makes the freed block the ADJACENT one,
                # not whichever slices the re-place happens to leave
                near = sorted(
                    job_slices(ssn, job),
                    key=lambda sl: self._serving_tier(
                        ssn, slices, anchor_leaves, job, sl))[:take]
                if near:
                    from volcano_tpu_torch.api import serving as sapi
                    pg.annotations[
                        eapi.ELASTIC_AVOID_SLICES_ANNOTATION] = \
                        ",".join(near)
                    pg.annotations[sapi.VICTIM_ANNOTATION] = "true"
                    detail = (f"freeing {take} NVLink-adjacent slice(s) "
                              f"({', '.join(near)}) for a serving "
                              f"scale-up")
                metrics.inc("serving_victim_shrinks_total")
            self._stamp(ssn, job, cur - take, eapi.RESIZE_SHRINK,
                        detail)

    # -- pending elastic jobs: fit down / name the wait ------------------

    def _shrink_pending_to_fit(self, ssn, pending_jobs, idle,
                               cooldown: float, now: float) -> set:
        """Resize a PENDING elastic gang down to what idle capacity
        holds (spec-only; it never started, nothing drains).  Returns
        slice names notionally consumed by these decisions so grow
        does not double-spend them."""
        consumed: set = set()
        for job in pending_jobs:
            pg = job.podgroup
            rng = eapi.elastic_range(pg) if eapi.is_elastic(pg) else None
            if rng is None:
                continue
            # NARROWER in-flight check than grow/shrink: a pending
            # gang is re-fit even while REQUEUED (a drained gang that
            # can no longer place at its decided size would otherwise
            # wedge forever — shrink-to-fit is the unwedge); a STALE
            # decision (no controller consuming it) is replaceable
            if (eapi.desired_slices(pg) is not None
                    and not eapi.decision_stale(pg, now)) or \
                    self._cooling(pg, cooldown, now):
                continue
            cur = eapi.current_slices(pg)
            per_slice = _chips_per_slice(job, pg)
            free = [s for s in idle
                    if s.name not in consumed and s.chips >= per_slice]
            fit = min(len(free), cur)
            if per_slice <= 0:
                continue
            if cur > rng[0] and rng[0] <= fit < cur:
                for s in free[:fit]:
                    consumed.add(s.name)
                self._stamp(ssn, job, fit, eapi.RESIZE_SHRINK,
                            f"pending gang resized to fit {fit} idle "
                            f"slice(s)")
            elif fit < max(cur, rng[0]):
                # blocked at (or below) the floor: name the wait with
                # the bounded enum instead of the generic fit errors
                # normalizing to `other`/`insufficient-resources` only
                pending = job.tasks_in_status(TaskStatus.PENDING)
                if pending:
                    errs = job.fit_errors.setdefault(
                        pending[0].uid, FitErrors())
                    if not errs.err:
                        errs.set_error(
                            f"elastic: waiting for capacity — "
                            f"{fit} idle slice(s) for a "
                            f"min {rng[0]}-slice gang")
        return consumed


register_action(ElasticAction())

"""Serving autoscaler — SLO-driven replica counts over the elastic
resize path.

A serving replica group IS an elastic gang (api/serving.py): its
min/max-replicas ride the elastic min/max-slices annotations with one
replica per slice-unit.  This controller closes the loop the agent
plane opened — the store folds every node's ServingReport into the
group's podgroup annotations (QPS summed across replicas, p99 maxed),
and each sync this reconciler turns that folded signal into the SAME
desired-slices decision the elastic controller already executes:
grow, shrink, checkpointed drain, floor guards, history — all
inherited, never reimplemented.

Hysteresis (the damping the RateWindow burst tests pin):

  scale UP    when folded QPS exceeds SCALE_UP_FRAC x target x
              current replicas, OR the measured p99 breaches the
              declared SLO while traffic flows — sized straight to
              ceil(qps / target) so one decision covers a step burst
              instead of inching up a replica per sync;

  scale DOWN  only when QPS sags below SCALE_DOWN_FRAC x target x
              (current - 1) — i.e. the group would STILL be
              comfortable one replica smaller — AND p99 holds under
              P99_HEADROOM_FRAC x SLO, sustained for HOLD_DOWN_SYNCS
              consecutive FRESH signals (distinct fold timestamps —
              re-reading one low sample between agent beats is not
              three observations); then a BOUNDED multi-replica step:
              once the streak clears, the decision descends while
              each successively smaller size ALSO satisfies the same
              comfort rule (qps < SCALE_DOWN_FRAC x target x
              (size - 1)), at most MAX_DOWN_STEP replicas per
              decision — a group left 6 replicas over after a burst
              recedes converges in one or two drains instead of six.
              The asymmetry is deliberate: a late scale-up burns the
              SLO, a late scale-down burns only GPUs.

  hold        no fresh traffic signal (updated-ts older than
              SIGNAL_STALE_S, or none yet) means no decision in
              either direction — a dead agent must not read as zero
              traffic and shrink a loaded group to its floor.

The controller also stamps the group's POOL (the NVLink domains its
replicas currently occupy) onto PG_POOL_SLICES_ANNOTATION every sync while
placements are live — the topology anchor the serving-aware shrink in
actions/elastic.py scores training victims against when a scale-up
needs GPUs now.  The last decision and its wall time are stamped for
`vtpctl serve` and the bench's decision->GPUs-free->serving latency
measurement.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import elastic as eapi
from volcano_tpu_torch.api import serving as sapi
from volcano_tpu_torch.api.types import (GROUP_NAME_ANNOTATION,
                                   GPU_CLIQUE_LABEL)
from volcano_tpu_torch.controllers.framework import (Controller,
                                               register_controller)

log = logging.getLogger(__name__)

# hysteresis constants — pinned by tests/test_serving.py: a step-
# function QPS input must trigger exactly one scale-up and no
# immediate scale-down flap
SCALE_UP_FRAC = 1.15
SCALE_DOWN_FRAC = 0.60
P99_HEADROOM_FRAC = 0.80
HOLD_DOWN_SYNCS = 3
SIGNAL_STALE_S = 60.0
# ceiling on replicas shed by ONE down decision: each extra step must
# re-prove the comfort rule at its own size, and the bound keeps a
# mis-folded zero from collapsing a big group to its floor in one move
MAX_DOWN_STEP = 4
# no scale-DOWN within this window of the last executed resize: right
# after a resize the fresh replicas' EWMA QPS warms up from zero, and
# the first few below-threshold readings are warm-up artifacts, not
# receding traffic.  Scale-ups stay live the whole window — a late
# scale-up burns the SLO, a late scale-down burns only GPUs.
RESIZE_STABILIZE_S = 10.0


@register_controller("serving")
class ServingController(Controller):
    name = "serving"

    def __init__(self, now=time.time):
        self.now = now
        # pg key -> (consecutive FRESH low signals, last signal ts)
        self._down_streak: Dict[str, tuple] = {}

    def sync(self) -> None:
        now = self.now()
        n_groups = 0
        qps_total = 0.0
        attainment_min = 1.0
        for pg in list(self.cluster.podgroups.values()):
            if not sapi.is_serving(pg):
                continue
            n_groups += 1
            qps_total += sapi.ann_float(pg, sapi.PG_QPS_ANNOTATION)
            reqs = sapi.ann_float(pg, sapi.PG_REQUESTS_ANNOTATION)
            ok = sapi.ann_float(pg, sapi.PG_SLO_OK_ANNOTATION)
            if reqs > 0:
                attainment_min = min(attainment_min, ok / reqs)
            try:
                self._reconcile(pg, now)
            except Exception:  # noqa: BLE001
                log.exception("serving reconcile of %s failed", pg.key)
        for key in set(self._down_streak) - {
                pg.key for pg in self.cluster.podgroups.values()}:
            del self._down_streak[key]
        metrics.set_gauge("serving_groups", n_groups)
        metrics.set_gauge("serving_qps_total", round(qps_total, 3))
        if n_groups:
            metrics.set_gauge("serving_slo_attainment_min",
                              round(attainment_min, 4))

    # -- reconcile -----------------------------------------------------

    def _reconcile(self, pg, now: float) -> None:
        slo = sapi.slo_p99_ms(pg)
        rng = sapi.replica_range(pg)
        if slo is None or rng is None:
            return
        self._adopt_elastic(pg, rng)
        self._stamp_pool(pg)
        target = sapi.target_qps_per_replica(pg)
        if target <= 0:
            return
        # one resize in flight at a time — reuse the elastic guards:
        # an unexecuted decision or an executing drain owns the gang
        if eapi.desired_slices(pg) is not None or \
                eapi.ELASTIC_RESIZING_ANNOTATION in pg.annotations:
            return
        # resize settle: no decision until the group has been HEARD
        # FROM at its current restart/resize epoch.  Right after a
        # grow executes, the drained replicas' last records decay the
        # folded QPS toward zero — without this guard that reads as
        # traffic receding and reverts the scale-up mid-drain (the
        # flap the smoke caught live)
        if self._folded_epoch(pg) < self._expected_epoch(pg):
            self._down_streak.pop(pg.key, None)
            return
        updated = sapi.ann_float(pg, sapi.PG_UPDATED_TS_ANNOTATION)
        if updated <= 0 or now - updated > SIGNAL_STALE_S:
            return          # quiet-vs-dead: no fresh signal, no move
        qps = sapi.ann_float(pg, sapi.PG_QPS_ANNOTATION)
        p99 = sapi.ann_float(pg, sapi.PG_P99_MS_ANNOTATION)
        cur = eapi.current_slices(pg)
        lo, hi = rng

        if (qps > SCALE_UP_FRAC * target * cur or
                (p99 > slo and qps > 0)) and cur < hi:
            desired = min(hi, max(cur + 1,
                                  math.ceil(qps / target)))
            why = ("p99-over-slo" if p99 > slo
                   else "qps-above-target")
            self._down_streak.pop(pg.key, None)
            self._decide(pg, cur, desired, "up", why, qps, p99, now)
            return
        if cur > lo and qps < SCALE_DOWN_FRAC * target * (cur - 1) \
                and p99 < P99_HEADROOM_FRAC * slo \
                and not self._stabilizing(pg, now):
            # streaks count FRESH SIGNALS (distinct updated-ts), not
            # controller syncs: the reconciler may run many times
            # between two agent beats, and re-reading one low sample
            # three times is not three observations of low traffic
            streak, last_ts = self._down_streak.get(pg.key, (0, 0.0))
            if updated > last_ts:
                streak += 1
            self._down_streak[pg.key] = (streak, updated)
            if streak < HOLD_DOWN_SYNCS:
                return
            self._down_streak.pop(pg.key, None)
            # bounded multi-replica descent: keep stepping down while
            # the NEXT size also clears the same comfort rule the
            # hysteresis proved for cur - 1
            desired = cur - 1
            floor = max(lo, cur - MAX_DOWN_STEP)
            while desired > floor and \
                    qps < SCALE_DOWN_FRAC * target * (desired - 1):
                desired -= 1
            self._decide(pg, cur, desired, "down",
                         "traffic-receding", qps, p99, now)
            return
        self._down_streak.pop(pg.key, None)

    def _decide(self, pg, cur: int, desired: int, kind: str,
                why: str, qps: float, p99: float, now: float) -> None:
        ann = pg.annotations
        ann[eapi.ELASTIC_DESIRED_SLICES_ANNOTATION] = str(desired)
        ann[eapi.ELASTIC_RESIZE_REASON_ANNOTATION] = \
            eapi.RESIZE_GROW if desired > cur else eapi.RESIZE_SHRINK
        ann[eapi.ELASTIC_DECIDED_TS_ANNOTATION] = f"{now:.3f}"
        detail = (f"scale-{kind} {cur}->{desired} ({why}: "
                  f"qps={qps:.1f} p99={p99:.1f}ms)")
        # federated causal episode: a serving drain of a router-placed
        # gang is one hop of its episode — thread the ID through the
        # decision record so the elastic executor's fragment and this
        # decision correlate in /traces?episode=
        from volcano_tpu_torch.api import federation as fedapi
        episode = fedapi.episode_of(pg)
        if episode:
            detail += f" episode={episode}"
        ann[sapi.PG_LAST_DECISION_ANNOTATION] = detail
        ann[sapi.PG_LAST_DECISION_TS_ANNOTATION] = f"{now:.3f}"
        self.cluster.update_podgroup_status(pg)
        self.cluster.record_event(pg.key, "ServingScale", detail)
        metrics.inc("serving_scale_decisions_total", kind=kind)
        log.info("serving: %s %s", pg.key, detail)

    @staticmethod
    def _stabilizing(pg, now: float) -> bool:
        """Within RESIZE_STABILIZE_S of the last executed resize —
        scale-downs are held while fresh replicas' QPS warms up."""
        try:
            last = float(pg.annotations.get(
                eapi.ELASTIC_LAST_RESIZE_TS_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            return False
        return last > 0 and now - last < RESIZE_STABILIZE_S

    @staticmethod
    def _expected_epoch(pg) -> int:
        """The epoch replicas of the CURRENT incarnation report under
        (VTP_EPOCH contract: failover generation + elastic
        generation, the same sum the jax plugin injects)."""
        from volcano_tpu_torch.api.slicehealth import (
            FAILOVER_GENERATION_ANNOTATION)
        total = 0
        for key in (FAILOVER_GENERATION_ANNOTATION,
                    eapi.ELASTIC_GENERATION_ANNOTATION):
            try:
                total += int(pg.annotations.get(key, 0) or 0)
            except (TypeError, ValueError):
                pass
        return total

    @staticmethod
    def _folded_epoch(pg) -> int:
        return int(sapi.ann_float(pg, sapi.PG_EPOCH_ANNOTATION))

    # -- adoption + pool stamping --------------------------------------

    def _adopt_elastic(self, pg, rng) -> None:
        """Serving groups ARE elastic gangs: mirror the replica range
        onto the elastic annotations when the submitter declared only
        the serving contract (vcjob kept in lockstep so the elastic
        controller's range clamp sees the same floor/ceiling)."""
        if eapi.is_elastic(pg):
            return
        lo, hi = rng
        for obj in (pg, self.cluster.vcjobs.get(pg.key)):
            if obj is None:
                continue
            obj.annotations[eapi.ELASTIC_MIN_SLICES_ANNOTATION] = \
                str(lo)
            obj.annotations[eapi.ELASTIC_MAX_SLICES_ANNOTATION] = \
                str(hi)
            obj.annotations.setdefault(
                eapi.ELASTIC_SLICES_ANNOTATION, str(lo))
        self.cluster.update_podgroup_status(pg)
        self.cluster.record_event(
            pg.key, "ServingAdopted",
            f"serving group adopted as elastic gang "
            f"({lo}..{hi} replicas)")

    def _stamp_pool(self, pg) -> None:
        """Stamp the NVLink domains currently hosting this group's replicas —
        kept as the LAST known pool during a drain (pods gone), so the
        topology anchor survives the scale-up window that needs it."""
        ns, _, name = pg.key.partition("/")
        slices = set()
        for pod in self.cluster.pods.values():
            if pod.namespace != ns or pod.annotations.get(
                    GROUP_NAME_ANNOTATION) != name:
                continue
            if not pod.node_name or pod.is_terminated():
                continue
            node = self.cluster.nodes.get(pod.node_name)
            if node is None:
                continue
            sl = node.labels.get(GPU_CLIQUE_LABEL)
            if sl:
                slices.add(sl)
        if not slices:
            return
        stamped = ",".join(sorted(slices))
        if pg.annotations.get(sapi.PG_POOL_SLICES_ANNOTATION) != \
                stamped:
            pg.annotations[sapi.PG_POOL_SLICES_ANNOTATION] = stamped
            self.cluster.update_podgroup_status(pg)

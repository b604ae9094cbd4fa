"""Elastic controller — executes resize/migrate decisions via the
checkpoint-drain-resume path.

The scheduler's elastic action stamps a DECISION on the podgroup
(desired-slices + resize-reason, avoid-slices for migrations; a
slice is one NVLink domain); this reconciler turns the decision into a
running gang at the new world size by generalizing the failover
machinery from failure-initiated to POLICY-initiated:

  scale    task replicas -> desired x pods-per-slice (pods-per-slice
           is invariant: replicas / current slices, admission-
           validated), minAvailable/minMember in lockstep — the gang
           stays a gang, just a different size;
  stamp    resume metadata exactly like a failover drain: resume step
           snapshotted from the workload's last-checkpoint-step and
           FLOOR-GUARDED (never below an already-stamped step — a
           failover racing a resize must not rewind training), the
           elastic generation, the REQUEUED fast-lane marker so
           re-placement sorts first;
  drain    ONE job-level RestartJob (job controller deletes every
           stale pod, no per-pod policy cascade, no maxRetry burn) —
           but only for a RUNNING job: a pending gang resizes with a
           pure spec update, nothing to drain;
  resume   the scheduler re-places at the new size (the elastic
           plugin keeps migrations off their avoid-slices), workers
           boot with VTP_RESUME_STEP/VTP_CHECKPOINT_DIR and restore
           onto the resized mesh.

Race with failover (tests/test_elastic.py): a slice failure arriving
mid-resize is safe by construction — the failover controller skips
its RestartJob while the job is already RESTARTING (one drain in
flight is THE drain) and both controllers floor-guard the resume
step, so the gang sees exactly one teardown and never a step rewind.
While the failover REQUEUED marker belongs to an unfinished failover
episode, this controller defers new resizes for that gang.

Every executed resize is timed into the elastic_* metric families
(decide -> drained -> resumed; kind = grow|shrink|migrate — bounded
labels only) and appended to the history annotation `vtpctl elastic`
renders.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from volcano_tpu_torch.api import elastic as eapi
from volcano_tpu_torch.api import federation as fedapi
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION, JobAction, JobPhase, TaskStatus
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)


class ResizeEpisode:
    """One resize walking decide -> drain -> resume.  In-memory for
    latency accounting only: the durable state (scaled spec, resume
    metadata, generation) lives on the CRD objects, so a controller
    restart loses the timing breakdown, never the resize."""

    __slots__ = ("pg_key", "job_key", "kind", "from_slices",
                 "to_slices", "decided_ts", "drained_ts", "resumed_ts",
                 "target_replicas", "decision_version", "restarted",
                 "scale_tasks", "stall_rounds", "episode")

    def __init__(self, pg_key: str, job_key: str, kind: str,
                 from_slices: int, to_slices: int, decided_ts: float,
                 target_replicas: int, decision_version: int,
                 restarted: bool, scale_tasks=(), episode: str = ""):
        self.pg_key = pg_key
        self.job_key = job_key
        self.kind = kind
        self.from_slices = from_slices
        self.to_slices = to_slices
        self.decided_ts = decided_ts
        # federated causal episode riding the gang (empty for purely
        # regional resizes): drain/resume fragments publish under it
        self.episode = episode
        self.drained_ts: Optional[float] = None
        self.resumed_ts: Optional[float] = None
        self.target_replicas = target_replicas
        self.decision_version = decision_version
        self.restarted = restarted
        # task-spec names the resize scaled: drain/resume detection
        # counts ONLY their pods (a non-GPU driver task must not
        # satisfy the worker count)
        self.scale_tasks = set(scale_tasks)
        # sync rounds spent drained-but-not-resumed (migration yield)
        self.stall_rounds = 0


# drained-but-unplaced sync rounds a migration may stall before its
# avoid-slices preference yields (the old homes become legal again):
# steering is a preference, starving the gang is not an option
MIGRATE_YIELD_ROUNDS = 20


@register_controller("elastic")
class ElasticController(Controller):
    name = "elastic"

    def __init__(self, now=time.time):
        self.now = now
        self._episodes: Dict[str, ResizeEpisode] = {}

    # -- reconcile -----------------------------------------------------

    def sync(self) -> None:
        from volcano_tpu_torch import metrics
        now = self.now()
        n_elastic, total_slices = 0, 0
        for pg in list(self.cluster.podgroups.values()):
            if not eapi.is_elastic(pg):
                continue
            n_elastic += 1
            total_slices += eapi.current_slices(pg)
            try:
                self._reconcile(pg, now)
            except Exception:  # noqa: BLE001
                log.exception("elastic reconcile of %s failed", pg.key)
        metrics.set_gauge("elastic_jobs", n_elastic)
        metrics.set_gauge("elastic_slices_total", total_slices)
        self._adopt_orphans(now)
        self._progress_episodes(now)

    def _adopt_orphans(self, now: float) -> None:
        """Rebuild episodes for resizes stamped by a PREVIOUS
        controller process (the durable `resizing` annotation outlives
        our in-memory episode dict): without adoption the in-flight
        marker would never clear and the scheduler's convergence
        guard would freeze elastic decisions fleet-wide."""
        for pg in list(self.cluster.podgroups.values()):
            kind = pg.annotations.get(eapi.ELASTIC_RESIZING_ANNOTATION)
            if not kind or pg.key in self._episodes:
                continue
            job = self.cluster.vcjobs.get(pg.key)
            if job is None:
                continue
            hist = eapi.resize_history(pg)
            last = hist[-1] if hist else {}
            try:
                decided = float(pg.annotations.get(
                    eapi.ELASTIC_LAST_RESIZE_TS_ANNOTATION, now)
                    or now)
            except (TypeError, ValueError):
                decided = now
            tasks = self._scalable_tasks(job)
            self._episodes[pg.key] = ResizeEpisode(
                pg.key, job.key, kind,
                int(last.get("from", 0) or 0),
                int(last.get("to", eapi.current_slices(pg))
                    or eapi.current_slices(pg)),
                decided, sum(t.replicas for t in tasks),
                # the restart command (if any) was issued before we
                # existed: version-1 makes the drained check pass once
                # the bump is visible
                max(0, job.version - 1), True,
                scale_tasks=[t.name for t in tasks],
                episode=fedapi.episode_of(pg) or "")
            log.info("elastic: adopted in-flight %s of %s from a "
                     "previous controller process", kind, pg.key)

    def _reconcile(self, pg, now: float) -> None:
        from volcano_tpu_torch.api.slicehealth import REQUEUED_ANNOTATION
        desired = eapi.desired_slices(pg)
        if desired is None:
            return
        job = self.cluster.vcjobs.get(pg.key)
        if job is None:
            # bare podgroups have no controller to re-materialize a
            # different replica count: refuse loudly, don't wedge
            self._clear_decision(pg)
            self.cluster.record_event(
                pg.key, "ElasticRejected",
                "elastic resize needs a vcjob owner")
            return
        ep = self._episodes.get(pg.key)
        if ep is not None:
            if job.phase is JobPhase.RUNNING or ep.drained_ts is None:
                return          # teardown/resume still progressing
            # drained but the gang cannot place at the decided size
            # (capacity raced away mid-resize): the NEW decision
            # supersedes the wedged episode instead of deadlocking
            self.cluster.record_event(
                pg.key, "ElasticSuperseded",
                f"{ep.kind} to {ep.to_slices} slice(s) superseded "
                f"before resuming")
            del self._episodes[pg.key]
        if job.phase is JobPhase.RESTARTING:
            return              # a drain is in flight; wait it out
        if pg.annotations.get(REQUEUED_ANNOTATION) == "true" and \
                job.phase is JobPhase.RUNNING:
            # an unfinished failover episode owns the RUNNING gang;
            # defer the resize until it resumes (no double-drain).  A
            # non-running gang resizes spec-only — nothing to drain,
            # and shrink-to-fit is how a wedged re-place unwedges.
            return
        rng = eapi.elastic_range(pg)
        cur = eapi.current_slices(pg)
        if rng is None:
            self._clear_decision(pg)
            return
        desired = max(rng[0], min(rng[1], desired))
        kind = pg.annotations.get(
            eapi.ELASTIC_RESIZE_REASON_ANNOTATION, "") or (
            eapi.RESIZE_GROW if desired > cur else eapi.RESIZE_SHRINK)
        if desired == cur and kind not in (eapi.RESIZE_MIGRATE,
                                           eapi.RESIZE_EVACUATE):
            self._clear_decision(pg)
            return
        self._execute(job, pg, cur, desired, kind, now)

    # -- execution ------------------------------------------------------

    def _scalable_tasks(self, job):
        """The worker tasks a resize scales: GPU-requesting specs (the
        process grid); everything else (drivers etc.) keeps its size."""
        out = []
        for spec in job.tasks:
            pod = spec.template_pod()
            if float(pod.resource_requests().get(GPU) or 0) > 0:
                out.append(spec)
        return out or list(job.tasks)

    def _execute(self, job, pg, cur: int, desired: int, kind: str,
                 now: float) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api.slicehealth import (
            CHECKPOINT_DIR_ANNOTATION, LAST_STEP_ANNOTATION,
            REQUEUED_ANNOTATION, RESUME_STEP_ANNOTATION)
        tasks = self._scalable_tasks(job)
        old_total = sum(t.replicas for t in tasks)
        if old_total <= 0 or old_total % cur:
            self._clear_decision(pg)
            self.cluster.record_event(
                pg.key, "ElasticRejected",
                f"replicas {old_total} not divisible by {cur} slices")
            return
        per_slice = old_total // cur
        new_total = desired * per_slice
        old_all = sum(t.replicas for t in job.tasks)
        old_min = job.min_available
        for spec in tasks:
            spec_per_slice = spec.replicas // cur
            old_rep = spec.replicas
            spec.replicas = spec_per_slice * desired
            if spec.min_available is None or \
                    spec.min_available >= old_rep:
                spec.min_available = spec.replicas
            else:
                # partial-gang floor: preserve the declared RATIO, a
                # resize changes the size, never the readiness policy
                spec.min_available = min(
                    spec.replicas,
                    max(0, -(-spec.min_available * desired // cur)))
        new_all = sum(t.replicas for t in job.tasks)
        job.min_available = new_all if old_min >= old_all else min(
            new_all, max(1, -(-old_min * new_all // max(1, old_all))))

        # resume metadata: identical contract to a failover drain, but
        # FLOOR-GUARDED — a resize must never stamp a step below one
        # already stamped (failover racing a shrink, or vice versa)
        last_step = self._int_ann(pg, LAST_STEP_ANNOTATION,
                                  self._int_ann(job,
                                                LAST_STEP_ANNOTATION))
        stamped = self._int_ann(job, RESUME_STEP_ANNOTATION)
        resume = max(x for x in (last_step, stamped, None)
                     if x is not None) \
            if (last_step is not None or stamped is not None) else None
        gen = self._int_ann(job, eapi.ELASTIC_GENERATION_ANNOTATION,
                            0) + 1
        record = {"ts": round(now, 3), "kind": kind, "from": cur,
                  "to": desired, "gen": gen}
        for obj in (job, pg):
            ann = obj.annotations
            ann[eapi.ELASTIC_SLICES_ANNOTATION] = str(desired)
            ann[eapi.ELASTIC_GENERATION_ANNOTATION] = str(gen)
            ann[eapi.ELASTIC_LAST_RESIZE_TS_ANNOTATION] = f"{now:.3f}"
            ann.pop(eapi.ELASTIC_DESIRED_SLICES_ANNOTATION, None)
            ann.pop(eapi.ELASTIC_RESIZE_REASON_ANNOTATION, None)
            ann.pop(eapi.ELASTIC_DECIDED_TS_ANNOTATION, None)
            if resume is not None:
                ann[RESUME_STEP_ANNOTATION] = str(resume)
            eapi.append_history(ann, record)
        # durable in-flight marker (popped at resume): a controller
        # restart mid-resize re-adopts the episode from this
        pg.annotations[eapi.ELASTIC_RESIZING_ANNOTATION] = kind
        if CHECKPOINT_DIR_ANNOTATION in job.annotations:
            pg.annotations[CHECKPOINT_DIR_ANNOTATION] = \
                job.annotations[CHECKPOINT_DIR_ANNOTATION]
        pg.min_member = job.min_available
        pg.min_task_member = {t.name: t.min_available
                              for t in job.tasks
                              if t.min_available is not None}
        running = job.phase is JobPhase.RUNNING
        if running:
            # the Singularity move: ONE job-level drain; the rebuilt
            # gang resumes from the checkpoint at the new world size
            pg.annotations[REQUEUED_ANNOTATION] = "true"
            self.cluster.update_podgroup_status(pg)
            self.cluster.update_vcjob(job)
            self.cluster.add_command(job.key,
                                     JobAction.RESTART_JOB.value)
        else:
            # never started: a spec update IS the whole resize — but
            # any already-materialized pending pods carry the OLD
            # world's env (NUM_PROCESSES, slice ids), so drop them
            # and let the materializer rebuild at the new size; no
            # version bump, nothing was running
            for pod in self._gang_pods(pg.key):
                if not pod.is_terminated():
                    self.cluster.delete_pod(pod.key)
            self.cluster.update_podgroup_status(pg)
            self.cluster.update_vcjob(job)
        self.cluster.record_event(
            job.key, "ElasticResize",
            f"{kind}: {cur} -> {desired} slice(s) (generation {gen}, "
            f"resume step {resume if resume is not None else 'none'}, "
            f"{'drain+restart' if running else 'spec update'})")
        metrics.inc("elastic_resizes_total", kind=kind)
        self._episodes[pg.key] = ResizeEpisode(
            pg.key, job.key, kind, cur, desired, now,
            sum(t.replicas for t in tasks), job.version, running,
            scale_tasks=[t.name for t in tasks],
            episode=fedapi.episode_of(pg) or "")

    @staticmethod
    def _int_ann(obj, key: str, default=None):
        try:
            raw = obj.annotations.get(key)
            return int(raw) if raw is not None else default
        except (TypeError, ValueError):
            return default

    def _clear_decision(self, pg) -> None:
        changed = False
        for key in (eapi.ELASTIC_DESIRED_SLICES_ANNOTATION,
                    eapi.ELASTIC_RESIZE_REASON_ANNOTATION,
                    eapi.ELASTIC_DECIDED_TS_ANNOTATION):
            if pg.annotations.pop(key, None) is not None:
                changed = True
        if changed:
            self.cluster.update_podgroup_status(pg)

    # -- episode progression (drain -> resume) --------------------------

    def _gang_pods(self, pg_key: str, scale_tasks=None):
        """The gang's pods; with *scale_tasks*, only pods of the
        task specs the resize scaled (a non-GPU driver must not
        satisfy — or block — the worker count)."""
        ns, _, name = pg_key.partition("/")
        return [p for p in self.cluster.pods.values()
                if p.namespace == ns
                and p.annotations.get(GROUP_NAME_ANNOTATION) == name
                and (not scale_tasks or p.task_spec in scale_tasks)]

    def _progress_episodes(self, now: float) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES
        for ep in list(self._episodes.values()):
            job = self.cluster.vcjobs.get(ep.job_key)
            if job is None or job.phase in FINISHED_JOB_PHASES:
                self.cluster.record_event(
                    ep.pg_key, "ElasticAbandoned",
                    f"{ep.kind} to {ep.to_slices} slice(s) ended "
                    f"before resuming")
                pg = self.cluster.podgroups.get(ep.pg_key)
                if pg is not None:
                    # the durable in-flight marker must die with the
                    # episode, or the decision guard wedges on a gang
                    # that will never resume
                    from volcano_tpu_torch.api import serving as sapi
                    changed = False
                    for key in (eapi.ELASTIC_RESIZING_ANNOTATION,
                                eapi.ELASTIC_AVOID_SLICES_ANNOTATION,
                                sapi.VICTIM_ANNOTATION):
                        if pg.annotations.pop(key, None):
                            changed = True
                    if changed:
                        self.cluster.update_podgroup_status(pg)
                del self._episodes[ep.pg_key]
                continue
            pods = self._gang_pods(ep.pg_key, ep.scale_tasks)
            if ep.drained_ts is None:
                # drained = the OLD world is gone (shrink frees its
                # slices here — this is the latency a waiting gang
                # feels).  Restart path: the version bump landed and
                # no stale-version pod is still alive; spec-only
                # path: the materializer scaled the gang down.
                from volcano_tpu_torch.controllers.job.controller import (
                    VERSION_LABEL)
                alive = [p for p in pods if not p.is_terminated()]
                if ep.restarted:
                    drained = job.version > ep.decision_version and \
                        not any(p.labels.get(VERSION_LABEL)
                                != str(job.version) for p in alive)
                else:
                    drained = len(alive) <= ep.target_replicas
                if drained:
                    ep.drained_ts = now
                    metrics.observe("elastic_drain_seconds",
                                    now - ep.decided_ts, kind=ep.kind)
                    if ep.kind == eapi.RESIZE_SHRINK:
                        metrics.observe("elastic_shrink_seconds",
                                        now - ep.decided_ts)
                    if ep.kind == eapi.RESIZE_EVACUATE:
                        # the drain IS the whole LOCAL episode: stamp
                        # the evacuated hold (actions/enqueue.py keeps
                        # the gang out of INQUEUE) and stop — resume
                        # happens in the destination region after the
                        # federation router's cutover, never here
                        pg = self.cluster.podgroups.get(ep.pg_key)
                        if pg is not None:
                            from volcano_tpu_torch.api.slicehealth import \
                                REQUEUED_ANNOTATION as _REQ
                            pg.annotations[
                                eapi.ELASTIC_EVACUATED_ANNOTATION] = \
                                "true"
                            pg.annotations.pop(_REQ, None)
                            pg.annotations.pop(
                                eapi.ELASTIC_RESIZING_ANNOTATION,
                                None)
                            self.cluster.update_podgroup_status(pg)
                        self.cluster.record_event(
                            ep.pg_key, "ElasticEvacuated",
                            f"drained in {now - ep.decided_ts:.3f}s; "
                            f"held for cross-region cutover "
                            f"(episode {ep.episode or 'none'})")
                        # the drain is this plane's whole slice of a
                        # cross-region migration: publish it as an
                        # episode fragment for the fleet stitcher
                        self._publish_fragment(
                            ep, "elastic-evacuate-drain", now)
                        del self._episodes[ep.pg_key]
                        continue
            if ep.drained_ts is not None and ep.resumed_ts is None:
                running = sum(1 for p in pods
                              if p.phase is TaskStatus.RUNNING)
                pg = self.cluster.podgroups.get(ep.pg_key)
                if running >= ep.target_replicas and job.phase is \
                        JobPhase.RUNNING:
                    ep.resumed_ts = now
                    self._complete(ep, pg, job, now)
                    continue
                ep.stall_rounds += 1
                if ep.stall_rounds >= MIGRATE_YIELD_ROUNDS and \
                        pg is not None and pg.annotations.pop(
                            eapi.ELASTIC_AVOID_SLICES_ANNOTATION,
                            None) is not None:
                    from volcano_tpu_torch.api import serving as sapi
                    pg.annotations.pop(sapi.VICTIM_ANNOTATION, None)
                    # no destination materialized: the steering
                    # preference yields so the gang may land back on
                    # its old slices instead of starving
                    self.cluster.update_podgroup_status(pg)
                    self.cluster.record_event(
                        ep.pg_key, "ElasticMigrationYielded",
                        f"no placement off the avoided slices after "
                        f"{ep.stall_rounds} rounds; steering "
                        f"preference dropped")

    def _complete(self, ep: ResizeEpisode, pg, job, now: float) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api.slicehealth import (LAST_STEP_ANNOTATION,
                                                 REQUEUED_ANNOTATION,
                                                 RESUME_STEP_ANNOTATION)
        total = now - ep.decided_ts
        metrics.observe("elastic_resize_seconds", total, kind=ep.kind)
        if ep.kind == eapi.RESIZE_MIGRATE:
            # intentional alias of elastic_resize_seconds{kind=
            # migrate}: MTTR is the operator-facing name dashboards
            # and the bench quote
            metrics.observe("elastic_migration_mttr_seconds", total)
        if pg is not None:
            from volcano_tpu_torch.api import serving as sapi
            stamped = self._int_ann(pg, RESUME_STEP_ANNOTATION)
            last = self._int_ann(pg, LAST_STEP_ANNOTATION)
            if stamped is not None and last is not None:
                metrics.observe("elastic_resume_step_gap",
                                max(0, last - stamped))
            changed = False
            for key in (REQUEUED_ANNOTATION,
                        eapi.ELASTIC_RESIZING_ANNOTATION,
                        eapi.ELASTIC_AVOID_SLICES_ANNOTATION,
                        sapi.VICTIM_ANNOTATION):
                if pg.annotations.pop(key, None):
                    changed = True
            if changed:
                self.cluster.update_podgroup_status(pg)
        if job is not None and job.annotations.pop(
                eapi.ELASTIC_AVOID_SLICES_ANNOTATION, None):
            self.cluster.update_vcjob(job)
        self.cluster.record_event(
            ep.pg_key, "ElasticResized",
            f"{ep.kind} {ep.from_slices} -> {ep.to_slices} slice(s) "
            f"resumed in {total:.3f}s")
        self._publish_fragment(ep, f"elastic-{ep.kind}", now)
        del self._episodes[ep.pg_key]

    def _publish_fragment(self, ep: ResizeEpisode, name: str,
                          now: float) -> None:
        """This controller's slice of a federated causal episode,
        pushed to the local plane's trace ring (no-op for purely
        regional resizes or in-process clusters)."""
        if not ep.episode:
            return
        from volcano_tpu_torch import trace
        children = []
        if ep.drained_ts is not None:
            children.append(("drain", ep.decided_ts, ep.drained_ts))
            if ep.resumed_ts is not None:
                children.append(("resume", ep.drained_ts,
                                 ep.resumed_ts))
        pg = self.cluster.podgroups.get(ep.pg_key)
        trace.publish(self.cluster, trace.fragment_doc(
            name, "controllers", ep.episode, ep.decided_ts, now,
            hop=fedapi.episode_hop(pg) if pg is not None else 0,
            jobs=(ep.job_key,), labels={"kind": ep.kind},
            children=children))

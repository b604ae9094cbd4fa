"""Failover controller — slice lifecycle: detect → drain → reschedule
→ resume, with the whole loop instrumented.

A slice here is one NVLink domain (GPU_CLIQUE_LABEL), the unit an
NCCL gang spans; one Failed host (the agent's K-consecutive-ticks
verdict, agent/handlers.py GpuHealthHandler → SliceHealthReport,
api/slicehealth.py) takes the whole domain out of service.  Before this controller the pieces existed in isolation —
the agent cordoned its host, the job controller restarted on per-pod
failure policies, checkpoint.py could resume — but nothing connected
them, so a mid-training slice failure meant a cordoned node and a
wedged gang.  This reconciler closes the loop:

  declare     any resident host Failed ⇒ the SLICE is failed (its
              remaining hosts are suspect by construction: the NVLink
              domain is broken either way);
  quarantine  every host of the slice gets a flap-damping TTL
              annotation (NODE_QUARANTINED_UNTIL) — the scheduler's
              failover plugin filters quarantined hosts, so the
              requeued gang cannot land back on the sick slice, and a
              slice that "heals" seconds later still serves out the
              TTL before re-entering rotation;
  drain       each resident gang is drained with ONE job-level
              RestartJob command (the job controller's existing
              restart machinery deletes every stale pod and
              re-materializes — no per-pod failure-policy cascade,
              which would race K pod failures through maxRetry), after
              stamping resume metadata: failover generation,
              checkpoint dir passthrough, and resume-step snapshotted
              from the workload's last-checkpoint-step annotation;
  reschedule  the scheduler re-places the requeued gang (failover
              plugin: allocation priority + quarantine filter + warm
              spares);
  resume      workers boot with VTP_RESUME_STEP/VTP_CHECKPOINT_DIR
              (torch plugin; the worker's bootstrap.ENV_RESUME_STEP
              and ENV_CHECKPOINT_DIR) and restore from the DCP
              checkpoint instead of recomputing from step 0.

Every phase transition is timed into the failover_* metric families
(detect/drain/reschedule/resume/MTTR) and surfaced as events +
`vtpctl failover`; bench.py --failover runs the chaos scenario on the
1k-host simulator and commits the p50/p95 breakdown.

State machine (docs/design/failover.md):

    Healthy -> Suspect -> Failed -> Quarantined --TTL+healthy--> Healthy

Reference analogues: Singularity's transparent preempt-and-resume
(arxiv 2202.07848) as the recovery primitive, and topology-aware
recovery placement (arxiv 2411.11560) — the requeued gang re-places
under the same topology constraints as initial placement.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

from volcano_tpu_torch.api.types import (
    GROUP_NAME_ANNOTATION,
    GPU_CLIQUE_LABEL,
    JobAction,
    JobPhase,
    TaskStatus,
)
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

DEFAULT_QUARANTINE_TTL_S = 300.0


class FailoverEpisode:
    """One slice failure being walked through drain → resume.  Kept
    in-memory for latency accounting; the durable decisions (resume
    metadata, quarantine TTL, requeued marker) live on the CRD
    objects, so a controller restart loses only the timing breakdown,
    never the recovery itself."""

    __slots__ = ("slice_name", "nodes", "job_keys", "pg_keys",
                 "declared_ts", "detect_s", "drain_ts", "resched_ts",
                 "resume_ts", "episode")

    def __init__(self, slice_name: str, nodes: List[str],
                 job_keys: List[str], pg_keys: List[str],
                 declared_ts: float, detect_s: float,
                 episode: str = ""):
        self.slice_name = slice_name
        self.nodes = list(nodes)
        self.job_keys = list(job_keys)
        self.pg_keys = list(pg_keys)
        self.declared_ts = declared_ts
        self.detect_s = detect_s
        self.drain_ts: Optional[float] = None
        self.resched_ts: Optional[float] = None
        self.resume_ts: Optional[float] = None
        # federated causal episode riding the drained gang(s), if any
        # (comma-joined when a slice carried several): recovery
        # fragments publish to the trace ring under it
        self.episode = episode


@register_controller("failover")
class FailoverController(Controller):
    name = "failover"

    def __init__(self, quarantine_ttl: float = DEFAULT_QUARANTINE_TTL_S,
                 now=time.time):
        self.quarantine_ttl = quarantine_ttl
        self.now = now
        self._episodes: Dict[str, FailoverEpisode] = {}

    # -- helpers -------------------------------------------------------

    def _slices(self) -> Dict[str, List]:
        """slice label -> [node] over the current mirror."""
        out: Dict[str, List] = {}
        for node in list(self.cluster.nodes.values()):
            sl = node.labels.get(GPU_CLIQUE_LABEL)
            if sl:
                out.setdefault(sl, []).append(node)
        return out

    def _host_verdict(self, node) -> str:
        from volcano_tpu_torch.api.slicehealth import (NODE_HEALTH_ANNOTATION,
                                                 VERDICT_HEALTHY)
        rep = getattr(self.cluster, "slicehealthreports", {}).get(
            node.name)
        if rep is not None:
            return rep.verdict
        # fall back to the store's folded annotation (a mirror that
        # bootstrapped after the report was compacted away still sees
        # the fold on the node object)
        return node.annotations.get(NODE_HEALTH_ANNOTATION,
                                    VERDICT_HEALTHY)

    def _quarantined_until(self, node) -> float:
        from volcano_tpu_torch.api.slicehealth import (
            NODE_QUARANTINED_UNTIL_ANNOTATION)
        try:
            return float(node.annotations.get(
                NODE_QUARANTINED_UNTIL_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            return 0.0

    def _resident(self, node_names) -> Dict[str, List]:
        """podgroup key -> pods occupying the given nodes."""
        names = set(node_names)
        out: Dict[str, List] = {}
        for pod in list(self.cluster.pods.values()):
            if pod.node_name in names and not pod.is_terminated():
                group = pod.annotations.get(GROUP_NAME_ANNOTATION)
                if group:
                    out.setdefault(f"{pod.namespace}/{group}",
                                   []).append(pod)
        return out

    # -- reconcile -----------------------------------------------------

    def sync(self) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api.slicehealth import VERDICT_FAILED
        now = self.now()
        slices = self._slices()
        quarantined = 0
        for slice_name, nodes in slices.items():
            until = max((self._quarantined_until(n) for n in nodes),
                        default=0.0)
            failed = [n for n in nodes
                      if self._host_verdict(n) == VERDICT_FAILED]
            if failed and until <= now:
                if until:
                    # still dead past the TTL: re-arm the quarantine
                    # WITHOUT re-declaring — one hardware death is one
                    # SliceFailed event / one failover, not one per
                    # TTL expiry (duplicate drains would churn an
                    # already-recovered gang's version forever)
                    self._stamp_quarantine(nodes, now)
                else:
                    self._declare_failed(slice_name, nodes, failed,
                                         now)
                quarantined += 1
            elif until > now:
                quarantined += 1
            elif until and not failed:
                # TTL served AND every host reports healthy again:
                # Quarantined -> Healthy
                self._lift_quarantine(slice_name, nodes)
        metrics.set_gauge("quarantined_slices", quarantined)
        self._progress_episodes(now)

    # -- declare + drain -----------------------------------------------

    def _stamp_quarantine(self, nodes, now: float) -> None:
        from volcano_tpu_torch.api.slicehealth import (
            NODE_QUARANTINED_UNTIL_ANNOTATION)
        for node in nodes:
            node.annotations[NODE_QUARANTINED_UNTIL_ANNOTATION] = \
                f"{now + self.quarantine_ttl:.3f}"
            self.cluster.put_object("node", node)

    def _declare_failed(self, slice_name: str, nodes, failed_nodes,
                        now: float) -> None:
        from volcano_tpu_torch import metrics
        # detection latency: first bad telemetry tick -> this declare
        first_bad = [r.first_bad_ts for r in
                     (getattr(self.cluster, "slicehealthreports", {})
                      .get(n.name) for n in failed_nodes)
                     if r is not None and r.first_bad_ts > 0]
        detect_s = max(0.0, now - min(first_bad)) if first_bad else 0.0
        log.warning("slice %s FAILED (%d/%d hosts): quarantining for "
                    "%gs", slice_name, len(failed_nodes), len(nodes),
                    self.quarantine_ttl)
        self.cluster.record_event(
            slice_name, "SliceFailed",
            f"{len(failed_nodes)}/{len(nodes)} hosts failed; "
            f"quarantined for {self.quarantine_ttl:g}s")
        metrics.inc("slice_failovers_total", slice=slice_name)
        metrics.observe("failover_detect_seconds", detect_s,
                        slice=slice_name)
        self._stamp_quarantine(nodes, now)

        resident = self._resident([n.name for n in nodes])
        job_keys, pg_keys = [], []
        drained_jobs = set()
        for pg_key, pods in resident.items():
            pg = self.cluster.podgroups.get(pg_key)
            job = self._job_for(pg_key, pods)
            if job is not None and job.key not in drained_jobs:
                drained_jobs.add(job.key)
                self._drain_job(job, pg, slice_name)
                job_keys.append(job.key)
            elif job is None and pg is not None:
                # bare podgroup (no vcjob owner): gang-evict directly —
                # still one decision for the whole gang
                self._stamp_podgroup(pg, self._last_step(None, pg))
                for pod in pods:
                    self.cluster.evict_pod(pod.namespace, pod.name,
                                           f"slice {slice_name} failed")
            if pg is not None:
                pg_keys.append(pg_key)
        if job_keys or pg_keys:
            # nothing resident = nothing to walk through drain/resume
            # (the quarantine alone is the whole recovery)
            from volcano_tpu_torch import trace
            from volcano_tpu_torch.api import federation as fedapi
            episode = trace.episode_label(
                fedapi.episode_of(self.cluster.podgroups.get(k))
                for k in pg_keys)
            self._episodes[slice_name] = FailoverEpisode(
                slice_name, [n.name for n in nodes], job_keys,
                pg_keys, now, detect_s, episode=episode)

    def _job_for(self, pg_key: str, pods):
        job = self.cluster.vcjobs.get(pg_key)
        if job is not None:
            return job
        owners = {p.owner for p in pods if p.owner}
        for job in self.cluster.vcjobs.values():
            if job.uid in owners:
                return job
        return None

    @staticmethod
    def _last_step(job, pg) -> Optional[int]:
        from volcano_tpu_torch.api.slicehealth import LAST_STEP_ANNOTATION
        for obj in (pg, job):
            raw = obj.annotations.get(LAST_STEP_ANNOTATION) \
                if obj is not None else None
            if raw is not None:
                try:
                    return int(raw)
                except (TypeError, ValueError):
                    pass
        return None

    def _stamp_podgroup(self, pg, last_step: Optional[int]) -> None:
        from volcano_tpu_torch.api.slicehealth import (
            FAILOVER_GENERATION_ANNOTATION, REQUEUED_ANNOTATION,
            RESUME_STEP_ANNOTATION)
        gen = int(pg.annotations.get(FAILOVER_GENERATION_ANNOTATION,
                                     0) or 0) + 1
        pg.annotations[FAILOVER_GENERATION_ANNOTATION] = str(gen)
        pg.annotations[REQUEUED_ANNOTATION] = "true"
        if last_step is not None:
            try:
                stamped = int(pg.annotations.get(
                    RESUME_STEP_ANNOTATION, ""))
            except (TypeError, ValueError):
                stamped = None
            # floor-guard: never rewind a step a racing resize stamped
            pg.annotations[RESUME_STEP_ANNOTATION] = \
                str(max(last_step, stamped)
                    if stamped is not None else last_step)
        self.cluster.update_podgroup_status(pg)

    def _drain_job(self, job, pg, slice_name: str) -> None:
        """ONE job-level drain decision: stamp resume metadata, then
        delegate the actual teardown/rebuild to the job controller's
        RestartJob machinery (version bump deletes every stale pod —
        no per-pod PodFailed policy cascade, no maxRetry burn)."""
        from volcano_tpu_torch.api.slicehealth import (
            CHECKPOINT_DIR_ANNOTATION, FAILOVER_GENERATION_ANNOTATION,
            RESUME_STEP_ANNOTATION)
        last_step = self._last_step(job, pg)
        gen = int(job.annotations.get(FAILOVER_GENERATION_ANNOTATION,
                                      0) or 0) + 1
        job.annotations[FAILOVER_GENERATION_ANNOTATION] = str(gen)
        if last_step is not None:
            # floor-guard: an elastic resize racing this drain may
            # already have stamped a resume step — never rewind it
            try:
                stamped = int(job.annotations.get(
                    RESUME_STEP_ANNOTATION, ""))
            except (TypeError, ValueError):
                stamped = None
            if stamped is not None and stamped > last_step:
                last_step = stamped
            job.annotations[RESUME_STEP_ANNOTATION] = str(last_step)
        if pg is not None:
            # keep the podgroup's copy in lockstep (vtpctl failover and
            # the scheduler's requeued-priority read the podgroup)
            if CHECKPOINT_DIR_ANNOTATION in job.annotations:
                pg.annotations[CHECKPOINT_DIR_ANNOTATION] = \
                    job.annotations[CHECKPOINT_DIR_ANNOTATION]
            self._stamp_podgroup(pg, last_step)
        self.cluster.update_vcjob(job)
        self.cluster.record_event(
            job.key, "FailoverDrain",
            f"slice {slice_name} failed: restarting gang "
            f"(generation {gen}, resume step "
            f"{last_step if last_step is not None else 'none'})")
        if job.phase is JobPhase.RESTARTING:
            # a drain is already in flight (elastic resize or policy
            # restart racing this failure): the version bump it issued
            # tears down every stale pod, and the quarantine stamped
            # above keeps the re-place off the sick slice — a second
            # RestartJob would only double-churn the gang
            log.info("job %s already RESTARTING: failover adopts the "
                     "in-flight drain", job.key)
            return
        self.cluster.add_command(job.key, JobAction.RESTART_JOB.value)

    # -- episode progression (drain -> reschedule -> resume) -----------

    def _progress_episodes(self, now: float) -> None:
        from volcano_tpu_torch import metrics
        for ep in list(self._episodes.values()):
            if self._abandoned(ep):
                # the drained work will never reach RUNNING again
                # (user abort, maxRetry elsewhere, deletion): retire
                # the episode instead of scanning pods forever —
                # recovery did not happen, so no MTTR is recorded
                self.cluster.record_event(
                    ep.slice_name, "FailoverAbandoned",
                    f"gang(s) {','.join(ep.pg_keys) or '-'} ended "
                    f"without resuming")
                del self._episodes[ep.slice_name]
                continue
            if ep.drain_ts is None and self._drained(ep):
                ep.drain_ts = now
                metrics.observe("failover_drain_seconds",
                                now - ep.declared_ts,
                                slice=ep.slice_name)
            if ep.drain_ts is not None and ep.resched_ts is None \
                    and self._rescheduled(ep):
                ep.resched_ts = now
                metrics.observe("failover_reschedule_seconds",
                                now - ep.drain_ts, slice=ep.slice_name)
            if ep.resched_ts is not None and ep.resume_ts is None \
                    and self._resumed(ep):
                ep.resume_ts = now
                self._complete(ep, now)

    def _abandoned(self, ep: FailoverEpisode) -> bool:
        """True when nothing the episode drained can ever resume: the
        drained jobs are all gone or terminal (bare podgroups: all
        deleted)."""
        from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES
        if ep.job_keys:
            return all(
                (j := self.cluster.vcjobs.get(k)) is None
                or j.phase in FINISHED_JOB_PHASES
                for k in ep.job_keys)
        return all(self.cluster.podgroups.get(k) is None
                   for k in ep.pg_keys)

    def _drained(self, ep: FailoverEpisode) -> bool:
        names = set(ep.nodes)
        keys = set(ep.pg_keys)
        for pod in self.cluster.pods.values():
            if pod.node_name in names and not pod.is_terminated() \
                    and f"{pod.namespace}/" \
                    f"{pod.annotations.get(GROUP_NAME_ANNOTATION)}" \
                    in keys:
                return False
        return True

    def _gang_pods(self, pg_key: str):
        ns, _, name = pg_key.partition("/")
        return [p for p in self.cluster.pods.values()
                if p.namespace == ns
                and p.annotations.get(GROUP_NAME_ANNOTATION) == name]

    def _rescheduled(self, ep: FailoverEpisode) -> bool:
        """Every drained gang has its floor's worth of pods placed
        again — and none of them on the quarantined slice."""
        names = set(ep.nodes)
        for pg_key in ep.pg_keys:
            pg = self.cluster.podgroups.get(pg_key)
            if pg is None:
                continue
            placed = [p for p in self._gang_pods(pg_key)
                      if p.node_name and p.phase in (
                          TaskStatus.BOUND, TaskStatus.RUNNING)]
            if any(p.node_name in names for p in placed):
                return False
            if len(placed) < max(1, pg.min_member):
                return False
        return True

    def _resumed(self, ep: FailoverEpisode) -> bool:
        for key in ep.job_keys:
            job = self.cluster.vcjobs.get(key)
            if job is not None and job.phase is not JobPhase.RUNNING:
                return False
        for pg_key in ep.pg_keys:
            pg = self.cluster.podgroups.get(pg_key)
            if pg is None:
                continue
            running = sum(1 for p in self._gang_pods(pg_key)
                          if p.phase is TaskStatus.RUNNING)
            if running < max(1, pg.min_member):
                return False
        return True

    def _complete(self, ep: FailoverEpisode, now: float) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.api.slicehealth import (REQUEUED_ANNOTATION,
                                                 RESUME_STEP_ANNOTATION)
        mttr = now - ep.declared_ts + ep.detect_s
        metrics.observe("failover_resume_seconds", now - ep.resched_ts,
                        slice=ep.slice_name)
        metrics.observe("failover_mttr_seconds", mttr,
                        slice=ep.slice_name)
        for pg_key in ep.pg_keys:
            pg = self.cluster.podgroups.get(pg_key)
            if pg is None:
                continue
            # resume step gap: how far past the stamped resume point
            # the workload has already re-checkpointed by resume time
            # (0 = resumed exactly at the checkpoint; the recompute
            # window a tighter checkpoint cadence would shrink)
            last = self._last_step(None, pg)
            try:
                stamped = int(pg.annotations.get(
                    RESUME_STEP_ANNOTATION, ""))
            except (TypeError, ValueError):
                stamped = None
            if last is not None and stamped is not None:
                metrics.observe("failover_resume_step_gap",
                                max(0, last - stamped),
                                slice=ep.slice_name)
            if pg.annotations.pop(REQUEUED_ANNOTATION, None):
                self.cluster.update_podgroup_status(pg)
        self.cluster.record_event(
            ep.slice_name, "FailoverComplete",
            f"gang(s) {','.join(ep.pg_keys) or '-'} resumed; MTTR "
            f"{mttr:.3f}s (detect {ep.detect_s:.3f}s)")
        if ep.episode:
            # this plane's recovery slice of a federated causal
            # episode (one fragment per episode riding the slice)
            from volcano_tpu_torch import trace
            children = [("detect", ep.declared_ts - ep.detect_s,
                         ep.declared_ts)]
            if ep.drain_ts is not None:
                children.append(("drain", ep.declared_ts, ep.drain_ts))
            if ep.drain_ts is not None and ep.resched_ts is not None:
                children.append(("reschedule", ep.drain_ts,
                                 ep.resched_ts))
                children.append(("resume", ep.resched_ts, now))
            for one in ep.episode.split(","):
                trace.publish(self.cluster, trace.fragment_doc(
                    "failover-recovery", "controllers", one,
                    ep.declared_ts - ep.detect_s, now,
                    jobs=tuple(ep.job_keys),
                    labels={"slice": ep.slice_name},
                    children=children))
        del self._episodes[ep.slice_name]

    # -- quarantine lifecycle ------------------------------------------

    def _lift_quarantine(self, slice_name: str, nodes) -> None:
        from volcano_tpu_torch.api.slicehealth import (
            NODE_QUARANTINED_UNTIL_ANNOTATION)
        for node in nodes:
            if node.annotations.pop(NODE_QUARANTINED_UNTIL_ANNOTATION,
                                    None) is not None:
                self.cluster.put_object("node", node)
        self.cluster.record_event(
            slice_name, "SliceRecovered",
            "quarantine TTL served and all hosts healthy; slice back "
            "in rotation")
        log.info("slice %s recovered: quarantine lifted", slice_name)

"""Flush dirty PodGroup statuses at session close.

Reference parity: pkg/scheduler/framework/job_updater.go +
PodGroupOldState diffing (session.go:77-79).
"""

from __future__ import annotations

import json

from volcano_tpu_torch import trace
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus

# Pods may be created gated on queue admission; the gate manager lifts
# this gate once their PodGroup leaves Pending (reference:
# gate.SchGateManager, scheduler.go:101-108 + allocate.go:749-765,
# feature gate SchedulingGatesQueueAdmission).
QUEUE_ADMISSION_GATE = "volcano-tpu.io/queue-admission"


def _scoped_jobs(ssn):
    """Jobs a close-session publisher must examine.  On a delta-
    tracked cache only jobs rebuilt this snapshot or touched this
    session can need (re)publication: every gang-blocked job has
    in-flight tasks, is therefore non-steady, and rebuilds into the
    delta's changed set each cycle — while a steady job provably kept
    whatever it published when it last changed.  Bare sessions and
    full rebuilds walk everything (restart safety: a fresh process's
    first snapshot is full, so stale annotations from a previous
    incarnation still get cleared)."""
    cache = getattr(ssn, "cache", None)
    delta = getattr(cache, "last_delta", None)
    if delta is None or delta.full or \
            delta.gen != getattr(ssn, "snapshot_gen", None):
        # no delta, a full rebuild, or a delta describing a NEWER
        # snapshot than this session's (the cache snapshotted again
        # underneath us — harness pattern): walk everything
        return list(ssn.jobs.values())
    keys = set(delta.changed_jobs)
    keys.update(ssn.touched_jobs)
    keys.update(ssn.dirty_jobs)
    jobs = ssn.jobs
    return [jobs[k] for k in keys if k in jobs]


def remove_admission_gates(ssn) -> int:
    """Lift the queue-admission scheduling gate from pods of admitted
    podgroups (async in the reference; session-close here)."""
    removed = 0
    for job in _scoped_jobs(ssn):
        pg = job.podgroup
        if pg is None or pg.phase is PodGroupPhase.PENDING:
            continue
        for task in job.tasks.values():
            gates = task.pod.scheduling_gates
            if QUEUE_ADMISSION_GATE in gates:
                gates.remove(QUEUE_ADMISSION_GATE)
                # persist: the gate patch must cross the wire boundary
                # (reference: SchGateManager PATCHes the pod)
                ssn.cache.cluster.put_object("pod", task.pod)
                removed += 1
    return removed


# per-pod scheduling reason (reference docs/design/scheduling-reason.md:
# pod.status.conditions["PodScheduled"] reasons; autoscalers key on
# "Unschedulable" specifically)
SCHEDULING_REASON_ANNOTATION = "volcano-tpu.io/scheduling-reason"
REASON_UNSCHEDULABLE = "Unschedulable"
REASON_SCHEDULABLE = "Schedulable"


def publish_scheduling_reasons(ssn) -> int:
    """Per-POD scheduling reasons for gang-blocked jobs (reference
    docs/design/scheduling-reason.md): users (and autoscalers) must
    see WHICH task breaks the cycle and why — the tasks that fit get
    `Schedulable` ("can be scheduled, waiting for the gang"), the
    blockers get `Unschedulable` with the per-node fit-error
    histogram.  Written only on change: the message stabilizes after
    one session, so steady pending jobs cost no wire traffic."""
    published = 0
    blocked_keys = []
    for job in _scoped_jobs(ssn):
        pg = job.podgroup
        gang_blocked = (pg is not None
                        and pg.phase in (PodGroupPhase.PENDING,
                                         PodGroupPhase.INQUEUE)
                        and (job.fit_errors or job.job_fit_errors))
        if not gang_blocked:
            # aggregate unschedulable reasons cleared with the same
            # placed-only discipline as the per-pod reasons below —
            # a merely-skipped job keeps its last published aggregate
            if pg is not None and \
                    trace.PENDING_REASONS_ANNOTATION in pg.annotations \
                    and not job.tasks_in_status(TaskStatus.PENDING):
                del pg.annotations[trace.PENDING_REASONS_ANNOTATION]
                trace.clear_pending(job.key)
                ssn.cache.update_podgroup_status(pg)
                published += 1
            # CLEAR stale reasons — but only from tasks that actually
            # PLACED: fit errors rebuild empty every snapshot, so a
            # job merely skipped this session (queue overused, FIFO-
            # blocked, not yet admitted) has no errors while its pods
            # still pend; blanking those would drop the autoscaler's
            # scale-up signal and churn publish/clear on alternating
            # cycles
            for task in job.tasks.values():
                if task.status is TaskStatus.PENDING:
                    continue
                pod = task.pod
                if SCHEDULING_REASON_ANNOTATION in pod.annotations:
                    del pod.annotations[SCHEDULING_REASON_ANNOTATION]
                    pod.status_message = ""
                    ssn.cache.cluster.put_object("pod", pod)
                    published += 1
            continue
        # aggregated unschedulable reasons (trace.py): fit-error text
        # normalized to the bounded enum, counted by DISTINCT node,
        # published on the podgroup so `vtpctl explain` answers "why
        # is this gang pending" from any mirror.  Written on change
        # only, same wire discipline as the per-pod reasons.
        blocked_keys.append(job.key)
        counts, samples = trace.aggregate_job_reasons(job)
        if not counts:
            # condition-only blocks (e.g. topology_alloc's no-domain
            # verdict) still deserve an aggregate
            for cond in pg.conditions:
                if cond.type == "Unschedulable" and cond.message:
                    slug = trace.normalize_reason(cond.message)
                    counts[slug] = counts.get(slug, 0) + 1
                    samples.setdefault(slug, cond.message)
        doc = trace.note_pending(job.key, counts, samples)
        payload = json.dumps(doc, sort_keys=True)
        if pg.annotations.get(trace.PENDING_REASONS_ANNOTATION) != \
                payload:
            pg.annotations[trace.PENDING_REASONS_ANNOTATION] = payload
            ssn.cache.update_podgroup_status(pg)
            published += 1
        pending = list(job.tasks_in_status(TaskStatus.PENDING))
        blocked = sum(1 for t in pending
                      if t.uid in job.fit_errors)
        for task in pending:
            errs = job.fit_errors.get(task.uid)
            if errs is not None:
                reason, message = REASON_UNSCHEDULABLE, errs.error()
            else:
                reason = REASON_SCHEDULABLE
                message = (f"pod can be scheduled, but the gang is "
                           f"not ready: {blocked} of {len(pending)} "
                           f"pending task(s) unschedulable "
                           f"(minAvailable={job.min_available})")
            pod = task.pod
            if pod.annotations.get(SCHEDULING_REASON_ANNOTATION) == \
                    reason and pod.status_message == message:
                continue
            pod.annotations[SCHEDULING_REASON_ANNOTATION] = reason
            pod.status_message = message
            ssn.cache.cluster.put_object("pod", pod)
            published += 1
        # tasks of a still-blocked job that DID place (pipelined /
        # partially bound) must not keep a stale pending-time reason
        pending_uids = {t.uid for t in pending}
        for task in job.tasks.values():
            if task.uid in pending_uids:
                continue
            pod = task.pod
            if SCHEDULING_REASON_ANNOTATION in pod.annotations:
                del pod.annotations[SCHEDULING_REASON_ANNOTATION]
                pod.status_message = ""
                ssn.cache.cluster.put_object("pod", pod)
                published += 1
    # the in-process aggregate mirrors THIS session's blocked set (a
    # deleted job must not haunt the dumper / trace payloads)
    trace.retain_pending(blocked_keys)
    return published


def update_job_statuses(ssn) -> int:
    """Recompute + push PodGroup status for jobs dirtied this session."""
    updated = 0
    for uid in ssn.dirty_jobs:
        job = ssn.jobs.get(uid)
        if job is None or job.podgroup is None:
            continue
        pg = job.podgroup
        pg.running = len(job.task_status_index.get(TaskStatus.RUNNING, {})) + \
            len(job.task_status_index.get(TaskStatus.BOUND, {})) + \
            len(job.task_status_index.get(TaskStatus.BINDING, {}))
        pg.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
        pg.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))

        new_phase = _next_phase(job, pg)
        pg.phase = new_phase
        ssn.cache.update_podgroup_status(pg)
        updated += 1
    return updated


def _next_phase(job, pg) -> PodGroupPhase:
    total = len(job.tasks)
    if total and pg.succeeded >= (job.min_available if job.min_available else total) \
            and pg.running == 0 and not job.tasks_in_status(TaskStatus.PENDING):
        return PodGroupPhase.COMPLETED
    if pg.phase in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING,
                    PodGroupPhase.UNKNOWN):
        if job.ready_task_num() >= job.min_available:
            return PodGroupPhase.RUNNING
        if pg.phase is PodGroupPhase.RUNNING and pg.running < job.min_available:
            # gang broken under a running group
            return PodGroupPhase.UNKNOWN
    return pg.phase

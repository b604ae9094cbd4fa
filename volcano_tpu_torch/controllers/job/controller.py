"""Job controller — vcjob -> PodGroup + pods, 8-phase state machine.

Reference parity: pkg/controllers/job (state machine state/factory.go:
87-110; syncJob pod materialization job_controller_actions.go:348;
killJob :68; lifecycle policies job_controller.go:415-542).  Rebuilt
reconciler-style: each sync pass materializes desired pods, folds pod
status into the job phase, and applies lifecycle policies to observed
pod failures.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List

from volcano_tpu_torch.api.pod import Pod
from volcano_tpu_torch.api.podgroup import (NetworkTopologySpec, PodGroup,
                                      SubGroupPolicy)
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (
    FINISHED_JOB_PHASES,
    GROUP_NAME_ANNOTATION,
    JOB_NAME_LABEL,
    SUBGROUP_LABEL,
    TASK_INDEX_LABEL,
    TASK_SPEC_LABEL,
    JobAction,
    JobEvent,
    JobPhase,
    NetworkTopologyMode,
    PodGroupPhase,
    TaskStatus,
)
from volcano_tpu_torch.api.vcjob import VCJob
from volcano_tpu_torch.controllers.framework import Controller, register_controller
from volcano_tpu_torch.controllers.job.plugins import get_job_plugin

log = logging.getLogger(__name__)

VERSION_LABEL = "volcano-tpu.io/job-version"

TERMINAL_PHASES = FINISHED_JOB_PHASES


@register_controller("job")
class JobController(Controller):
    name = "job"

    def sync(self) -> None:
        snap = self.cluster.list_all()
        pods_by_job: Dict[str, List[Pod]] = defaultdict(list)
        for pod in snap.pods:
            if pod.owner:
                pods_by_job[pod.owner].append(pod)
        for job in snap.vcjobs:
            try:
                self.sync_job(job, pods_by_job.get(job.uid, []))
            except Exception:  # noqa: BLE001
                log.exception("sync of job %s failed", job.key)

    def on_event(self, kind: str, obj):
        if kind == "vcjob_deleted":
            self._on_job_delete(obj)

    @staticmethod
    def _count(pods: List[Pod]) -> Dict[TaskStatus, int]:
        counts: Dict[TaskStatus, int] = defaultdict(int)
        for p in pods:
            counts[p.phase] += 1
        return counts

    # -- reconcile ----------------------------------------------------

    def sync_job(self, job: VCJob, pods: List[Pod]) -> None:
        self._apply_commands(job)
        if job.phase in TERMINAL_PHASES:
            return

        if not self._ensure_podgroup(job):
            return
        self._run_job_add_plugins(job)

        # fold observed pod state
        counts = self._count(pods)
        job.pending = counts[TaskStatus.PENDING] + counts[TaskStatus.BOUND] \
            + counts[TaskStatus.BINDING]
        job.running = counts[TaskStatus.RUNNING]
        job.succeeded = counts[TaskStatus.SUCCEEDED]
        job.failed = counts[TaskStatus.FAILED]
        job.terminating = counts[TaskStatus.RELEASING]

        # lifecycle policies react to failures before materialization
        if job.phase in (JobPhase.PENDING, JobPhase.RUNNING):
            for pod in pods:
                if pod.phase is TaskStatus.FAILED and \
                        not pod.annotations.get("vc-policy-handled"):
                    pod.annotations["vc-policy-handled"] = "true"
                    # persist the handled marker: after a controller
                    # restart (or over the wire) the policy must not
                    # fire a second time for the same failure
                    self.cluster.put_object("pod", pod)
                    self._apply_policy(job, pod, JobEvent.POD_FAILED)
                    if job.phase in TERMINAL_PHASES or \
                            job.phase is JobPhase.RESTARTING:
                        break

        handler = {
            JobPhase.PENDING: self._sync_active,
            JobPhase.RUNNING: self._sync_active,
            JobPhase.RESTARTING: self._sync_restarting,
            JobPhase.COMPLETING: self._sync_completing,
            JobPhase.TERMINATING: self._sync_terminating,
            JobPhase.ABORTING: self._sync_aborting,
        }.get(job.phase)
        if handler:
            handler(job, pods)
        self.cluster.update_vcjob(job)

    def _sync_active(self, job: VCJob, pods: List[Pod]) -> None:
        self._materialize_pods(job, pods)

        min_success = job.min_success or job.total_replicas()
        alive = job.pending + job.running + job.terminating
        if job.succeeded >= min_success:
            self._transition(job, JobPhase.COMPLETING,
                             f"{job.succeeded} tasks succeeded")
            self._sync_completing(job, pods)
            return
        if alive == 0 and job.failed > 0 and \
                job.succeeded + job.failed >= job.total_replicas():
            self._transition(job, JobPhase.FAILED,
                             f"{job.failed} tasks failed")
            return
        if job.phase is JobPhase.PENDING and \
                job.running >= job.min_available:
            self._transition(job, JobPhase.RUNNING, "min available running")

    def _sync_restarting(self, job: VCJob, pods: List[Pod]) -> None:
        # delete every pod of the previous version, then start over
        stale = [p for p in pods
                 if p.labels.get(VERSION_LABEL) != str(job.version)]
        for pod in stale:
            self.cluster.delete_pod(pod.key)
        if not stale:
            self._transition(job, JobPhase.PENDING,
                             f"restarted (attempt {job.retry_count})")
            pg = self.cluster.podgroups.get(f"{job.namespace}/{job.name}")
            if pg is not None:
                pg.phase = PodGroupPhase.PENDING
                self.cluster.update_podgroup_status(pg)
            # materialize the new version NOW, not next sync: a
            # drained gang with no pods yet cannot claim its requeued
            # priority, so waiting a round lets any pending job steal
            # the capacity the drain just freed (failover/elastic
            # re-placement would lose its fast lane)
            self._materialize_pods(job, [])

    def _sync_completing(self, job: VCJob, pods: List[Pod]) -> None:
        remaining = [p for p in pods if not p.is_terminated()]
        for pod in remaining:
            self.cluster.delete_pod(pod.key)
        if not remaining:
            self._transition(job, JobPhase.COMPLETED, "job completed")
            job.finish_time = time.time()

    def _sync_terminating(self, job: VCJob, pods: List[Pod]) -> None:
        remaining = [p for p in pods if not p.is_terminated()]
        for pod in remaining:
            self.cluster.delete_pod(pod.key)
        if not remaining:
            self._transition(job, JobPhase.FAILED, "job terminated")
            job.finish_time = time.time()

    def _sync_aborting(self, job: VCJob, pods: List[Pod]) -> None:
        # abort retains nothing (state/factory.go retain-phase sets)
        for pod in pods:
            self.cluster.delete_pod(pod.key)
        if not pods:
            self._transition(job, JobPhase.ABORTED, "job aborted")
            job.finish_time = time.time()

    # -- materialization ----------------------------------------------

    def _ensure_podgroup(self, job: VCJob) -> bool:
        """Create the job's podgroup if it has none; False when the job
        was deleted since this sync's snapshot (the watch drops a job
        before its podgroup, so one made here would outlive the job
        without the holds its old podgroup carried)."""
        key = f"{job.namespace}/{job.name}"
        if key in self.cluster.podgroups:
            return True
        if job.key not in self.cluster.vcjobs:
            return False
        sub_groups = []
        seen = set()
        for spec in job.tasks:
            if spec.subgroup and spec.subgroup not in seen:
                seen.add(spec.subgroup)
                sub_groups.append(SubGroupPolicy(
                    name=spec.subgroup,
                    min_member=spec.min_available or spec.replicas,
                    network_topology=self._subgroup_topology(job,
                                                             spec.subgroup)))
        pg = PodGroup(
            name=job.name, namespace=job.namespace,
            # podgroup inherits the job's annotations (reference
            # pg_controller_handler.go:301 inherit-upward; carries e.g.
            # the hyperjob forward-domain pin)
            annotations=dict(job.annotations),
            min_member=job.min_available,
            min_task_member={t.name: t.min_available for t in job.tasks
                             if t.min_available is not None},
            queue=job.queue,
            priority_class=job.priority_class,
            network_topology=job.network_topology,
            sub_group_policies=sub_groups,
        )
        self.cluster.add_podgroup(pg)
        job.controlled_resources["podgroup"] = pg.key
        return True

    @staticmethod
    def _subgroup_topology(job: VCJob, subgroup: str):
        """Topology constraint for one subgroup gang.

        Explicit task-level networkTopology wins.  Otherwise a subgroup
        whose tasks request GPUs defaults to NVLink-local hard
        placement with no tier cap: each replica-gang lands in the
        smallest hypernode domain (one NVLink domain when it fits),
        which is what a multi-domain data-parallel job wants
        (subGroupPolicy + networkTopology, scheduling/v1beta1
        types.go:217-223; the reference leaves nil unconstrained — a
        deliberate divergence)."""
        wants_gpu = False
        for spec in job.tasks:
            if spec.subgroup != subgroup:
                continue
            if spec.network_topology is not None:
                return spec.network_topology
            if spec.template_pod().resource_requests().get(GPU):
                wants_gpu = True
        # the default must never shadow an explicit job-level
        # constraint (subgroups fall back to it at allocation time)
        if wants_gpu and job.network_topology is None:
            return NetworkTopologySpec(mode=NetworkTopologyMode.HARD,
                                       highest_tier_allowed=None)
        return None

    def _run_job_add_plugins(self, job: VCJob) -> None:
        if job.controlled_resources.get("plugins-applied"):
            return
        for name, args in job.plugins.items():
            plugin = get_job_plugin(name, args)
            if plugin is None:
                log.warning("job %s references unknown plugin %s",
                            job.key, name)
                continue
            plugin.on_job_add(job, self.cluster)
        job.controlled_resources["plugins-applied"] = "true"

    @staticmethod
    def _task_ready_counts(job: VCJob, pods: List[Pod]) -> Dict[str, int]:
        counts: Dict[str, int] = defaultdict(int)
        for p in pods:
            if p.phase in (TaskStatus.RUNNING, TaskStatus.SUCCEEDED):
                counts[p.task_spec] += 1
        return counts

    def _task_unblocked(self, job: VCJob, spec,
                        ready: Dict[str, int]) -> bool:
        """tasks[].dependsOn gates materialization (reference
        waitDependsOnTaskMeetCondition): a TARGET is satisfied once its
        running/succeeded count reaches its own minAvailable (default:
        replicas); iteration picks across the name LIST — 'any' needs
        one satisfied target (OR), 'all' needs every one (AND)."""
        if spec.depends_on is None or not spec.depends_on.name:
            return True

        def target_ok(target_name: str) -> bool:
            target = job.task_by_name(target_name)
            if target is None:
                return True  # webhook validates; be lenient at runtime
            need = (target.min_available
                    if target.min_available is not None
                    else target.replicas)
            return ready.get(target_name, 0) >= need

        targets = spec.depends_on.name
        if spec.depends_on.iteration == "all":
            return all(target_ok(n) for n in targets)
        return any(target_ok(n) for n in targets)

    def _materialize_pods(self, job: VCJob, pods: List[Pod]) -> None:
        existing = {p.name: p for p in pods}
        desired = {}
        creatable = set()
        ready_counts = self._task_ready_counts(job, pods)
        for spec in job.tasks:
            # dependsOn gates CREATION only — a dependency degrading
            # later must never delete already-started dependents
            unblocked = self._task_unblocked(job, spec, ready_counts)
            for i in range(spec.replicas):
                name = f"{job.name}-{spec.name}-{i}"
                desired[name] = (spec, i)
                if unblocked:
                    creatable.add(name)

        # scale down: delete pods not desired anymore
        for name, pod in existing.items():
            if name not in desired and not pod.is_terminated():
                self.cluster.delete_pod(pod.key)

        # plugin instances are per-job, not per-pod: constructing (and
        # re-parsing arguments) once keeps a 256-replica materialization
        # linear
        plugins = [p for p in (get_job_plugin(n, a)
                               for n, a in job.plugins.items())
                   if p is not None]
        for name, (spec, index) in desired.items():
            if name in existing or name not in creatable:
                continue
            self.cluster.add_pod(
                self._build_pod(job, spec, index, name, plugins))

    def _build_pod(self, job: VCJob, spec, index: int, name: str,
                   plugins) -> Pod:
        template = spec.template_pod()
        pod = template.clone()
        pod.name = name
        pod.namespace = job.namespace
        from volcano_tpu_torch.api.pod import new_uid
        pod.uid = new_uid()
        pod.owner = job.uid
        pod.task_spec = spec.name
        pod.task_index = index
        pod.scheduler_name = job.scheduler_name
        pod.phase = TaskStatus.PENDING
        pod.node_name = ""
        pod.annotations[GROUP_NAME_ANNOTATION] = job.name
        # federated causal episode: the router's regional copy carries
        # the episode ID + hop; pods inherit both so the "running pod"
        # end of the episode is annotated like every other hop
        from volcano_tpu_torch.api import federation as fedapi
        for ann in (fedapi.FED_EPISODE_ANNOTATION,
                    fedapi.FED_EPISODE_HOP_ANNOTATION):
            if job.annotations.get(ann):
                pod.annotations[ann] = job.annotations[ann]
        from volcano_tpu_torch import features
        if features.enabled("SchedulingGatesQueueAdmission"):
            # pods start gated; the scheduler lifts the gate once the
            # podgroup's queue admits it (job_updater.py; reference
            # feature gate of the same name)
            from volcano_tpu_torch.framework.job_updater import (
                QUEUE_ADMISSION_GATE)
            if QUEUE_ADMISSION_GATE not in pod.scheduling_gates:
                pod.scheduling_gates.append(QUEUE_ADMISSION_GATE)
        pod.labels[JOB_NAME_LABEL] = job.name
        pod.labels[TASK_SPEC_LABEL] = spec.name
        pod.labels[TASK_INDEX_LABEL] = str(index)
        pod.labels[VERSION_LABEL] = str(job.version)
        if spec.subgroup:
            pod.labels[SUBGROUP_LABEL] = spec.subgroup
        if job.priority_class:
            pod.priority_class = job.priority_class
        for plugin in plugins:
            plugin.on_pod_create(pod, job)
        return pod

    # -- command bus (bus/v1alpha1 delegated actions) ------------------

    def _apply_commands(self, job: VCJob) -> None:
        for cmd in self.cluster.drain_commands(job.key):
            action = cmd["action"]
            log.info("job %s: command %s", job.key, action)
            if action == JobAction.ABORT_JOB.value and \
                    job.phase not in TERMINAL_PHASES:
                self._transition(job, JobPhase.ABORTING, "command: abort")
            elif action == JobAction.RESUME_JOB.value:
                if job.phase is JobPhase.ABORTING:
                    # abort still in flight: requeue, don't drop
                    self.cluster.add_command(job.key, action)
                elif job.phase is JobPhase.ABORTED:
                    job.version += 1
                    job.finish_time = None
                    self._transition(job, JobPhase.PENDING,
                                     "command: resume")
                    pg = self.cluster.podgroups.get(job.key)
                    if pg is not None:
                        pg.phase = PodGroupPhase.PENDING
                        self.cluster.update_podgroup_status(pg)
            elif action == JobAction.RESTART_JOB.value and \
                    job.phase not in TERMINAL_PHASES:
                job.version += 1
                self._transition(job, JobPhase.RESTARTING,
                                 "command: restart")
            elif action == JobAction.TERMINATE_JOB.value and \
                    job.phase not in TERMINAL_PHASES:
                self._transition(job, JobPhase.TERMINATING,
                                 "command: terminate")
            elif action == JobAction.COMPLETE_JOB.value and \
                    job.phase not in TERMINAL_PHASES:
                self._transition(job, JobPhase.COMPLETING,
                                 "command: complete")
            else:
                log.warning("job %s: command %s not applicable in phase "
                            "%s (dropped)", job.key, action,
                            job.phase.value)

    # -- lifecycle policies -------------------------------------------

    def _apply_policy(self, job: VCJob, pod: Pod, event: JobEvent) -> None:
        spec = job.task_by_name(pod.task_spec)
        policies = (spec.policies if spec and spec.policies
                    else job.policies)
        action = None
        for policy in policies:
            if policy.matches(event, exit_code=pod.exit_code):
                action = policy.action
                break
        if action is None:
            return
        log.info("job %s: pod %s %s -> %s", job.key, pod.name,
                 event.value, action.value)
        self.cluster.record_event(job.key, "PolicyTriggered",
                                  f"{pod.name} {event.value} -> {action.value}")
        if action is JobAction.RESTART_JOB:
            if job.retry_count >= job.max_retry:
                self._transition(job, JobPhase.FAILED,
                                 f"maxRetry ({job.max_retry}) exceeded")
                # terminal via policy: release every pod the job holds —
                # a dead 256-host gang must not pin its slice
                for p in list(self.cluster.pods.values()):
                    if p.owner == job.uid:
                        self.cluster.delete_pod(p.key)
                return
            job.retry_count += 1
            job.version += 1
            from volcano_tpu_torch import metrics
            metrics.inc("job_retry_counts",
                        job=f"{job.namespace}/{job.name}")
            self._transition(job, JobPhase.RESTARTING, "policy: restart")
        elif action in (JobAction.RESTART_TASK, JobAction.RESTART_POD):
            self.cluster.delete_pod(pod.key)
        elif action is JobAction.ABORT_JOB:
            self._transition(job, JobPhase.ABORTING, "policy: abort")
        elif action is JobAction.TERMINATE_JOB:
            self._transition(job, JobPhase.TERMINATING, "policy: terminate")
        elif action is JobAction.COMPLETE_JOB:
            self._transition(job, JobPhase.COMPLETING, "policy: complete")

    def _transition(self, job: VCJob, phase: JobPhase, message: str) -> None:
        if job.phase is phase:
            return
        log.debug("job %s: %s -> %s (%s)", job.key, job.phase.value,
                  phase.value, message)
        job.phase = phase
        job.state_message = message
        if phase in TERMINAL_PHASES and job.finish_time is None:
            job.finish_time = time.time()
        from volcano_tpu_torch.api.vcjob import JobCondition
        job.conditions.append(JobCondition(status=phase))
        self.cluster.update_vcjob(job)

    def _on_job_delete(self, job: VCJob) -> None:
        for name, args in job.plugins.items():
            plugin = get_job_plugin(name, args)
            if plugin is not None:
                plugin.on_job_delete(job, self.cluster)
        for pod in list(self.cluster.pods.values()):
            if pod.owner == job.uid:
                self.cluster.delete_pod(pod.key)
        self.cluster.delete_podgroup(f"{job.namespace}/{job.name}")

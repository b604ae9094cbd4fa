"""JobFlow + JobTemplate controllers — DAGs of vcjobs.

Reference parity: pkg/controllers/jobflow
(jobflow_controller_action.go:38,76,108 syncJobFlow deploys jobs whose
dependencies are Completed; states pending/running/succeed/failed) and
pkg/controllers/jobtemplate.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

from volcano_tpu_torch.api.jobflow import JobFlow, JobFlowPhase
from volcano_tpu_torch.api.types import JobPhase
from volcano_tpu_torch.api.vcjob import VCJob
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

# label stamped onto every job created from a JobTemplate
# (reference pkg/controllers/jobtemplate CreatedByJobTemplate)
CREATED_BY_TEMPLATE_LABEL = "volcano-tpu.io/created-by-template"


@register_controller("jobtemplate")
class JobTemplateController(Controller):
    """Reconcile JobTemplate status from the jobs stamped out of it.

    Reference parity: pkg/controllers/jobtemplate
    (jobtemplate_controller_action.go:30 syncJobTemplate — list jobs
    labelled created-by-template, publish their names as
    status.jobDependsOnList).
    """

    name = "jobtemplate"

    def sync(self) -> None:
        # invert once: template key -> [job names]
        by_template = {}
        for job in self.cluster.vcjobs.values():
            ref = job.labels.get(CREATED_BY_TEMPLATE_LABEL)
            if ref:
                by_template.setdefault(ref, []).append(job.name)
        for tmpl in list(self.cluster.jobtemplates.values()):
            want = sorted(by_template.get(
                f"{tmpl.namespace}.{tmpl.name}", []))
            if want != sorted(tmpl.job_depends_on_list):
                tmpl.job_depends_on_list = want
                self.cluster.put_object("jobtemplate", tmpl)


@register_controller("jobflow")
class JobFlowController(Controller):
    name = "jobflow"

    def initialize(self, cluster):
        super().initialize(cluster)
        # standalone stores for the flow CRDs (mapping views like the
        # rest of the Cluster surface)
        if not hasattr(cluster, "jobflows"):
            cluster.jobflows = {}
        if not hasattr(cluster, "jobtemplates"):
            cluster.jobtemplates = {}

    def sync(self) -> None:
        for flow in list(self.cluster.jobflows.values()):
            try:
                self.sync_flow(flow)
            except Exception:  # noqa: BLE001
                log.exception("jobflow %s sync failed", flow.key)

    def on_event(self, kind: str, obj) -> None:
        # flow deleted with retain policy "delete": reap the jobs it
        # stamped out (reference: ownerReference GC on flow deletion);
        # "retain" leaves them running, matching the reference default
        if kind != "jobflow_deleted":
            return
        flow = obj.get("obj") if isinstance(obj, dict) else obj
        reap_deleted_flow(self.cluster, flow)

    # -- reconcile ----------------------------------------------------

    def sync_flow(self, flow: JobFlow) -> None:
        if flow.phase in (JobFlowPhase.SUCCEED, JobFlowPhase.FAILED):
            return
        before = (flow.phase, len(flow.deployed_jobs))
        self._reconcile(flow)
        if (flow.phase, len(flow.deployed_jobs)) != before:
            # persist status — a wire-backed cluster won't see in-place
            # mutation of the mirror copy
            self.cluster.put_object("jobflow", flow)

    def _reconcile(self, flow: JobFlow) -> None:

        job_phases: Dict[str, Optional[JobPhase]] = {}
        for step in flow.flows:
            job = self.cluster.vcjobs.get(
                f"{flow.namespace}/{flow.job_name(step.name)}")
            job_phases[step.name] = job.phase if job else None

        deployed_any = False
        for step in flow.flows:
            if job_phases[step.name] is not None:
                continue  # already deployed
            if self._deps_satisfied(step, job_phases):
                deployed_any |= self._deploy(flow, step)

        phases = [p for p in job_phases.values()]
        if any(p is JobPhase.FAILED or p is JobPhase.ABORTED
               for p in phases):
            flow.phase = JobFlowPhase.FAILED
        elif all(p is JobPhase.COMPLETED for p in phases) and phases:
            flow.phase = JobFlowPhase.SUCCEED
            if flow.job_retain_policy == "delete":
                for step in flow.flows:
                    self.cluster.delete_vcjob(
                        f"{flow.namespace}/{flow.job_name(step.name)}")
        elif deployed_any or any(p is not None for p in phases):
            flow.phase = JobFlowPhase.RUNNING

    @staticmethod
    def _deps_satisfied(step, job_phases) -> bool:
        if step.depends_on is None:
            return True
        satisfying = set()
        for probe in step.depends_on.probes:
            phase = probe.get("phase")
            if not phase:
                continue
            try:
                satisfying.add(JobPhase(phase))
            except ValueError:
                log.warning("flow %s: unknown probe phase %r",
                            step.name, phase)
        if not satisfying:
            satisfying = {JobPhase.COMPLETED}
        if JobPhase.RUNNING in satisfying:
            # a dependency probed for Running is also satisfied once the
            # target already finished successfully
            satisfying.add(JobPhase.COMPLETED)
        return all(job_phases.get(d) in satisfying
                   for d in step.depends_on.targets)

    def _deploy(self, flow: JobFlow, step) -> bool:
        template = self.cluster.jobtemplates.get(
            f"{flow.namespace}/{step.name}")
        if template is None or template.job is None:
            log.warning("jobflow %s: missing template %s",
                        flow.key, step.name)
            return False
        job: VCJob = copy.deepcopy(template.job)
        job.name = flow.job_name(step.name)
        job.namespace = flow.namespace
        job.labels[CREATED_BY_TEMPLATE_LABEL] = \
            f"{template.namespace}.{template.name}"
        from volcano_tpu_torch.api.pod import new_uid
        job.uid = new_uid()
        for attr, value in (step.patch or {}).items():
            if hasattr(job, attr):
                setattr(job, attr, copy.deepcopy(value))
        self.cluster.add_vcjob(job)
        flow.deployed_jobs.append(job.key)
        log.info("jobflow %s deployed %s", flow.key, job.key)
        return True


def reap_deleted_flow(cluster, flow, run_job_cleanup: bool = False) -> None:
    """Delete the jobs a flow stamped out, per its retain policy.
    Called from the controller's watch handler (wire mode, where
    delete_vcjob's vcjob_deleted event routes pod/podgroup/plugin
    cleanup through JobController._on_job_delete) and from the CLI
    directly for in-memory clusters with run_job_cleanup=True, where
    no controller process is alive to see the event."""
    if flow is None or getattr(flow, "job_retain_policy",
                               "retain") != "delete":
        return
    job_ctrl = None
    if run_job_cleanup:
        from volcano_tpu_torch.controllers.job.controller import JobController
        job_ctrl = JobController()
        job_ctrl.initialize(cluster)
    for step in flow.flows:
        key = f"{flow.namespace}/{flow.job_name(step.name)}"
        job = cluster.vcjobs.get(key)
        if job is None:
            continue
        log.info("jobflow %s deleted: reaping stamped job %s",
                 flow.key, key)
        cluster.delete_vcjob(key)
        if job_ctrl is not None:
            # full delete path: plugin on_job_delete hooks + pods +
            # podgroup (controllers/job/controller.py _on_job_delete)
            job_ctrl.on_event("vcjob_deleted", job)
        else:
            # a co-resident JobController reacts to vcjob_deleted with
            # the same (idempotent) cleanup; do it inline too so pods
            # and podgroups never leak when the job controller is
            # disabled or feature-gated off
            cluster.delete_podgroup(key)
            for pod in list(cluster.pods.values()):
                if pod.owner == job.uid:
                    cluster.delete_pod(pod.key)

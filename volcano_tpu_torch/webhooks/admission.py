"""Admission chain: mutate then validate on object create.

Reference parity: pkg/webhooks (router/admission.go paths
/jobs/{validate,mutate}, /queues/..., /podgroups/..., /hypernodes/
validate).  Standalone equivalent: the cluster applies this chain on
create — a rejection raises AdmissionError before anything persists.
"""

from __future__ import annotations

import re

from volcano_tpu_torch.api.types import DEFAULT_QUEUE
from volcano_tpu_torch.api.vcjob import VCJob

DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
MAX_NAME_LEN = 63


class AdmissionError(ValueError):
    """Raised when a webhook rejects an object."""


# -- jobs -------------------------------------------------------------

def mutate_job(job: VCJob) -> VCJob:
    """Defaulting (reference admission/jobs/mutate): queue, task names,
    minAvailable, task minAvailable, scheduler name."""
    if not job.queue:
        job.queue = DEFAULT_QUEUE
    if not job.scheduler_name:
        job.scheduler_name = "volcano-tpu"
    for i, task in enumerate(job.tasks):
        if not task.name:
            task.name = f"task-{i}"
        if task.min_available is None:
            task.min_available = task.replicas
    if job.min_available <= 0:
        job.min_available = job.total_replicas()
    _mutate_mpi(job)
    _mutate_elastic(job)
    return job


def _mutate_elastic(job: VCJob) -> None:
    """Elastic defaulting: a job declaring min/max-slices starts at
    its floor unless it names a size — submit small, let the
    scheduler grow it into idle capacity (actions/elastic.py)."""
    from volcano_tpu_torch.api import elastic as eapi
    if not eapi.is_elastic(job):
        return
    ann = job.annotations
    if eapi.ELASTIC_SLICES_ANNOTATION not in ann:
        ann[eapi.ELASTIC_SLICES_ANNOTATION] = \
            ann[eapi.ELASTIC_MIN_SLICES_ANNOTATION]


def _mutate_mpi(job: VCJob) -> None:
    """MPI mutating plugin (reference admission/jobs/plugins/mpi):
    the launcher must not start before the workers exist, so default
    the master task's dependsOn to the worker task."""
    if "mpi" not in job.plugins:
        return
    master, worker = "master", "worker"
    for arg in job.plugins.get("mpi") or []:
        if arg.startswith("--master="):
            master = arg.split("=", 1)[1]
        elif arg.startswith("--worker="):
            worker = arg.split("=", 1)[1]
    from volcano_tpu_torch.api.vcjob import DependsOn
    if worker not in {t.name for t in job.tasks}:
        return   # never inject a dependency on a task that isn't there
    for task in job.tasks:
        if task.name == master and task.depends_on is None:
            task.depends_on = DependsOn(name=[worker])


def validate_job(job: VCJob, cluster=None) -> None:
    """Spec sanity (reference admission/jobs/validate)."""
    from volcano_tpu_torch.controllers.job.plugins import job_plugin_exists

    if not DNS1123.match(job.name) or len(job.name) > MAX_NAME_LEN:
        raise AdmissionError(
            f"job name {job.name!r} must be a DNS-1123 label "
            f"(<= {MAX_NAME_LEN} chars)")
    if not job.tasks:
        raise AdmissionError("job must declare at least one task")
    names = [t.name for t in job.tasks]
    if len(set(names)) != len(names):
        raise AdmissionError(f"duplicate task names: {names}")
    total = 0
    for task in job.tasks:
        if not DNS1123.match(task.name):
            raise AdmissionError(f"task name {task.name!r} invalid")
        if task.replicas < 0:
            raise AdmissionError(f"task {task.name}: replicas < 0")
        if task.min_available is not None and \
                task.min_available > task.replicas:
            raise AdmissionError(
                f"task {task.name}: minAvailable {task.min_available} > "
                f"replicas {task.replicas}")
        total += task.replicas
        if task.depends_on:
            for dep in task.depends_on.name:
                if dep not in names:
                    raise AdmissionError(
                        f"task {task.name} dependsOn unknown task {dep}")
    if job.min_available < 0:
        raise AdmissionError("minAvailable must be >= 0")
    if job.min_available > total:
        raise AdmissionError(
            f"minAvailable {job.min_available} > total replicas {total}")
    if job.min_success is not None and job.min_success > total:
        raise AdmissionError(
            f"minSuccess {job.min_success} > total replicas {total}")
    if job.max_retry < 0:
        raise AdmissionError("maxRetry must be >= 0")
    for plugin_name in job.plugins:
        if not job_plugin_exists(plugin_name):
            raise AdmissionError(f"unknown job plugin {plugin_name!r}")
    for policy in job.policies:
        if policy.event is None and not policy.events and \
                policy.exit_code is None:
            raise AdmissionError("policy must set event(s) or exitCode")
        if policy.exit_code == 0:
            raise AdmissionError("policy exitCode 0 is not allowed")
    if job.network_topology is not None and \
            job.network_topology.highest_tier_allowed is not None and \
            job.network_topology.highest_tier_allowed < 1:
        raise AdmissionError("networkTopology.highestTierAllowed must be >= 1")
    subgroup_nts = {}
    for task in job.tasks:
        nt = getattr(task, "network_topology", None)
        if nt is None:
            continue
        if not task.subgroup:
            raise AdmissionError(
                f"task {task.name!r}: networkTopology requires subGroup "
                "(per-task topology binds a subgroup gang to a domain)")
        if nt.highest_tier_allowed is not None and \
                nt.highest_tier_allowed < 1:
            raise AdmissionError(
                f"task {task.name!r}: networkTopology.highestTierAllowed "
                "must be >= 1")
        prev = subgroup_nts.setdefault(task.subgroup, nt)
        if prev is not nt and (prev.mode is not nt.mode or
                               prev.highest_tier_allowed !=
                               nt.highest_tier_allowed):
            raise AdmissionError(
                f"task {task.name!r}: conflicting networkTopology for "
                f"subGroup {task.subgroup!r} (one constraint per "
                "subgroup gang)")
    _validate_elastic(job)
    if cluster is not None and job.queue:
        if job.queue not in cluster.queues:
            raise AdmissionError(f"queue {job.queue!r} does not exist")
        if not cluster.queues[job.queue].is_open():
            raise AdmissionError(f"queue {job.queue!r} is not open")


def _validate_elastic(job: VCJob) -> None:
    """Elastic-range sanity: integers with 1 <= min <= slices <= max,
    and the GPU worker replicas must divide evenly by the slice count
    (the quotient — pods-per-slice — is the invariant every resize
    preserves, so a fractional one can never be materialized)."""
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.resource import GPU
    ann = job.annotations
    declared = [k for k in (eapi.ELASTIC_MIN_SLICES_ANNOTATION,
                            eapi.ELASTIC_MAX_SLICES_ANNOTATION)
                if k in ann]
    if not declared:
        return
    if len(declared) == 1:
        raise AdmissionError(
            f"elastic jobs must declare BOTH min-slices and "
            f"max-slices (got only {declared[0]})")
    rng = eapi.elastic_range(job)
    if rng is None:
        raise AdmissionError(
            "elastic min/max-slices must be integers with "
            "1 <= min <= max")
    if any(t.subgroup for t in job.tasks):
        # the resize machinery scales ONE process grid (the torch
        # plugin's elastic env path keys slice ids on rank blocks);
        # subgrouped gangs pin slice ids to static subgroups, which a
        # resize cannot re-shape — reject instead of mis-meshing
        raise AdmissionError(
            "elastic ranges are not supported on subgrouped gangs "
            "(the subgroup count pins the slice topology)")
    slices = eapi.current_slices(job)
    if not rng[0] <= slices <= rng[1]:
        raise AdmissionError(
            f"elastic slices {slices} outside the declared range "
            f"[{rng[0]}, {rng[1]}]")
    scalable = [t for t in job.tasks
                if float((t.template_pod().resource_requests()
                          .get(GPU)) or 0) > 0] or job.tasks
    for task in scalable:
        if task.replicas % slices:
            raise AdmissionError(
                f"task {task.name!r}: {task.replicas} replicas do not "
                f"divide into {slices} slice(s) — elastic resize "
                f"needs an integral pods-per-slice")


# -- queues -----------------------------------------------------------

# reference-style hierarchy annotations (KubeHierarchyAnnotationKey):
# consumed by hdrf when annotation-driven hierarchy is used in place
# of the parent field
HIERARCHY_ANNOTATION = "volcano-tpu.io/hierarchy"
HIERARCHY_WEIGHTS_ANNOTATION = "volcano-tpu.io/hierarchy-weights"


def mutate_queue(queue):
    """Create-path defaulting (reference admission/queues/mutate/
    mutate_queue.go:40): weight 0 -> 1, and hierarchy annotations are
    rooted (`a/b` -> `root/a/b`, weights `2/1` -> `1/2/1`) so every
    hierarchy walk shares one root.  reclaimable/state defaulting is
    the dataclass's (a wire create without those fields lands on
    True/OPEN already)."""
    if queue.weight <= 0:
        queue.weight = 1
    h = queue.annotations.get(HIERARCHY_ANNOTATION, "")
    hw = queue.annotations.get(HIERARCHY_WEIGHTS_ANNOTATION, "")
    if h and hw and h.split("/", 1)[0] != "root":
        queue.annotations[HIERARCHY_ANNOTATION] = f"root/{h}"
        queue.annotations[HIERARCHY_WEIGHTS_ANNOTATION] = f"1/{hw}"
    return queue


def validate_queue(queue, cluster=None) -> None:
    if not DNS1123.match(queue.name):
        raise AdmissionError(f"queue name {queue.name!r} invalid")
    if queue.weight <= 0:
        raise AdmissionError("queue weight must be > 0")
    if cluster is not None and queue.parent:
        if queue.parent not in cluster.queues:
            raise AdmissionError(
                f"parent queue {queue.parent!r} does not exist")
        # reject hierarchy cycles
        seen = {queue.name}
        cur = queue.parent
        while cur:
            if cur in seen:
                raise AdmissionError(
                    f"queue hierarchy cycle through {cur!r}")
            seen.add(cur)
            parent = cluster.queues.get(cur)
            cur = parent.parent if parent else ""


# -- podgroups / hypernodes -------------------------------------------

# namespace annotation naming that namespace's default queue
# (reference QueueNameAnnotationKey, podgroups/mutate)
QUEUE_NAME_NAMESPACE_ANNOTATION = "volcano-tpu.io/queue-name"


def mutate_podgroup(pg, cluster=None):
    """Create-path defaulting (reference admission/podgroups/mutate):
    a podgroup left on the default queue adopts its NAMESPACE's
    queue-name annotation, so teams get per-namespace queues without
    every submitter naming one."""
    if pg.queue in ("", DEFAULT_QUEUE) and cluster is not None:
        ns_ann = getattr(cluster, "namespaces", {}).get(
            pg.namespace) or {}
        ns_queue = ns_ann.get(QUEUE_NAME_NAMESPACE_ANNOTATION)
        if ns_queue:
            pg.queue = ns_queue
    if not pg.queue:
        pg.queue = DEFAULT_QUEUE
    return pg


def validate_podgroup(pg) -> None:
    if pg.min_member < 0:
        raise AdmissionError("minMember must be >= 0")
    if pg.min_task_member:
        for name, n in pg.min_task_member.items():
            if n < 0:
                raise AdmissionError(f"minTaskMember[{name}] must be >= 0")


def validate_hypernode(hn) -> None:
    if hn.tier < 1:
        raise AdmissionError("hypernode tier must be >= 1")
    if not hn.members:
        raise AdmissionError("hypernode must have members")
    for m in hn.members:
        if m.kind not in ("Node", "HyperNode"):
            raise AdmissionError(f"invalid member kind {m.kind!r}")
        if not (m.exact or m.regex or m.labels):
            raise AdmissionError("member selector must be set")


# -- pods (reference admission/pods/{validate,mutate}) ----------------

# disruption-budget annotations (JDBMinAvailable/JDBMaxUnavailable
# analogues; consumed by plugins/pdb.py)
PDB_MIN_AVAILABLE_ANNOTATION = "volcano-tpu.io/min-available"
PDB_MAX_UNAVAILABLE_ANNOTATION = "volcano-tpu.io/max-unavailable"
# opt-in for the queue-admission scheduling gate (pods/mutate)
GATE_OPT_IN_ANNOTATION = "volcano-tpu.io/queue-admission-gate"


def _validate_int_or_percentage(key: str, value: str) -> None:
    """Positive integer, or '1%'..'99%' (admit_pod.go
    validateIntPercentageStr)."""
    s = str(value).strip()
    if s.endswith("%"):
        try:
            v = int(s[:-1])
        except ValueError:
            raise AdmissionError(
                f"invalid value {value!r} for {key}") from None
        if not 0 < v < 100:
            raise AdmissionError(
                f"invalid value {value!r} for {key}: percentage must be "
                f"between 1% and 99%")
        return
    try:
        v = int(s)
    except ValueError:
        raise AdmissionError(
            f"invalid value {value!r} for {key}: neither int nor "
            f"percentage") from None
    if v <= 0:
        raise AdmissionError(
            f"invalid value {value!r} for {key}: must be a positive "
            f"integer")


def validate_pod(pod) -> None:
    """Budget-annotation sanity for scheduler-managed pods
    (admit_pod.go:99-141): each must be int-or-percentage, and the two
    keys are mutually exclusive."""
    if pod.scheduler_name not in ("volcano-tpu", "volcano-tpu-agent"):
        return
    present = 0
    for key in (PDB_MIN_AVAILABLE_ANNOTATION,
                PDB_MAX_UNAVAILABLE_ANNOTATION):
        value = pod.annotations.get(key)
        if value is not None:
            present += 1
            _validate_int_or_percentage(key, value)
    if present > 1:
        raise AdmissionError(
            f"not allowed to configure both "
            f"{PDB_MIN_AVAILABLE_ANNOTATION} and "
            f"{PDB_MAX_UNAVAILABLE_ANNOTATION}")


def mutate_pod(pod):
    """Add the queue-admission scheduling gate for opted-in pods when
    the feature gate is on (mutate_pod.go:156-180; idempotent)."""
    from volcano_tpu_torch import features
    if features.enabled("SchedulingGatesQueueAdmission") and \
            pod.annotations.get(GATE_OPT_IN_ANNOTATION) == "enable":
        from volcano_tpu_torch.framework.job_updater import QUEUE_ADMISSION_GATE
        if QUEUE_ADMISSION_GATE not in pod.scheduling_gates:
            pod.scheduling_gates.append(QUEUE_ADMISSION_GATE)
    return pod


# -- jobflows (reference admission/jobflows/validate) -----------------

def validate_jobflow(flow) -> None:
    """DAG sanity: DNS names, unique steps, known dependency targets,
    no cycles (validate_jobflow.go:94)."""
    if not DNS1123.match(flow.name) or len(flow.name) > MAX_NAME_LEN:
        raise AdmissionError(f"jobflow name {flow.name!r} invalid")
    names = [s.name for s in flow.flows]
    if len(set(names)) != len(names):
        raise AdmissionError(f"duplicate flow steps: {names}")
    known = set(names)
    deps = {}
    for step in flow.flows:
        if not DNS1123.match(step.name):
            raise AdmissionError(f"flow step name {step.name!r} invalid")
        targets = step.depends_on.targets if step.depends_on else []
        for t in targets:
            if t not in known:
                raise AdmissionError(
                    f"flow step {step.name!r} depends on unknown "
                    f"target {t!r}")
        deps[step.name] = list(targets)
    # cycle detection (iterative DFS, 3-color)
    state: dict = {}

    def visit(n):
        stack = [(n, iter(deps.get(n, ())))]
        state[n] = 1
        while stack:
            cur, it = stack[-1]
            for nxt in it:
                if state.get(nxt) == 1:
                    raise AdmissionError(
                        f"jobflow DAG cycle through {nxt!r}")
                if nxt not in state:
                    state[nxt] = 1
                    stack.append((nxt, iter(deps.get(nxt, ()))))
                    break
            else:
                state[cur] = 2
                stack.pop()

    for n in deps:
        if n not in state:
            visit(n)


# -- cronjobs (reference admission/cronjobs/validate) -----------------

def validate_cronjob(cron, cluster=None) -> None:
    from volcano_tpu_torch.controllers.cronjob import cron_field_valid

    if not DNS1123.match(cron.name) or len(cron.name) > MAX_NAME_LEN:
        raise AdmissionError(f"cronjob name {cron.name!r} invalid")
    fields = (cron.schedule or "").split()
    if len(fields) != 5:
        raise AdmissionError(
            f"schedule {cron.schedule!r} must have 5 cron fields")
    bounds = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))
    for spec, (lo, hi) in zip(fields, bounds):
        if not cron_field_valid(spec, lo, hi):
            raise AdmissionError(
                f"invalid cron field {spec!r} in {cron.schedule!r}")
    if cron.concurrency_policy not in ("Allow", "Forbid", "Replace"):
        raise AdmissionError(
            f"invalid concurrencyPolicy {cron.concurrency_policy!r}")
    if cron.successful_jobs_history_limit < 0:
        raise AdmissionError("successfulJobsHistoryLimit must be >= 0")
    if cron.job_template is not None:
        job = mutate_job(cron.job_template)
        validate_job(job, cluster)


class AdmissionChain:
    """The webhook pipeline a Cluster applies on create (and the
    validate-only half on spec updates)."""

    def admit_job(self, job: VCJob, cluster=None) -> VCJob:
        job = mutate_job(job)
        validate_job(job, cluster)
        return job

    def admit_job_update(self, job: VCJob, cluster=None) -> VCJob:
        """Update path: spec sanity re-validated, but create-only gates
        (queue open/exists) are NOT re-applied — a controller flushing
        status on a job whose queue has since closed must not be
        rejected."""
        validate_job(job, cluster=None)
        return job

    def admit_queue(self, queue, cluster=None):
        queue = mutate_queue(queue)
        validate_queue(queue, cluster)
        return queue

    def admit_podgroup(self, pg, cluster=None):
        pg = mutate_podgroup(pg, cluster)
        validate_podgroup(pg)
        return pg

    def admit_hypernode(self, hn, cluster=None):
        validate_hypernode(hn)
        return hn

    def admit_pod(self, pod, cluster=None):
        pod = mutate_pod(pod)
        validate_pod(pod)
        return pod

    def admit_jobflow(self, flow, cluster=None):
        validate_jobflow(flow)
        return flow

    def admit_cronjob(self, cron, cluster=None):
        validate_cronjob(cron, cluster)
        return cron


def default_admission() -> AdmissionChain:
    return AdmissionChain()

"""TaskInfo / SubJobInfo / JobInfo — the scheduler's in-memory job model.

Reference parity: pkg/scheduler/api/job_info.go (TaskInfo:118,
JobInfo:363, gang counting helpers), sub_job_info.go:40 (SubJobInfo with
AllocatedHyperNode / NominatedHyperNode for subgroup topology gang).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

from volcano_tpu_torch.api.fit_error import FitError, FitErrors
from volcano_tpu_torch.api.pod import Pod
from volcano_tpu_torch.api.podgroup import NetworkTopologySpec, PodGroup
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import (
    ALIVE_TASK_STATUSES,
    READY_TASK_STATUSES,
    PREEMPTABLE_ANNOTATION,
    SUBGROUP_LABEL,
    TASK_SPEC_LABEL,
    TaskStatus,
    occupied,
)

# Default max wait before a pipelined job is considered stuck
# (reference JobWaitingTime default).
DEFAULT_JOB_WAITING_TIME = 60.0

# Subgroup name used when a job has no subGroupPolicy: every task belongs
# to the implicit root subjob.
ROOT_SUB_JOB = ""


class TaskInfo:
    """One schedulable pod within a job."""

    __slots__ = (
        "uid", "job", "name", "namespace", "resreq", "init_resreq",
        "node_name", "status", "priority", "best_effort", "preemptable",
        "revocable", "pod", "task_spec", "sub_job", "nominated_node",
        "last_tx_node", "last_tx_status",
    )

    def __init__(self, pod: Pod, job_uid: str = ""):
        self.uid = pod.uid
        self.job = job_uid or pod.owner
        self.name = pod.name
        self.namespace = pod.namespace
        self.resreq = pod.resource_requests()
        self.init_resreq = self.resreq.clone()
        self.node_name = pod.node_name
        self.status = pod.phase
        self.priority = pod.priority
        self.best_effort = self.resreq.is_empty()
        self.preemptable = _pod_preemptable(pod)
        self.revocable = False
        self.pod = pod
        self.task_spec = pod.task_spec or pod.labels.get(TASK_SPEC_LABEL, "")
        self.sub_job = pod.labels.get(SUBGROUP_LABEL, ROOT_SUB_JOB)
        self.nominated_node = pod.nominated_node
        # transaction context for Statement save/recover
        self.last_tx_node = ""
        self.last_tx_status: Optional[TaskStatus] = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def occupies_resources(self) -> bool:
        return occupied(self.status)

    def is_alive(self) -> bool:
        return self.status in ALIVE_TASK_STATUSES

    def clone(self) -> "TaskInfo":
        c = TaskInfo.__new__(TaskInfo)
        c.uid = self.uid
        c.job = self.job
        c.name = self.name
        c.namespace = self.namespace
        c.resreq = self.resreq.clone()
        c.init_resreq = self.init_resreq.clone()
        c.node_name = self.node_name
        c.status = self.status
        c.priority = self.priority
        c.best_effort = self.best_effort
        c.preemptable = self.preemptable
        c.revocable = self.revocable
        c.pod = self.pod
        c.task_spec = self.task_spec
        c.sub_job = self.sub_job
        c.nominated_node = self.nominated_node
        c.last_tx_node = self.last_tx_node
        c.last_tx_status = self.last_tx_status
        return c

    def save_tx_context(self):
        self.last_tx_node = self.node_name
        self.last_tx_status = self.status

    def __repr__(self):
        return (f"TaskInfo({self.key}, {self.status.value}, "
                f"node={self.node_name or '-'}, req={self.resreq})")


def _pod_preemptable(pod: Pod) -> bool:
    v = pod.annotations.get(PREEMPTABLE_ANNOTATION)
    if v is not None:
        return str(v).lower() == "true"
    return pod.preemptable


class SubJobInfo:
    """Subgroup gang state: a named slice of the job's tasks with its own
    minMember and (optionally) its own topology constraint.  On GPUs
    this is the unit that must land inside one NVLink domain."""

    def __init__(self, name: str, min_member: int = 0,
                 network_topology: Optional[NetworkTopologySpec] = None):
        self.name = name
        self.min_member = min_member
        self.network_topology = network_topology
        self.tasks: Dict[str, TaskInfo] = {}
        # Set when allocate commits this subjob into a hypernode domain;
        # recovered from running pods after scheduler restart.
        self.allocated_hypernode: str = ""
        # Set by gangpreempt nomination; consumed by next allocate cycle.
        self.nominated_hypernode: str = ""

    def ready_task_num(self) -> int:
        return sum(1 for t in self.tasks.values()
                   if t.status in READY_TASK_STATUSES)

    def waiting_task_num(self) -> int:
        return sum(1 for t in self.tasks.values()
                   if t.status is TaskStatus.PIPELINED)

    def is_ready(self) -> bool:
        return self.ready_task_num() >= self.min_member

    def is_pipelined(self) -> bool:
        return self.ready_task_num() + self.waiting_task_num() >= self.min_member

    def clone(self) -> "SubJobInfo":
        c = SubJobInfo(self.name, self.min_member, self.network_topology)
        c.allocated_hypernode = self.allocated_hypernode
        c.nominated_hypernode = self.nominated_hypernode
        return c

    def __repr__(self):
        return (f"SubJobInfo({self.name or '<root>'}, min={self.min_member}, "
                f"tasks={len(self.tasks)})")


class JobInfo:
    """All scheduler state for one PodGroup's worth of tasks."""

    def __init__(self, uid: str, podgroup: Optional[PodGroup] = None):
        self.uid = uid
        self.podgroup = podgroup
        self.name = podgroup.name if podgroup else uid
        self.namespace = podgroup.namespace if podgroup else "default"
        self.queue = podgroup.queue if podgroup else "default"
        self.priority = 0
        self.priority_class = podgroup.priority_class if podgroup else ""
        self.min_available = podgroup.min_member if podgroup else 1
        self.task_min_available: Dict[str, int] = dict(
            podgroup.min_task_member) if podgroup else {}
        self.creation_time = podgroup.creation_time if podgroup else time.time()
        self.waiting_time = DEFAULT_JOB_WAITING_TIME
        self.preemptable = True
        self.revocable_zone = ""

        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = \
            defaultdict(dict)
        self.sub_jobs: Dict[str, SubJobInfo] = {}
        if podgroup:
            for sg in podgroup.sub_group_policies:
                self.sub_jobs[sg.name] = SubJobInfo(
                    sg.name, sg.min_member, sg.network_topology)
            self._recover_nominations(podgroup)

        self.total_request = Resource()
        # resources held by occupying tasks, carried incrementally at
        # the task mutation seams (add/remove/update_task_status) the
        # same way total_request is: allocated() used to re-walk every
        # task per call, and the share plugins call it per job per
        # session — a fifth of the idle cycle at 40k hosts
        self._allocated = Resource()
        # min_request memo (see min_request for the box rationale)
        self._min_req_box: list = [None]
        self.fit_errors: Dict[str, FitErrors] = {}   # per-task-uid node errors
        self.job_fit_errors: Optional[FitErrors] = None
        self.scheduling_start = 0.0

    def _recover_nominations(self, podgroup: PodGroup):
        """Rehydrate gangpreempt's domain nominations from the PodGroup
        annotation (they must survive snapshot rebuilds between the
        evict cycle and the allocate cycle that consumes them)."""
        import json
        from volcano_tpu_torch.api.types import NOMINATED_HYPERNODES_ANNOTATION
        raw = podgroup.annotations.get(NOMINATED_HYPERNODES_ANNOTATION)
        if not raw:
            return
        try:
            nominations = json.loads(raw)
        except ValueError:
            return
        for sub_name, domain in nominations.items():
            sub = self.sub_jobs.get(sub_name)
            if sub is None:
                sub = SubJobInfo(sub_name, 0)
                self.sub_jobs[sub_name] = sub
            sub.nominated_hypernode = domain

    def persist_nominations(self):
        """Write current nominations back into the PodGroup annotation
        (empty mapping removes it)."""
        import json
        from volcano_tpu_torch.api.types import NOMINATED_HYPERNODES_ANNOTATION
        if self.podgroup is None:
            return
        nominations = {name: sub.nominated_hypernode
                       for name, sub in self.sub_jobs.items()
                       if sub.nominated_hypernode}
        if nominations:
            self.podgroup.annotations[NOMINATED_HYPERNODES_ANNOTATION] = \
                json.dumps(nominations, sort_keys=True)
        else:
            self.podgroup.annotations.pop(
                NOMINATED_HYPERNODES_ANNOTATION, None)

    # -- spec accessors ------------------------------------------------

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def network_topology(self) -> Optional[NetworkTopologySpec]:
        return self.podgroup.network_topology if self.podgroup else None

    def is_hard_topology(self) -> bool:
        nt = self.network_topology
        from volcano_tpu_torch.api.types import NetworkTopologyMode
        return nt is not None and nt.mode == NetworkTopologyMode.HARD

    def has_topology_constraint(self) -> bool:
        """Job-level hard topology OR any subgroup with hard topology —
        either routes allocation through the topology-domain search."""
        from volcano_tpu_torch.api.types import NetworkTopologyMode
        if self.is_hard_topology():
            return True
        return any(
            sub.network_topology is not None
            and sub.network_topology.mode == NetworkTopologyMode.HARD
            and sub.min_member > 0
            for sub in self.sub_jobs.values())

    @property
    def min_resources(self) -> Resource:
        if self.podgroup and self.podgroup.min_resources:
            return self.podgroup.min_resources.clone()
        return Resource()

    @property
    def has_min_resources(self) -> bool:
        """Did the user declare spec.minResources?  Admission gates only
        apply to jobs that did (reference: 'MinResources == nil =>
        Permit' in overcommit/proportion/capacity enqueue fns)."""
        return bool(self.podgroup and self.podgroup.min_resources)

    # -- task management ----------------------------------------------

    def add_task(self, task: TaskInfo):
        task.job = self.uid
        self.tasks[task.uid] = task
        self.task_status_index[task.status][task.uid] = task
        if not task.best_effort:
            self.total_request.add(task.resreq)
            self._min_req_box[0] = None
        if task.occupies_resources():
            self._allocated.add(task.resreq)
        sub = self.sub_jobs.get(task.sub_job)
        if sub is None:
            sub = SubJobInfo(task.sub_job, 0)
            self.sub_jobs[task.sub_job] = sub
        sub.tasks[task.uid] = task

    def remove_task(self, task: TaskInfo):
        existing = self.tasks.pop(task.uid, None)
        if existing is None:
            return
        self.task_status_index[existing.status].pop(task.uid, None)
        if not existing.best_effort:
            self.total_request.sub_unchecked(existing.resreq)
            self._min_req_box[0] = None
        if existing.occupies_resources():
            self._allocated.sub_unchecked(existing.resreq)
        sub = self.sub_jobs.get(existing.sub_job)
        if sub:
            sub.tasks.pop(task.uid, None)

    def update_task_status(self, task: TaskInfo, status: TaskStatus):
        self.task_status_index[task.status].pop(task.uid, None)
        was_occupying = task.uid in self.tasks and occupied(task.status)
        task.status = status
        self.tasks[task.uid] = task
        self.task_status_index[status][task.uid] = task
        now_occupying = occupied(status)
        if now_occupying and not was_occupying:
            self._allocated.add(task.resreq)
        elif was_occupying and not now_occupying:
            self._allocated.sub_unchecked(task.resreq)
        sub = self.sub_jobs.get(task.sub_job)
        if sub:
            sub.tasks[task.uid] = task

    def tasks_in_status(self, status: TaskStatus) -> List[TaskInfo]:
        return list(self.task_status_index.get(status, {}).values())

    # -- gang counting (job_info.go ReadyTaskNum et al.) ---------------

    def ready_task_num(self) -> int:
        return sum(len(self.task_status_index.get(s, ()))
                   for s in READY_TASK_STATUSES)

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.PIPELINED, ()))

    def valid_task_num(self) -> int:
        """Tasks capable of becoming ready (alive)."""
        return sum(1 for t in self.tasks.values() if t.is_alive())

    def pending_best_effort_task_num(self) -> int:
        return sum(1 for t in self.tasks_in_status(TaskStatus.PENDING)
                   if t.best_effort)

    def is_ready(self) -> bool:
        """ready + pending-best-effort >= minAvailable (job_info.go:1202
        — best-effort tasks always place via backfill, so they count
        toward the floor)."""
        return (self.ready_task_num() + self.pending_best_effort_task_num()
                >= self.min_available)

    def is_pipelined(self) -> bool:
        return (self.ready_task_num() + self.waiting_task_num()
                + self.pending_best_effort_task_num() >= self.min_available)

    def is_starving(self) -> bool:
        """waiting + ready < minAvailable (job_info.go:1210): a job with
        enough pipelined reservations is no longer starving — stops
        preempt/reclaim from over-evicting past the gang floor."""
        return (self.ready_task_num() + self.waiting_task_num()
                < self.min_available)

    def check_task_min_available(self) -> bool:
        """Per-task-spec minima (minTaskMember) are satisfiable by alive
        tasks (reference CheckTaskValid)."""
        if not self.task_min_available:
            return True
        if self.min_available < sum(self.task_min_available.values()):
            # job-level floor below the per-task total: per-task minima
            # don't bind (job_info.go:1026-1029) — this is what lets
            # dependsOn jobs gang on their first stage only
            return True
        alive_per_spec: Dict[str, int] = defaultdict(int)
        for t in self.tasks.values():
            if t.is_alive():
                alive_per_spec[t.task_spec] += 1
        return all(alive_per_spec.get(spec, 0) >= need
                   for spec, need in self.task_min_available.items())

    def check_task_min_available_ready(self) -> bool:
        """Per-task-spec minima met by READY tasks (CheckTaskReady)."""
        if not self.task_min_available:
            return True
        if self.min_available < sum(self.task_min_available.values()):
            # job-level floor below the per-task total: per-task minima
            # don't bind (job_info.go:1026-1029) — this is what lets
            # dependsOn jobs gang on their first stage only
            return True
        ready_per_spec: Dict[str, int] = defaultdict(int)
        for t in self.tasks.values():
            if t.status in READY_TASK_STATUSES:
                ready_per_spec[t.task_spec] += 1
        return all(ready_per_spec.get(spec, 0) >= need
                   for spec, need in self.task_min_available.items())

    def check_task_min_available_pipelined(self) -> bool:
        if not self.task_min_available:
            return True
        if self.min_available < sum(self.task_min_available.values()):
            # job-level floor below the per-task total: per-task minima
            # don't bind (job_info.go:1026-1029) — this is what lets
            # dependsOn jobs gang on their first stage only
            return True
        per_spec: Dict[str, int] = defaultdict(int)
        for t in self.tasks.values():
            if (t.status in READY_TASK_STATUSES
                    or t.status is TaskStatus.PIPELINED):
                per_spec[t.task_spec] += 1
        return all(per_spec.get(spec, 0) >= need
                   for spec, need in self.task_min_available.items())

    # -- resources -----------------------------------------------------

    def allocated(self) -> Resource:
        """Resources currently held by this job's occupying tasks.
        Carried incrementally at the task mutation seams; callers own
        the returned clone (the share plugins fold into it)."""
        return self._allocated.clone()

    def min_request(self) -> Resource:
        """Aggregate request of the cheapest min_available task set
        (approximation: sum of the smallest min_available task requests;
        used for enqueue admission like the reference's
        GetMinResources).  Memoized in a one-slot box: the inputs only
        move at add/remove_task (which clear the box), and the share
        plugins call this per job per session — the per-call task sort
        was a fifth of the idle cycle at 40k hosts.  A box, not an
        attribute, so the lazy fill of this pure-function-of-frozen-
        state memo is invisible to the freeze auditor's __setattr__
        guard (idempotent build-then-publish, same argument as the
        Session dispatch memos)."""
        if self.podgroup and self.podgroup.min_resources is not None:
            return self.podgroup.min_resources.clone()
        cached = self._min_req_box[0]
        if cached is None:
            reqs = sorted(
                (t.resreq for t in self.tasks.values()
                 if not t.best_effort),
                key=lambda r: (r.milli_cpu, r.memory))
            total = Resource()
            for r in reqs[: self.min_available]:
                total.add(r)
            cached = self._min_req_box[0] = total
        return cached.clone()

    def elastic_resources(self, allocated: Optional[Resource] = None
                          ) -> Resource:
        """Resources held beyond the gang floor (reference
        GetElasticResources, job_info.go:654: ExceededPart(allocated,
        minResources)) — reclaimable without breaking the gang."""
        alloc = allocated if allocated is not None else self.allocated()
        return alloc.clone().sub_unchecked(self.min_request())

    # -- fit errors ----------------------------------------------------

    def record_fit_error(self, task: TaskInfo, node_name: str, fe: FitError):
        errs = self.fit_errors.get(task.uid)
        if errs is None:
            errs = FitErrors()
            self.fit_errors[task.uid] = errs
        errs.set_node_error(node_name, fe)

    def set_job_fit_errors(self, errs) -> None:
        """Publish the job-level fit-error summary.  A designated
        reporting seam (like record_fit_error): the freeze auditor
        and the static race pass admit snapshot writes only through
        these, so allocate's _finish does not poke the attribute
        directly."""
        self.job_fit_errors = errs

    def task_has_fit_errors(self, task: TaskInfo) -> bool:
        """Fit-error memoization: a pending task whose identical spec
        already failed everywhere need not be retried this session
        (reference TaskHasFitErrors + fit-error cache)."""
        return task.uid in self.fit_errors

    def fit_error(self) -> str:
        if self.job_fit_errors is not None:
            return self.job_fit_errors.error()
        reasons = {uid: fe.error() for uid, fe in self.fit_errors.items()}
        return "; ".join(sorted(set(reasons.values()))) if reasons else ""

    # -- clone ---------------------------------------------------------

    def clone(self) -> "JobInfo":
        c = JobInfo.__new__(JobInfo)
        c.uid = self.uid
        c.podgroup = self.podgroup
        c.name = self.name
        c.namespace = self.namespace
        c.queue = self.queue
        c.priority = self.priority
        c.priority_class = self.priority_class
        c.min_available = self.min_available
        c.task_min_available = dict(self.task_min_available)
        c.creation_time = self.creation_time
        c.waiting_time = self.waiting_time
        c.preemptable = self.preemptable
        c.revocable_zone = self.revocable_zone
        c.tasks = {}
        c.task_status_index = defaultdict(dict)
        c.sub_jobs = {name: sj.clone() for name, sj in self.sub_jobs.items()}
        c.total_request = Resource()
        c._allocated = Resource()
        c._min_req_box = [None]
        c.fit_errors = {}
        c.job_fit_errors = None
        c.scheduling_start = self.scheduling_start
        for t in self.tasks.values():
            c.add_task(t.clone())
        return c

    def __repr__(self):
        return (f"JobInfo({self.key}, queue={self.queue}, "
                f"min={self.min_available}, tasks={len(self.tasks)}, "
                f"ready={self.ready_task_num()})")

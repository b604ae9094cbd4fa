"""Batch Job CRD type (batch/v1alpha1 Job analogue — "vcjob").

Reference parity: staging/.../batch/v1alpha1/job.go:54-126 (JobSpec:
minAvailable, tasks, policies, plugins, queue, maxRetry, ttl,
priorityClassName, minSuccess, networkTopology) and JobStatus.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.api.pod import Container, Pod, new_uid
from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
from volcano_tpu_torch.api.types import (
    DEFAULT_QUEUE,
    JobAction,
    JobEvent,
    JobPhase,
)


@dataclass
class LifecyclePolicy:
    """Map a pod/job event (or exit code) to an action.

    Reference: batch/v1alpha1 LifecyclePolicy {action, event, events,
    exitCode, timeout}.
    """

    action: JobAction = JobAction.SYNC_JOB
    event: Optional[JobEvent] = None
    events: List[JobEvent] = field(default_factory=list)
    exit_code: Optional[int] = None
    timeout_seconds: Optional[float] = None

    def matches(self, event: JobEvent, exit_code: Optional[int] = None) -> bool:
        if self.exit_code is not None:
            return exit_code is not None and exit_code == self.exit_code
        evs = set(self.events)
        if self.event is not None:
            evs.add(self.event)
        return event in evs or JobEvent.ANY in evs


@dataclass
class DependsOn:
    """Task-level DAG dependency inside one job (tasks[].dependsOn)."""

    name: List[str] = field(default_factory=list)
    iteration: str = "any"  # any | all


@dataclass
class TaskSpec:
    """One replica group of the job (tasks[] entry)."""

    name: str
    replicas: int = 1
    min_available: Optional[int] = None
    template: Optional[Pod] = None      # pod template (name ignored)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    depends_on: Optional[DependsOn] = None
    max_retry: int = 3
    subgroup: str = ""                  # subGroupPolicy membership
    # explicit subgroup topology (scheduling/v1beta1 types.go:217-223);
    # None + GPU requests => controller defaults to NVLink-local hard
    network_topology: Optional["NetworkTopologySpec"] = None

    def template_pod(self) -> Pod:
        if self.template is not None:
            return self.template
        return Pod(name=self.name, containers=[Container()])


@dataclass
class JobCondition:
    status: JobPhase
    last_transition_time: float = field(default_factory=time.time)


@dataclass
class VCJob:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    # spec
    scheduler_name: str = "volcano-tpu"
    min_available: int = 1
    min_success: Optional[int] = None
    tasks: List[TaskSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    queue: str = DEFAULT_QUEUE
    max_retry: int = 3
    ttl_seconds_after_finished: Optional[int] = None
    priority_class: str = ""
    network_topology: Optional[NetworkTopologySpec] = None

    # status
    phase: JobPhase = JobPhase.PENDING
    state_message: str = ""
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0            # incremented on restart
    retry_count: int = 0
    conditions: List[JobCondition] = field(default_factory=list)
    creation_time: float = field(default_factory=time.time)
    finish_time: Optional[float] = None
    controlled_resources: Dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def total_replicas(self) -> int:
        return sum(t.replicas for t in self.tasks)

    def task_by_name(self, name: str) -> Optional[TaskSpec]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def clone(self) -> "VCJob":
        import copy
        return copy.deepcopy(self)

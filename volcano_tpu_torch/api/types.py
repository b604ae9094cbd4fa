"""Core enums and constants.

Reference parity: pkg/scheduler/api/types.go (TaskStatus & helpers),
scheduling/v1beta1 PodGroupPhase, batch/v1alpha1 JobPhase, bus/v1alpha1
actions/events.
"""

from __future__ import annotations

import enum


class TaskStatus(enum.Enum):
    """Lifecycle status of a task (pod) as the scheduler sees it."""

    PENDING = "Pending"        # waiting to be scheduled
    ALLOCATED = "Allocated"    # resources assigned in-session, not bound
    PIPELINED = "Pipelined"    # assigned onto releasing resources
    BINDING = "Binding"        # bind RPC in flight
    BOUND = "Bound"            # bound to a node, not yet running
    RUNNING = "Running"
    RELEASING = "Releasing"    # being evicted / deleted
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


# Statuses that hold (or will hold) node resources, mirroring
# types.go AllocatedStatus().
ALLOCATED_TASK_STATUSES = frozenset({
    TaskStatus.ALLOCATED, TaskStatus.BINDING, TaskStatus.BOUND,
    TaskStatus.RUNNING,
})

# Statuses counted as "ready" for gang readiness (reference
# job_info.go ReadyTaskNum): holding resources or already succeeded.
READY_TASK_STATUSES = frozenset({
    TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING,
    TaskStatus.ALLOCATED, TaskStatus.SUCCEEDED,
})

# Statuses counted as "alive" for gang accounting.
ALIVE_TASK_STATUSES = frozenset({
    TaskStatus.PENDING, TaskStatus.ALLOCATED, TaskStatus.PIPELINED,
    TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING,
})


def occupied(status: TaskStatus) -> bool:
    """Does a task in this status occupy cluster resources now or soon?"""
    return status in ALLOCATED_TASK_STATUSES or status is TaskStatus.RELEASING


class PodGroupPhase(enum.Enum):
    """scheduling/v1beta1 PodGroup phase machine."""

    PENDING = "Pending"      # created, not admitted by a queue
    INQUEUE = "Inqueue"      # admitted — allocate may consider it
    RUNNING = "Running"      # minMember tasks running
    UNKNOWN = "Unknown"      # partially running, gang broken
    COMPLETED = "Completed"


class PodGroupConditionType(enum.Enum):
    SCHEDULED = "Scheduled"
    UNSCHEDULABLE = "Unschedulable"


class QueueState(enum.Enum):
    OPEN = "Open"
    CLOSED = "Closed"
    CLOSING = "Closing"
    UNKNOWN = "Unknown"


class JobPhase(enum.Enum):
    """batch/v1alpha1 vcjob phase machine (8 states, state/factory.go)."""

    PENDING = "Pending"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    COMPLETING = "Completing"
    TERMINATING = "Terminating"
    ABORTING = "Aborting"
    ABORTED = "Aborted"
    COMPLETED = "Completed"
    FAILED = "Failed"


# Terminal vcjob phases — single source of truth for the job
# controller, the garbage collector and cron history pruning.
FINISHED_JOB_PHASES = (JobPhase.COMPLETED, JobPhase.FAILED,
                       JobPhase.ABORTED)


class JobEvent(enum.Enum):
    """Pod/job events that lifecycle policies match on (bus/v1alpha1)."""

    ANY = "*"
    POD_FAILED = "PodFailed"
    POD_EVICTED = "PodEvicted"
    POD_PENDING = "PodPending"
    POD_RUNNING = "PodRunning"
    TASK_COMPLETED = "TaskCompleted"
    TASK_FAILED = "TaskFailed"
    JOB_UNKNOWN = "Unknown"
    OUT_OF_SYNC = "OutOfSync"
    COMMAND_ISSUED = "CommandIssued"
    JOB_UPDATED = "JobUpdated"


class JobAction(enum.Enum):
    """Actions a lifecycle policy may trigger (bus/v1alpha1/actions.go)."""

    ABORT_JOB = "AbortJob"
    RESTART_JOB = "RestartJob"
    RESTART_TASK = "RestartTask"
    RESTART_POD = "RestartPod"
    TERMINATE_JOB = "TerminateJob"
    COMPLETE_JOB = "CompleteJob"
    RESUME_JOB = "ResumeJob"
    SYNC_JOB = "SyncJob"
    ENQUEUE_JOB = "EnqueueJob"
    SYNC_QUEUE = "SyncQueue"
    OPEN_QUEUE = "OpenQueue"
    CLOSE_QUEUE = "CloseQueue"


class NetworkTopologyMode(enum.Enum):
    """Job networkTopology.mode (batch/v1alpha1 job.go:54-126)."""

    HARD = "hard"   # must fit within highestTierAllowed
    SOFT = "soft"   # prefer low tiers, allow spill


# Well-known annotations / labels (the volcano-tpu.io namespace).
GROUP_NAME_ANNOTATION = "scheduling.volcano-tpu.io/group-name"
QUEUE_NAME_ANNOTATION = "scheduling.volcano-tpu.io/queue-name"
PREEMPTABLE_ANNOTATION = "volcano-tpu.io/preemptable"
# Simulated workload duration: a RUNNING pod carrying this annotation
# succeeds after N kubelet-sim ticks — the stand-in for a batch
# container that exits (the reference e2e stress jobs run busybox
# `sleep N`; a pod with no terminating workload never completes, in
# real Kubernetes too).  Absent = runs until evicted/deleted.
RUN_TICKS_ANNOTATION = "volcano-tpu.io/run-ticks"
REVOCABLE_ZONE_ANNOTATION = "volcano-tpu.io/revocable-zone"
JOB_NAME_LABEL = "volcano-tpu.io/job-name"
JOB_NAMESPACE_LABEL = "volcano-tpu.io/job-namespace"
TASK_SPEC_LABEL = "volcano-tpu.io/task-spec"
TASK_INDEX_LABEL = "volcano-tpu.io/task-index"
SUBGROUP_LABEL = "volcano-tpu.io/subgroup-name"
NODEGROUP_LABEL = "volcano-tpu.io/nodegroup-name"

# GPU node labels consumed by the gpu device layer and the hypernode
# discoverer.  GPU Feature Discovery publishes the product and the
# clique, the NVLink domain the host's GPUs sit in; on an HGX host the
# domain is the host itself.  NVSwitch links every pair of GPUs in a
# domain in one hop, so no coordinates label exists.
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"        # e.g. NVIDIA-H100-80GB-HBM3
GPU_CLIQUE_LABEL = "nvidia.com/gpu.clique"          # NVLink domain name/id
GPU_DOMAIN_SHAPE_LABEL = "volcano-tpu.io/nvlink-domain-shape"  # <hosts>x<gpus a host>, e.g. 32x8
GPU_HOST_INDEX_LABEL = "volcano-tpu.io/nvlink-host-index"      # host index in its domain

# QoS level annotation shared by the scheduler's BE fit path and the
# agent's BE eviction path; value "BE" marks best-effort colocation pods.
QOS_LEVEL_ANNOTATION = "volcano-tpu.io/qos-level"
QOS_BEST_EFFORT = "BE"
# the reference's full class ladder (pkg/agent/apis/extension/qos.go:
# LC/HLS=2, LS=1, BE=-1); unannotated pods are treated as LS
QOS_LATENCY_CRITICAL = "LC"
QOS_HIGHLY_LATENCY_SENSITIVE = "HLS"
QOS_LATENCY_SENSITIVE = "LS"

# Node annotation: reclaimable millicores published by the node agent,
# consumed by the scheduler's BE fit path.
OVERSUBSCRIPTION_CPU_ANNOTATION = \
    "oversubscription.volcano-tpu.io/cpu-millis"

# PodGroup annotation carrying gangpreempt's domain nominations across
# sessions: JSON {subgroup-name: hypernode-name} ("" = whole job).
NOMINATED_HYPERNODES_ANNOTATION = \
    "scheduling.volcano-tpu.io/nominated-hypernodes"

DEFAULT_QUEUE = "default"

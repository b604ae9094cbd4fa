"""Scheduler object model (reference: pkg/scheduler/api)."""

from volcano_tpu_torch.api.resource import Resource, CPU, MEMORY, PODS, GPU
from volcano_tpu_torch.api.types import (
    TaskStatus,
    PodGroupPhase,
    QueueState,
    JobPhase,
    ALIVE_TASK_STATUSES,
    ALLOCATED_TASK_STATUSES,
    occupied,
)
from volcano_tpu_torch.api.pod import Pod
from volcano_tpu_torch.api.job_info import TaskInfo, JobInfo, SubJobInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.queue_info import QueueInfo
from volcano_tpu_torch.api.podgroup import PodGroup, NetworkTopologySpec, SubGroupPolicy
from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.api.vcjob import VCJob, TaskSpec, LifecyclePolicy
from volcano_tpu_torch.api.hypernode import HyperNode, HyperNodeInfo, HyperNodesInfo
from volcano_tpu_torch.api.fit_error import FitError, FitErrors, Status, StatusCode

__all__ = [
    "Resource", "CPU", "MEMORY", "PODS", "GPU",
    "TaskStatus", "PodGroupPhase", "QueueState", "JobPhase",
    "ALIVE_TASK_STATUSES", "ALLOCATED_TASK_STATUSES", "occupied",
    "Pod", "TaskInfo", "JobInfo", "SubJobInfo", "NodeInfo", "QueueInfo",
    "PodGroup", "NetworkTopologySpec", "SubGroupPolicy", "Queue",
    "VCJob", "TaskSpec", "LifecyclePolicy",
    "HyperNode", "HyperNodeInfo", "HyperNodesInfo",
    "FitError", "FitErrors", "Status", "StatusCode",
]

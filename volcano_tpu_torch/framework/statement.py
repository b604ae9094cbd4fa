"""Statement — transactional operation log over a Session.

Reference parity: pkg/scheduler/framework/statement.go (Evict/Pipeline/
Allocate ops with Commit/Discard and SaveOperations/RecoverOperations).
This is what makes gang semantics safe: allocate actions build up task
placements tentatively and only Commit once the job is gang-ready;
topology dry-runs Save+Discard candidate domains and Recover the winner.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.types import TaskStatus

log = logging.getLogger(__name__)

ALLOCATE = "allocate"
PIPELINE = "pipeline"
EVICT = "evict"


class Operation:
    __slots__ = ("kind", "task", "node_name", "reason", "prev_status")

    def __init__(self, kind: str, task: TaskInfo, node_name: str = "",
                 reason: str = "", prev_status: Optional[TaskStatus] = None):
        self.kind = kind
        self.task = task
        self.node_name = node_name
        self.reason = reason
        self.prev_status = prev_status


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[Operation] = []

    # -- record + apply -----------------------------------------------

    def allocate(self, task: TaskInfo, node) -> None:
        self.ssn.allocate(task, node)
        self.operations.append(Operation(ALLOCATE, task, node.name))

    def pipeline(self, task: TaskInfo, node) -> None:
        self.ssn.pipeline(task, node)
        self.operations.append(Operation(PIPELINE, task, node.name))

    def evict(self, task: TaskInfo, reason: str = "") -> None:
        prev = task.status
        self.ssn.evict(task, reason)
        self.operations.append(Operation(EVICT, task, task.node_name,
                                         reason, prev_status=prev))

    # -- transaction control ------------------------------------------

    def commit(self) -> None:
        """Dispatch recorded ops to the cluster: allocations become bind
        requests; evictions become eviction calls; pipelines stay
        session-side (the pod keeps waiting for its releasing node)."""
        for op in self.operations:
            if op.kind == ALLOCATE:
                job = self.ssn.jobs[op.task.job]
                job.update_task_status(op.task, TaskStatus.BINDING)
                node = self.ssn.nodes.get(op.node_name)
                if node is not None:
                    node.update_task_status(op.task, TaskStatus.BINDING)
                    node.bind_generation += 1
                self.ssn.cache.add_bind_task(op.task)
            elif op.kind == EVICT:
                self.ssn.cache.evict(op.task, op.reason)
            elif op.kind == PIPELINE:
                self.ssn.cache.nominate(op.task, op.node_name)
        self.operations = []

    def discard(self) -> None:
        """Roll back every recorded op in reverse order."""
        self.rollback_to(0)

    def rollback_to(self, mark: int) -> None:
        """Undo ops recorded after savepoint *mark* (= len(operations)
        at save time) — lets per-subjob domain trials roll back without
        losing earlier subjobs' placements."""
        while len(self.operations) > mark:
            op = self.operations.pop()
            if op.kind in (ALLOCATE, PIPELINE):
                self.ssn.deallocate(op.task)
            elif op.kind == EVICT:
                self.ssn.unevict(op.task, op.prev_status)

    # -- dry-run support (topology domain search) ----------------------

    def save_operations(self) -> List[Operation]:
        """Snapshot the op log (call right before Discard so the winning
        candidate can be recovered)."""
        return list(self.operations)

    def recover_operations(self, saved: List[Operation]) -> None:
        """Re-apply a previously saved op log onto the session."""
        for op in saved:
            node = self.ssn.nodes.get(op.node_name)
            if op.kind == ALLOCATE:
                self.allocate(op.task, node)
            elif op.kind == PIPELINE:
                self.pipeline(op.task, node)
            elif op.kind == EVICT:
                self.evict(op.task, op.reason)

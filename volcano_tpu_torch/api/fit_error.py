"""Predicate status & unschedulable-reason bookkeeping.

Reference parity: pkg/scheduler/api/{types.go Status/StatusCode,
unschedule_info.go FitError/FitErrors}.
"""

from __future__ import annotations

import enum
from collections import Counter
from typing import Dict, List, Optional


class StatusCode(enum.IntEnum):
    SUCCESS = 0
    ERROR = 1                      # internal error, retriable
    UNSCHEDULABLE = 2              # doesn't fit, preemption might help
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3  # preemption cannot help
    SKIP = 4


class Status:
    __slots__ = ("code", "reason", "plugin", "evict_curable")

    def __init__(self, code: StatusCode = StatusCode.SUCCESS,
                 reason: str = "", plugin: str = "",
                 evict_curable: bool = False):
        self.code = code
        self.reason = reason
        self.plugin = plugin
        # True when evicting victims THIS session can flip the verdict
        # (the plugin tracks in-session eviction effects, e.g.
        # numaaware's cell crediting).  Resolvable-but-not-curable
        # failures (usage thresholds, host ports held by RELEASING
        # victims) are skipped by preempt rather than churned on.
        self.evict_curable = evict_curable

    @property
    def ok(self) -> bool:
        return self.code in (StatusCode.SUCCESS, StatusCode.SKIP)

    def is_unschedulable(self) -> bool:
        return self.code in (StatusCode.UNSCHEDULABLE,
                             StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def __repr__(self):
        return f"Status({self.code.name}, {self.plugin}: {self.reason})"


SUCCESS = Status()


def unschedulable(reason: str, plugin: str = "",
                  resolvable: bool = True,
                  evict_curable: bool = False) -> Status:
    code = (StatusCode.UNSCHEDULABLE if resolvable
            else StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE)
    return Status(code, reason, plugin,
                  evict_curable=resolvable and evict_curable)


class FitError:
    """Why one task failed on one node."""

    __slots__ = ("task_namespace", "task_name", "node_name", "statuses")

    def __init__(self, task=None, node=None, statuses: Optional[List[Status]] = None,
                 reasons: Optional[List[str]] = None):
        self.task_namespace = getattr(task, "namespace", "")
        self.task_name = getattr(task, "name", "")
        self.node_name = getattr(node, "name", node or "")
        self.statuses: List[Status] = list(statuses or [])
        for r in reasons or []:
            self.statuses.append(unschedulable(r))

    def reasons(self) -> List[str]:
        return [s.reason for s in self.statuses if s.reason]

    def __str__(self):
        return (f"task {self.task_namespace}/{self.task_name} on node "
                f"{self.node_name}: {', '.join(self.reasons()) or 'fit failed'}")


class FitErrors:
    """Aggregated fit errors for one job across nodes."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self.err: str = ""

    def set_node_error(self, node_name: str, fe: FitError):
        self.nodes[node_name] = fe

    def set_error(self, err: str):
        self.err = err

    def error(self) -> str:
        # Compress to "N node(s) reason" histogram like the reference.
        # A job/queue-level err is PREFIXED, not exclusive: per-node
        # entries recorded later in the session (preempt/reclaim
        # retries) must stay visible.
        reason_counts = Counter()
        for fe in self.nodes.values():
            for r in set(fe.reasons()) or {"node(s) didn't fit"}:
                reason_counts[r] += 1
        if not reason_counts:
            return self.err or "no fit errors recorded"
        parts = [f"{n} node(s) {r}" for r, n in
                 sorted(reason_counts.items(), key=lambda kv: (-kv[1], kv[0]))]
        histogram = f"all nodes are unavailable: {', '.join(parts)}."
        return f"{self.err}; {histogram}" if self.err else histogram

    def __str__(self):
        return self.error()

"""Shared action helpers: predicate sweep + node selection.

Reference parity: pkg/scheduler/util/predicate_helper.go (parallel
predicate over nodes with fit-error collection) and
actions/allocate/allocate.go:879-949 (idle vs future-idle gradients,
prioritizeNodes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api.fit_error import FitError
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo


def may_preempt(ssn, job) -> bool:
    """PriorityClass preemptionPolicy: Never bars a job from being a
    preemptor in preempt, reclaim, gangpreempt and gangreclaim alike
    (it still schedules normally)."""
    pc = ssn.priority_classes.get(job.priority_class)
    return pc is None or pc.preemption_policy != "Never"


def victim_sort_key(ssn):
    """Cheapest eviction first: lowest job priority, then lowest task
    priority, then smallest request — shared by per-node victim
    selection and bundle ordering so the two policies cannot drift."""
    def key(t: TaskInfo):
        job = ssn.jobs.get(t.job)
        jp = job.priority if job else 0
        return (jp, t.priority, sum(t.resreq.res.values()))
    return key


def predicate_nodes(ssn, task: TaskInfo, nodes: List[NodeInfo],
                    record_errors: bool = True) -> List[NodeInfo]:
    """Return nodes passing all predicate plugins for *task*."""
    job = ssn.jobs.get(task.job)
    fits = []
    for node in nodes:
        status = ssn.predicate(task, node)
        if status is None:
            fits.append(node)
        elif record_errors and job is not None:
            # vtplint: disable=snapshot-write (serial sweep only, single-threaded on the session owner thread; the parallel path defers fit-error rows to sweep._build_parallel's post-barrier merge)
            job.record_fit_error(task, node.name,
                                 FitError(task, node, statuses=[status]))
    return fits


from volcano_tpu_torch.api.types import QOS_BEST_EFFORT, QOS_LEVEL_ANNOTATION


def fit_class(task: TaskInfo, node: NodeInfo) -> Optional[str]:
    """Classify ONE node for *task*: "idle" (fits now), "future" (fits
    only once releasing resources free up — drives pipelining), or None.
    Best-effort-QoS tasks may additionally consume the node agent's
    REMAINING measured oversubscription slack."""
    is_be = task.pod.annotations.get(QOS_LEVEL_ANNOTATION) == \
        QOS_BEST_EFFORT
    idle = node.idle
    if is_be and not node.oversubscription.is_empty():
        slack = node.oversub_remaining()
        idle = idle.clone().add(slack)
        future = node.future_idle().add(slack)
        if task.init_resreq.less_equal(idle):
            return "idle"
        if task.init_resreq.less_equal(future):
            return "future"
        return None
    if task.init_resreq.less_equal(idle):
        return "idle"
    # nothing releasing and nothing pipelined => future_idle == idle:
    # skip the clone+add+sub (the sweep calls this once per fit node,
    # and on a mostly-settled cluster the slow path was pure waste)
    if node.releasing.is_empty() and node.pipelined.is_empty():
        return None
    if task.init_resreq.less_equal(node.future_idle()):
        return "future"
    return None


def split_by_fit(task: TaskInfo, nodes: List[NodeInfo]
                 ) -> Tuple[List[NodeInfo], List[NodeInfo]]:
    """Split candidates into (fits idle now, fits only future idle)
    (allocate.go idle/future-idle gradients)."""
    idle_fit, future_fit = [], []
    for node in nodes:
        cls = fit_class(task, node)
        if cls == "idle":
            idle_fit.append(node)
        elif cls == "future":
            future_fit.append(node)
    return idle_fit, future_fit


def prioritize_nodes(ssn, task: TaskInfo, nodes: List[NodeInfo],
                     base_scores: Optional[Dict[str, float]] = None
                     ) -> Optional[NodeInfo]:
    """Score candidates (BatchNodeOrder + NodeOrder) and return the best.

    base_scores: precomputed per-node NodeOrder scores (the allocate
    hot loop's per-spec cache); task-dependent BatchNodeOrder is always
    evaluated fresh.
    """
    if not nodes:
        return None
    if len(nodes) == 1:
        return nodes[0]
    scores: Dict[str, float] = ssn.batch_node_order(task, nodes)
    best, best_score = None, None
    for node in nodes:
        per_node = (base_scores.get(node.name, 0.0) if base_scores is not None
                    else ssn.node_order(task, node))
        s = scores.get(node.name, 0.0) + per_node
        if best_score is None or s > best_score or \
                (s == best_score and node.name < best.name):
            best, best_score = node, s
    return best

"""Predicates plugin — node feasibility filters.

Reference parity: plugins/predicates/predicates.go:212-388 (wraps
upstream nodeaffinity / tainttoleration / nodeports / podtopologyspread
filters).  Rebuilt natively: node readiness, nodeSelector, simplified
nodeAffinity terms, taints/tolerations, pod-count capacity, port
conflicts.
"""

from __future__ import annotations

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import PODS
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin


@register_plugin("predicates")
class PredicatesPlugin(Plugin):
    name = "predicates"

    def on_session_open(self, ssn):
        ssn.add_pre_predicate_fn(self.name, self._pre_predicate)
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_predicate_prepare_fn(self.name, self._prepare)

    @staticmethod
    def _pre_predicate(task: TaskInfo):
        if task.pod.scheduling_gates:
            return unschedulable(
                f"pod has unresolved scheduling gates "
                f"{task.pod.scheduling_gates}", "predicates",
                resolvable=False)
        return None

    @staticmethod
    def _predicate_static(task: TaskInfo, node: NodeInfo):
        """The spec-vs-node checks that cannot change as pods bind:
        readiness, nodeSelector, nodeAffinity, taints.  The agent fast
        path memoizes this half per (spec, node) between cache
        refreshes (reference predicate error cache, predicates/cache.go)."""
        if not node.ready:
            return unschedulable("node is not ready", "predicates",
                                 resolvable=False)

        pod = task.pod

        # nodeSelector
        for k, v in pod.node_selector.items():
            if node.labels.get(k) != v:
                return unschedulable(
                    "node(s) didn't match Pod's node selector",
                    "predicates", resolvable=False)

        # simplified nodeAffinity: OR over terms, AND within a term
        if pod.affinity_node_terms:
            matched = any(
                all(node.labels.get(k) in vals for k, vals in term.items())
                for term in pod.affinity_node_terms)
            if not matched:
                return unschedulable(
                    "node(s) didn't match Pod's node affinity",
                    "predicates", resolvable=False)

        # taints/tolerations
        for taint in node.taints:
            if taint.effect == "PreferNoSchedule":
                continue
            if not any(tol.tolerates(taint) for tol in pod.tolerations):
                return unschedulable(
                    f"node(s) had untolerated taint {{{taint.key}: "
                    f"{taint.value}}}", "predicates", resolvable=False)
        return None

    @staticmethod
    def _predicate_dynamic(task: TaskInfo, node: NodeInfo):
        """The occupancy-dependent half: pod-count capacity and host
        ports — must be re-checked every time a bind may have landed."""
        pod = task.pod

        # pod-count capacity
        cap = node.capability.get(PODS)
        if cap and len(node.tasks) >= cap:
            return unschedulable("node(s) had too many pods", "predicates")

        # host-port conflicts — O(task ports) against the node's
        # maintained port multiset (node_info.occupied_ports)
        for c in pod.containers:
            for port in c.ports:
                if node.occupied_ports.get(port):
                    return unschedulable(
                        "node(s) didn't have free ports", "predicates")
        return None

    @staticmethod
    def _predicate(task: TaskInfo, node: NodeInfo):
        return (PredicatesPlugin._predicate_static(task, node)
                or PredicatesPlugin._predicate_dynamic(task, node))

    @staticmethod
    def _prepare(task: TaskInfo):
        """Batched form of _predicate (PreFilter): hoists the pod's
        selector/affinity/tolerations/ports once per sweep and runs
        the same checks in one closure per node.  MUST stay verdict-
        identical to _predicate_static + _predicate_dynamic —
        tests/test_sweep.py pins the equivalence."""
        pod = task.pod
        selector = tuple(pod.node_selector.items())
        terms = pod.affinity_node_terms
        tolerations = pod.tolerations
        ports = [port for c in pod.containers for port in c.ports]

        def check(node: NodeInfo):
            if not node.ready:
                return unschedulable("node is not ready", "predicates",
                                     resolvable=False)
            labels = node.labels
            for k, v in selector:
                if labels.get(k) != v:
                    return unschedulable(
                        "node(s) didn't match Pod's node selector",
                        "predicates", resolvable=False)
            if terms:
                matched = any(
                    all(labels.get(k) in vals
                        for k, vals in term.items())
                    for term in terms)
                if not matched:
                    return unschedulable(
                        "node(s) didn't match Pod's node affinity",
                        "predicates", resolvable=False)
            for taint in node.taints:
                if taint.effect == "PreferNoSchedule":
                    continue
                if not any(tol.tolerates(taint)
                           for tol in tolerations):
                    return unschedulable(
                        f"node(s) had untolerated taint {{{taint.key}: "
                        f"{taint.value}}}", "predicates",
                        resolvable=False)
            cap = node.capability.get(PODS)
            if cap and len(node.tasks) >= cap:
                return unschedulable("node(s) had too many pods",
                                     "predicates")
            occupied = node.occupied_ports
            for port in ports:
                if occupied.get(port):
                    return unschedulable(
                        "node(s) didn't have free ports", "predicates")
            return None

        return check


# pod topology spread: pods opt in via annotations
#   spread.volcano-tpu.io/topology-key: <node label, e.g. zone>
#   spread.volcano-tpu.io/max-skew:     <int, default 1>
# Pods of the same job spread across distinct values of the topology
# key with bounded skew (upstream pod-topology-spread analogue; the
# reference wraps the k8s plugin, predicates.go:37).
SPREAD_KEY_ANNOTATION = "spread.volcano-tpu.io/topology-key"
SPREAD_SKEW_ANNOTATION = "spread.volcano-tpu.io/max-skew"


@register_plugin("pod-topology-spread")
class PodTopologySpreadPlugin(Plugin):
    name = "pod-topology-spread"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        # reference conf key (nodeorder.go:66); scorer prefers the
        # least-crowded spread domain even when skew is within bounds
        self.weight = float(self.arguments.get("podtopologyspread.weight", 1))

    def on_session_open(self, ssn):
        self.ssn = ssn
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_predicate_prepare_fn(self.name, self._prepare_spread)
        # MUST be a batch (per-task) scorer: the score depends on the
        # job's placements across the whole cluster, which allocate's
        # per-spec NodeOrder cache would go stale on (the cache only
        # invalidates the node a task landed on).  Registered only when
        # a pending pod actually opts in, because an ungrouped batch
        # scorer forces allocate off its heap fast path.
        from volcano_tpu_torch.api.types import TaskStatus
        if self.weight and any(
                t.pod.annotations.get(SPREAD_KEY_ANNOTATION)
                for job in ssn.jobs.values()
                for t in job.tasks_in_status(TaskStatus.PENDING)):
            ssn.add_batch_node_order_fn(self.name, self._batch_score)

    def _domain_counts(self, task: TaskInfo, key: str) -> dict:
        """Job's occupying-task count per spread-domain value, computed
        once per call (shared by predicate and scorer)."""
        counts: dict = {}
        for n in self.ssn.nodes.values():
            value = n.labels.get(key)
            if value is None:
                continue
            counts.setdefault(value, 0)
            for t in n.tasks.values():
                if t.job == task.job and t.occupies_resources():
                    counts[value] += 1
        return counts

    def _batch_score(self, task: TaskInfo, nodes) -> dict:
        """Prefer domains holding fewer of the job's tasks (k8s
        PodTopologySpread ScoreExtension analogue, linear in
        crowding).  Counts are computed once per task, not per node."""
        key = task.pod.annotations.get(SPREAD_KEY_ANNOTATION)
        if not key:
            return {}
        counts = self._domain_counts(task, key)
        worst = max(counts.values(), default=0)
        if worst == 0:
            return {}
        scores = {}
        for node in nodes:
            my_value = node.labels.get(key)
            if my_value is None or my_value not in counts:
                continue
            scores[node.name] = self.weight * 100.0 * \
                (worst - counts[my_value]) / worst
        return scores

    def _prepare_spread(self, task: TaskInfo):
        """Batched _predicate (PreFilter): the spread key is task-only
        and almost always absent — the common case collapses to a
        constant (equivalence pinned in test_sweep.py)."""
        if not task.pod.annotations.get(SPREAD_KEY_ANNOTATION):
            return lambda node: None
        return lambda node: self._predicate(task, node)

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        key = task.pod.annotations.get(SPREAD_KEY_ANNOTATION)
        if not key:
            return None
        try:
            max_skew = int(task.pod.annotations.get(
                SPREAD_SKEW_ANNOTATION, 1))
        except ValueError:
            max_skew = 1
        my_value = node.labels.get(key)
        if my_value is None:
            return unschedulable(
                f"node missing spread topology key {key!r}",
                "pod-topology-spread", resolvable=False)

        counts = self._domain_counts(task, key)
        if not counts:
            return None
        global_min = min(counts.values())
        if counts.get(my_value, 0) + 1 - global_min > max_skew:
            return unschedulable(
                f"placing here would exceed max skew {max_skew} "
                f"over {key}", "pod-topology-spread")
        return None

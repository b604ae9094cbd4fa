"""Inter-pod affinity/anti-affinity plugin.

Reference parity: pkg/scheduler/plugins/predicates/predicates.go:212-388
— the reference wraps the upstream k8s interpodaffinity plugin (required
filter + preferred scorer, with AddPod/RemovePod simulation hooks).
Rebuilt natively on the session's own indexes:

  * required affinity: a node passes iff EVERY pod_affinity term on the
    incoming pod has a matching assigned pod within the node's topology
    domain (nodes sharing the term's topology_key node-label value).
    Bootstrap rule (k8s semantics): a term nobody satisfies yet passes
    everywhere when the incoming pod matches it itself — the first
    replica of a self-affine group must be placeable.
  * required anti-affinity: a node fails iff ANY pod_anti_affinity term
    matches an assigned pod in the node's domain.  SYMMETRY is
    enforced: an assigned pod's own anti-affinity term also repels the
    incoming pod from its domain when the incoming pod matches it.
  * preferred terms score: + weight for each satisfied
    preferred_pod_affinity term, - weight for each violated
    preferred_pod_anti_affinity term (BatchNodeOrder — scores depend on
    other pods, so they are never cached per spec).

In-session placements update the index through the session EventHandler
(the reference's AddPod/RemovePod equivalents), and the plugin opts out
of allocate's per-spec verdict cache (ssn.task_dependent_predicates):
a placement in one topology domain flips verdicts for OTHER nodes in
that domain, which single-node invalidation cannot see.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import EventHandler

log = logging.getLogger(__name__)

MAX_SCORE = 100.0


def _pod_terms(pod):
    return (pod.pod_affinity, pod.pod_anti_affinity,
            pod.preferred_pod_affinity, pod.preferred_pod_anti_affinity)


def _has_terms(pod) -> bool:
    return any(_pod_terms(pod))


@register_plugin("interpodaffinity")
class InterPodAffinityPlugin(Plugin):
    name = "interpodaffinity"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        # "podaffinity.weight" is the reference conf key
        # (nodeorder.go:54); "weight" kept for back-compat
        self.weight = float(self.arguments.get(
            "podaffinity.weight", self.arguments.get("weight", 1)))

    def on_session_open(self, ssn):
        self.ssn = ssn
        # assigned pods by namespace: [(labels, node_name, uid)]
        self._assigned: Dict[str, Dict[str, Tuple[dict, str]]] = \
            defaultdict(dict)          # ns -> uid -> (labels, node)
        # assigned pods carrying required anti-affinity terms
        # (symmetry index): uid -> (namespace, labels, node, terms)
        self._anti_holders: Dict[str, tuple] = {}
        self._anti_version = 0          # bumped on holder index change
        self._repel_cache: Dict[str, tuple] = {}
        any_terms = False
        for job in ssn.jobs.values():
            for t in job.tasks.values():
                if t.node_name and t.occupies_resources():
                    self._index_add(t)
                if not any_terms and _has_terms(t.pod):
                    any_terms = True
        if not any_terms:
            # nothing in the snapshot carries affinity terms: register
            # NOTHING, so allocate keeps both its per-spec verdict
            # cache and its heap fast path (an unconditional ungrouped
            # batch fn would force the linear scan cluster-wide)
            return
        # verdicts depend on OTHER pods' placements: per-spec caching
        # with single-node invalidation is unsound
        ssn.task_dependent_predicates.add(self.name)
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_batch_node_order_fn(self.name, self._batch_node_order)
        ssn.add_event_handler(EventHandler(
            allocate_fn=lambda e: self._on_allocate(e.task),
            deallocate_fn=lambda e: self._on_deallocate(e.task)))

    # -- assigned-pod index --------------------------------------------

    def _index_add(self, task: TaskInfo) -> None:
        pod = task.pod
        self._assigned[pod.namespace][task.uid] = \
            (pod.labels, task.node_name)
        if pod.pod_anti_affinity:
            self._anti_holders[task.uid] = (
                pod.namespace, pod.labels, task.node_name,
                pod.pod_anti_affinity)
            self._anti_version += 1

    def _index_remove(self, task: TaskInfo) -> None:
        self._assigned[task.pod.namespace].pop(task.uid, None)
        if self._anti_holders.pop(task.uid, None) is not None:
            self._anti_version += 1

    def _on_allocate(self, task: TaskInfo) -> None:
        if task.node_name:
            self._index_add(task)

    def _on_deallocate(self, task: TaskInfo) -> None:
        self._index_remove(task)

    # -- topology helpers ----------------------------------------------

    def _domain_of(self, node_name: str, topology_key: str
                   ) -> Optional[str]:
        ni = self.ssn.nodes.get(node_name)
        if ni is None or ni.node is None:
            return None
        if topology_key == "kubernetes.io/hostname":
            return node_name
        return ni.node.labels.get(topology_key)

    def _term_namespaces(self, term, pod) -> List[str]:
        return term.namespaces or [pod.namespace]

    def _matching_assigned(self, term, pod, exclude_uid: str
                           ) -> List[str]:
        """Node names of assigned pods matching *term* (excluding the
        incoming pod itself)."""
        out = []
        for ns in self._term_namespaces(term, pod):
            for uid, (labels, node) in self._assigned.get(ns, {}).items():
                if uid != exclude_uid and term.matches(labels):
                    out.append(node)
        return out

    # -- predicate (required terms) ------------------------------------

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        pod = task.pod
        # required affinity
        for term in pod.pod_affinity:
            domain = self._domain_of(node.name, term.topology_key)
            if domain is None:
                return unschedulable(
                    f"node missing topology key {term.topology_key!r}",
                    self.name)
            holders = self._matching_assigned(term, pod, task.uid)
            if not holders:
                # bootstrap: the first self-affine replica may land
                if pod.namespace in self._term_namespaces(term, pod) \
                        and term.matches(pod.labels):
                    continue
                return unschedulable(
                    "no pod matches required affinity term", self.name)
            if not any(self._domain_of(n, term.topology_key) == domain
                       for n in holders):
                return unschedulable(
                    "required pod affinity not satisfied in domain",
                    self.name, evict_curable=False)
        # required anti-affinity (incoming repels existing)
        for term in pod.pod_anti_affinity:
            domain = self._domain_of(node.name, term.topology_key)
            if domain is None:
                continue   # k8s: absent key -> term cannot match
            for n in self._matching_assigned(term, pod, task.uid):
                if self._domain_of(n, term.topology_key) == domain:
                    return unschedulable(
                        "pod would violate anti-affinity", self.name,
                        evict_curable=True)
        # SYMMETRIC required anti-affinity (existing repel incoming):
        # which holders' terms match the incoming pod is NODE-
        # INDEPENDENT, so that prefilter is memoized per task — the
        # per-node loop pays only the two domain lookups
        for holder_node, topology_key in self._repelling_terms(task):
            domain = self._domain_of(node.name, topology_key)
            if domain is not None and domain == \
                    self._domain_of(holder_node, topology_key):
                return unschedulable(
                    "existing pod's anti-affinity repels this pod",
                    self.name, evict_curable=True)
        return None

    def _repelling_terms(self, task: TaskInfo):
        """(holder_node, topology_key) pairs whose anti-affinity terms
        match *task*'s pod — recomputed only when the holder index
        changed (a placement/eviction bumps _anti_version)."""
        cached = self._repel_cache.get(task.uid)
        if cached is not None and cached[0] == self._anti_version:
            return cached[1]
        pod = task.pod
        pairs = []
        for uid, (ns, _labels, holder_node, terms) in \
                self._anti_holders.items():
            if uid == task.uid:
                continue
            for term in terms:
                if pod.namespace not in (term.namespaces or [ns]):
                    continue
                if term.matches(pod.labels):
                    pairs.append((holder_node, term.topology_key))
        # vtplint: disable=shared-cache-unkeyed (idempotent version-stamped memo: the value is pure in task + _anti_version and published as one fully-built tuple; a racing store publishes an equal one)
        self._repel_cache[task.uid] = (self._anti_version, pairs)
        return pairs

    # -- preferred terms (scorer) --------------------------------------

    def _batch_node_order(self, task: TaskInfo,
                          nodes: List[NodeInfo]) -> Dict[str, float]:
        pod = task.pod
        if not pod.preferred_pod_affinity and \
                not pod.preferred_pod_anti_affinity:
            return {}
        # precompute each term's occupied domains once per task
        term_domains: List[Tuple[object, Set[str], float]] = []
        for sign, terms in ((+1.0, pod.preferred_pod_affinity),
                            (-1.0, pod.preferred_pod_anti_affinity)):
            for term in terms:
                domains = {
                    self._domain_of(n, term.topology_key)
                    for n in self._matching_assigned(term, pod, task.uid)}
                domains.discard(None)
                term_domains.append((term, domains, sign * term.weight))
        scores: Dict[str, float] = {}
        for node in nodes:
            s = 0.0
            for term, domains, weight in term_domains:
                domain = self._domain_of(node.name, term.topology_key)
                if domain is not None and domain in domains:
                    s += weight
            scores[node.name] = self.weight * s
        return scores

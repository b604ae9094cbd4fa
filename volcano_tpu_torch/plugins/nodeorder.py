"""Nodeorder plugin — node scoring.

Reference parity: plugins/nodeorder/nodeorder.go:51-66,191,197.  The
reference wraps eight upstream k8s scorers behind per-scorer weights;
here the resource-shape scorers (leastrequested / mostrequested /
balancedresource) plus nodeaffinity (preferred terms), tainttoleration
(PreferNoSchedule) and imagelocality are computed natively.  The two
remaining reference keys live in their dedicated plugins, which score
independently on the same session: podaffinity.weight ->
plugins/interpodaffinity.py, podtopologyspread.weight ->
plugins/predicates.py (pod-topology-spread).
"""

from __future__ import annotations

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

MAX_SCORE = 100.0


@register_plugin("nodeorder")
class NodeOrderPlugin(Plugin):
    name = "nodeorder"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.least_weight = float(self.arguments.get("leastrequested.weight", 1))
        self.most_weight = float(self.arguments.get("mostrequested.weight", 0))
        self.balanced_weight = float(self.arguments.get(
            "balancedresource.weight", 1))
        self.node_affinity_weight = float(self.arguments.get(
            "nodeaffinity.weight", 1))
        self.taint_toleration_weight = float(self.arguments.get(
            "tainttoleration.weight", 1))
        self.image_locality_weight = float(self.arguments.get(
            "imagelocality.weight", 1))
        # measured DCN pressure (agent BandwidthReports folded into
        # node annotations): keep NEW online pods off saturated hosts
        self.bandwidth_weight = float(self.arguments.get(
            "bandwidth.weight", 1))

    def on_session_open(self, ssn):
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_node_order_prepare_fn(self.name, self._prepare)

    def _prepare(self, task: TaskInfo):
        """Batched form of _score (PreScore): hoists every task-side
        constant — request dims, affinity terms, tolerations, image
        set, QoS — once per sweep and folds the five sub-scorers into
        one closure.  MUST stay score-identical to _score
        (tests/test_sweep.py pins the equivalence)."""
        from volcano_tpu_torch.api.netusage import NODE_SATURATED_ANNOTATION
        from volcano_tpu_torch.api.types import (QOS_BEST_EFFORT,
                                           QOS_LEVEL_ANNOTATION)
        least_w, most_w = self.least_weight, self.most_weight
        balanced_w = self.balanced_weight
        affinity_w = self.node_affinity_weight
        taint_w = self.taint_toleration_weight
        image_w = self.image_locality_weight
        bandwidth_w = self.bandwidth_weight
        req_get = task.resreq.res.get
        terms = task.pod.preferred_node_affinity \
            if affinity_w else None
        terms_total = sum(max(0, t.weight) for t in terms) \
            if terms else 0
        tolerations = task.pod.tolerations
        images = {c.image for c in task.pod.containers if c.image} \
            if image_w else None
        is_be = task.pod.annotations.get(QOS_LEVEL_ANNOTATION) == \
            QOS_BEST_EFFORT

        def score(node: NodeInfo) -> float:
            s = 0.0
            fracs = []
            used_get = node.used.res.get
            for dim, alloc in node.allocatable.res.items():
                if alloc < MIN_RESOURCE:
                    continue
                frac = min(1.0, (used_get(dim, 0.0) +
                                 req_get(dim, 0.0)) / alloc)
                fracs.append(frac)
                if least_w:
                    s += least_w * MAX_SCORE * (1.0 - frac)
                if most_w:
                    s += most_w * MAX_SCORE * frac
            n = len(fracs)
            if balanced_w and n > 1:
                # hand-rolled mean/variance: the genexpr closures were
                # a measurable slice of the batched sweep at 1k hosts
                total = 0.0
                for f in fracs:
                    total += f
                mean = total / n
                variance = 0.0
                for f in fracs:
                    d = f - mean
                    variance += d * d
                variance /= n
                s += balanced_w * MAX_SCORE * (1.0 - variance)
            if terms and terms_total > 0:
                labels = node.labels
                got = sum(max(0, t.weight) for t in terms
                          if t.matches(labels))
                s += affinity_w * MAX_SCORE * got / terms_total
            if taint_w:
                prefer = [t for t in node.taints
                          if t.effect == "PreferNoSchedule"]
                if not prefer:
                    s += taint_w * MAX_SCORE
                else:
                    intolerable = sum(
                        1 for taint in prefer
                        if not any(tol.tolerates(taint)
                                   for tol in tolerations))
                    s += taint_w * MAX_SCORE * \
                        (1.0 - intolerable / len(prefer))
            if image_w and images and node.node is not None and \
                    node.node.images:
                present = images.intersection(node.node.images)
                s += image_w * MAX_SCORE * len(present) / len(images)
            if bandwidth_w:
                if node.node is None or node.node.annotations.get(
                        NODE_SATURATED_ANNOTATION) != "true" or is_be:
                    s += bandwidth_w * MAX_SCORE
            return s

        return score

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        score = self._resource_score(task, node)
        if self.node_affinity_weight:
            score += self.node_affinity_weight * \
                self._node_affinity_score(task, node)
        if self.taint_toleration_weight:
            score += self.taint_toleration_weight * \
                self._taint_toleration_score(task, node)
        if self.image_locality_weight:
            score += self.image_locality_weight * \
                self._image_locality_score(task, node)
        if self.bandwidth_weight:
            score += self.bandwidth_weight * \
                self._bandwidth_score(task, node)
        return score

    def _resource_score(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        fracs = []
        for dim, alloc in node.allocatable.res.items():
            if alloc < MIN_RESOURCE:
                continue
            used = node.used.get(dim) + task.resreq.get(dim)
            frac = min(1.0, used / alloc)
            fracs.append(frac)
            if self.least_weight:
                score += self.least_weight * MAX_SCORE * (1.0 - frac)
            if self.most_weight:
                score += self.most_weight * MAX_SCORE * frac
        if self.balanced_weight and len(fracs) > 1:
            mean = sum(fracs) / len(fracs)
            variance = sum((f - mean) ** 2 for f in fracs) / len(fracs)
            score += self.balanced_weight * MAX_SCORE * (1.0 - variance)
        return score

    def _node_affinity_score(self, task: TaskInfo, node: NodeInfo) -> float:
        """Preferred node-affinity terms: fraction of total term weight
        satisfied by this node's labels (k8s NodeAffinity priority)."""
        terms = task.pod.preferred_node_affinity
        if not terms:
            return 0.0
        total = sum(max(0, t.weight) for t in terms)
        if total <= 0:
            return 0.0
        got = sum(max(0, t.weight) for t in terms
                  if t.matches(node.labels))
        return MAX_SCORE * got / total

    def _taint_toleration_score(self, task: TaskInfo, node: NodeInfo) -> float:
        """Fewer intolerable PreferNoSchedule taints -> higher score
        (k8s TaintToleration priority; NoSchedule taints are handled by
        the predicates plugin as a hard filter)."""
        prefer = [t for t in node.taints if t.effect == "PreferNoSchedule"]
        if not prefer:
            return MAX_SCORE
        tols = task.pod.tolerations
        intolerable = sum(
            1 for taint in prefer
            if not any(tol.tolerates(taint) for tol in tols))
        return MAX_SCORE * (1.0 - intolerable / len(prefer))

    def _bandwidth_score(self, task: TaskInfo, node: NodeInfo) -> float:
        """Penalize placing ONLINE pods onto DCN-saturated hosts.

        The agents measure per-pod rates and the store folds each
        node's summary into annotations (api/netusage.py); a node
        with no accounting deployed scores full marks (a uniform
        shift that cannot reorder nodes).  A saturated host scores 0
        for online (non-BE) pods — their bandwidth guarantee is
        already not holding there; offline pods keep full score (the
        per-pod HTB caps shape them wherever they land, and pushing
        BE work away from saturated hosts is bandwidthPressure's
        job, with hysteresis, not the scorer's)."""
        from volcano_tpu_torch.api.netusage import NODE_SATURATED_ANNOTATION
        from volcano_tpu_torch.api.types import (QOS_BEST_EFFORT,
                                           QOS_LEVEL_ANNOTATION)
        if node.node is None or node.node.annotations.get(
                NODE_SATURATED_ANNOTATION) != "true":
            return MAX_SCORE
        if task.pod.annotations.get(QOS_LEVEL_ANNOTATION) == \
                QOS_BEST_EFFORT:
            return MAX_SCORE
        return 0.0

    def _image_locality_score(self, task: TaskInfo, node: NodeInfo) -> float:
        """Fraction of the pod's container images already present on the
        node (k8s ImageLocality priority over NodeStatus.Images)."""
        images = {c.image for c in task.pod.containers if c.image}
        if not images or node.node is None or not node.node.images:
            return 0.0
        present = images.intersection(node.node.images)
        return MAX_SCORE * len(present) / len(images)

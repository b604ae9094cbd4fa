"""Data-locality plugin — schedule near the training data.

Reference parity: staging/.../datadependency/v1alpha1 (DataSource /
DataSourceClaim CRDs feeding data-locality scheduling).  Standalone
model: datasets register their locations on the cluster
(cluster.datasources: name -> {"nodes": [...], "zones": [...]}) and
pods claim them via annotation:

  data.volcano-tpu.io/claims: "imagenet,checkpoints"

Nodes holding (or zone-near) the claimed data score higher; a `hard`
claim mode makes it a predicate.
"""

from __future__ import annotations

from typing import Dict, List

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

CLAIMS_ANNOTATION = "data.volcano-tpu.io/claims"
CLAIM_MODE_ANNOTATION = "data.volcano-tpu.io/claim-mode"  # soft | hard
ZONE_LABEL = "topology.kubernetes.io/zone"
MAX_SCORE = 100.0


@register_plugin("datalocality")
class DataLocalityPlugin(Plugin):
    name = "datalocality"

    def on_session_open(self, ssn):
        self.ssn = ssn
        self.sources: Dict[str, dict] = dict(
            getattr(ssn.cache.cluster, "datasources", {}) or {})
        if not self.sources:
            return
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)

    @staticmethod
    def _claims(task: TaskInfo) -> List[str]:
        raw = task.pod.annotations.get(CLAIMS_ANNOTATION, "")
        return [c.strip() for c in raw.split(",") if c.strip()]

    def _locality(self, claim: str, node: NodeInfo) -> float:
        """1.0 = data on node, 0.5 = same zone, 0 = remote."""
        src = self.sources.get(claim)
        if src is None:
            return 0.0
        if node.name in src.get("nodes", ()):
            return 1.0
        zone = node.labels.get(ZONE_LABEL)
        if zone and zone in src.get("zones", ()):
            return 0.5
        return 0.0

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        claims = self._claims(task)
        if not claims:
            return None
        if task.pod.annotations.get(CLAIM_MODE_ANNOTATION) != "hard":
            return None
        for claim in claims:
            if claim in self.sources and \
                    self._locality(claim, node) == 0.0:
                return unschedulable(
                    f"node has no locality to claimed data {claim!r}",
                    "datalocality")
        return None

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        claims = self._claims(task)
        if not claims:
            return 0.0
        total = sum(self._locality(c, node) for c in claims)
        return MAX_SCORE * total / len(claims)

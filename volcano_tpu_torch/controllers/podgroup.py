"""PodGroup controller — auto-create groups for bare pods.

Reference parity: pkg/controllers/podgroup/pg_controller_handler.go:
222,301 (normal pods / Deployment replicas get a generated PodGroup so
gang machinery applies uniformly; annotations inherited upward).
"""

from __future__ import annotations

import logging

from volcano_tpu_torch.api.podgroup import PodGroup
from volcano_tpu_torch.api.types import (
    DEFAULT_QUEUE,
    GROUP_NAME_ANNOTATION,
    QUEUE_NAME_ANNOTATION,
)
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

GENERATED_PREFIX = "podgroup-"


@register_controller("podgroup")
class PodGroupController(Controller):
    name = "podgroup"

    scheduler_name = "volcano-tpu"

    def sync(self) -> None:
        snap = self.cluster.list_all()
        pg_keys = {pg.key for pg in snap.podgroups}
        for pod in snap.pods:
            if pod.scheduler_name != self.scheduler_name:
                continue
            if pod.owner or pod.annotations.get(GROUP_NAME_ANNOTATION):
                continue
            name = f"{GENERATED_PREFIX}{pod.uid}"
            key = f"{pod.namespace}/{name}"
            if key not in pg_keys:
                pg = PodGroup(
                    name=name, namespace=pod.namespace,
                    min_member=1,
                    queue=pod.annotations.get(QUEUE_NAME_ANNOTATION,
                                              DEFAULT_QUEUE),
                    priority_class=pod.priority_class,
                )
                pg.annotations.update(pod.annotations)
                self.cluster.add_podgroup(pg)
                pg_keys.add(key)
            pod.annotations[GROUP_NAME_ANNOTATION] = name

    def on_event(self, kind: str, obj):
        # only bare pods (no owner, no group) warrant a reconcile —
        # controller-built pods would otherwise trigger O(N^2) syncs
        if kind == "pod" and not getattr(obj, "owner", None) and \
                not obj.annotations.get(GROUP_NAME_ANNOTATION):
            self.sync()

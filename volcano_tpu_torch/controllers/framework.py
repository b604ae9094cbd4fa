"""Controller framework (reference: pkg/controllers/framework/interface.go).

Controllers are reconcilers: each sync() pass drives cluster state
toward spec.  The manager runs registered controllers either on a
period or in response to cluster watch events.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.cache.cluster import Cluster

log = logging.getLogger(__name__)


class Controller:
    name = "controller"

    def initialize(self, cluster: Cluster) -> None:
        self.cluster = cluster

    def sync(self) -> None:
        """One reconcile pass over owned objects."""
        raise NotImplementedError

    def on_event(self, kind: str, obj) -> None:  # noqa: B027
        """Optional fast-path reaction to a watch event."""


CONTROLLERS: Dict[str, Callable[[], Controller]] = {}


def register_controller(name: str, builder: Optional[Callable[[], Controller]] = None):
    def _do(b):
        CONTROLLERS[name] = b
        return b
    if builder is not None:
        return _do(builder)
    return _do


class ControllerManager:
    """Runs controllers (reference: cmd/controller-manager)."""

    def __init__(self, cluster: Cluster,
                 enabled: Optional[List[str]] = None,
                 overrides: Optional[Dict[str, Callable[[], Controller]]]
                 = None):
        """overrides: per-instance builder replacements (e.g. a
        hypernode controller with a non-default discoverer) — scoped to
        this manager, never the process-global registry."""
        self.cluster = cluster
        self.controllers: List[Controller] = []
        names = enabled if enabled is not None else list(CONTROLLERS)
        overrides = overrides or {}
        # controller-level feature gates (pkg/features/volcano_features.go)
        from volcano_tpu_torch import features
        gated = {"cronjob": "CronVolcanoJobSupport",
                 "podgroup": "WorkLoadSupport",
                 "job": "VolcanoJobSupport"}
        for name in names:
            gate = gated.get(name)
            if gate is not None and not features.enabled(gate):
                log.info("controller %s disabled by feature gate %s",
                         name, gate)
                continue
            builder = overrides.get(name) or CONTROLLERS.get(name)
            if builder is None:
                log.warning("unknown controller %s", name)
                continue
            c = builder()
            c.initialize(cluster)
            self.controllers.append(c)
        cluster.watch(self._on_event)
        self._stop = threading.Event()

    def _on_event(self, kind: str, obj):
        for c in self.controllers:
            try:
                c.on_event(kind, obj)
            except Exception:  # noqa: BLE001
                log.exception("controller %s event handler failed", c.name)

    def sync_all(self):
        for c in self.controllers:
            try:
                c.sync()
            except Exception:  # noqa: BLE001
                log.exception("controller %s sync failed", c.name)

    def run(self, period: float = 1.0, max_rounds: Optional[int] = None):
        rounds = 0
        while not self._stop.is_set():
            self.sync_all()
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
            self._stop.wait(period)

    def stop(self):
        self._stop.set()
        self.cluster.unwatch(self._on_event)

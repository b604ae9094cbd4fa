"""Colocation config controller — push QoS settings to node agents.

Reference parity: pkg/controllers/colocationconfig (watches the
colocation ConfigMap and distributes per-node QoS config).  Agents
register with the controller; config lives in the cluster config map
"colocation/config" with keys:
  oversub-factor, eviction-threshold (floats)
"""

from __future__ import annotations

import logging
from typing import List

from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

CONFIG_KEY = "colocation/config"


@register_controller("colocationconfig")
class ColocationConfigController(Controller):
    name = "colocationconfig"

    def __init__(self):
        self.agents: List[object] = []   # NodeAgent instances

    def register_agent(self, agent) -> None:
        self.agents.append(agent)

    def sync(self) -> None:
        cfg = getattr(self.cluster, "config_maps", {}).get(CONFIG_KEY)
        if not cfg:
            return
        # parse the whole config first so a half-invalid map never
        # leaves agents with a mixed old/new setting combination
        try:
            parsed = {}
            if "oversub-factor" in cfg:
                parsed["oversub_factor"] = float(cfg["oversub-factor"])
            if "eviction-threshold" in cfg:
                parsed["eviction_threshold"] = float(
                    cfg["eviction-threshold"])
        except (TypeError, ValueError):
            log.warning("invalid colocation config ignored: %s", cfg)
            return
        for agent in self.agents:
            for attr, value in parsed.items():
                setattr(agent, attr, value)

    def on_event(self, kind: str, obj):
        pass

"""Node agent (reference: pkg/agent + pkg/metriccollect)."""

from volcano_tpu_torch.agent.agent import (
    FakeUsageProvider,
    NodeAgent,
    UsageProvider,
)
from volcano_tpu_torch.agent.collect import (
    Collector,
    CompositeUsageProvider,
    build_provider,
    register_collector,
)
from volcano_tpu_torch.agent.framework import (
    Event,
    Handler,
    register_handler,
    registered_handlers,
)
from volcano_tpu_torch.agent import handlers as _handlers  # noqa: F401 — registers
                                                     # the default pipeline

__all__ = [
    "NodeAgent", "UsageProvider", "FakeUsageProvider",
    "Collector", "CompositeUsageProvider", "build_provider",
    "register_collector", "Event", "Handler", "register_handler",
    "registered_handlers",
]

"""Plugin / Action interfaces + registries.

Reference parity: pkg/scheduler/framework/interface.go:30,45 and
plugins.go (RegisterPluginBuilder), actions/factory.go.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from volcano_tpu_torch.framework.session import Session  # noqa: F401


class Plugin:
    """A scheduling policy: registers callbacks into the Session."""

    name = "plugin"

    def __init__(self, arguments: Optional[dict] = None):
        self.arguments = dict(arguments or {})

    def on_session_open(self, ssn: "Session") -> None:
        raise NotImplementedError

    def on_session_close(self, ssn: "Session") -> None:  # noqa: B027
        pass


class Action:
    """One step of the scheduling cycle's algorithm skeleton."""

    name = "action"

    def initialize(self) -> None:  # noqa: B027
        pass

    def execute(self, ssn: "Session") -> None:
        raise NotImplementedError

    def uninitialize(self) -> None:  # noqa: B027
        pass


PLUGIN_BUILDERS: Dict[str, Callable[[dict], Plugin]] = {}
ACTIONS: Dict[str, Action] = {}


def register_plugin(name: str, builder: Optional[Callable[[dict], Plugin]] = None):
    """Register a plugin builder; usable as a class decorator."""
    def _do(b):
        PLUGIN_BUILDERS[name] = b
        return b
    if builder is not None:
        return _do(builder)
    return _do


def register_action(action: Action):
    ACTIONS[action.name] = action
    return action


def get_plugin_builder(name: str) -> Optional[Callable[[dict], Plugin]]:
    _ensure_registered()
    return PLUGIN_BUILDERS.get(name)


def get_action(name: str) -> Optional[Action]:
    _ensure_registered()
    return ACTIONS.get(name)


_registered = False


def _ensure_registered():
    """Import the plugin/action packages once so their registration
    side effects run (reference: factory.go blank imports)."""
    global _registered
    if _registered:
        return
    _registered = True
    import volcano_tpu_torch.plugins   # noqa: F401
    import volcano_tpu_torch.actions   # noqa: F401

"""Scheduler framework (reference: pkg/scheduler/framework)."""

from volcano_tpu_torch.framework.plugins import (
    Plugin, Action, register_plugin, register_action, get_plugin_builder,
    get_action, PLUGIN_BUILDERS, ACTIONS,
)
from volcano_tpu_torch.framework.session import Session
from volcano_tpu_torch.framework.statement import Statement, Operation
from volcano_tpu_torch.framework.framework import open_session, close_session

__all__ = [
    "Plugin", "Action", "register_plugin", "register_action",
    "get_plugin_builder", "get_action", "PLUGIN_BUILDERS", "ACTIONS",
    "Session", "Statement", "Operation", "open_session", "close_session",
]

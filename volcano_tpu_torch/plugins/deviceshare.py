"""Deviceshare plugin — bridges the device layer into filter + score.

Reference parity: plugins/deviceshare/deviceshare.go:233-285 (Predicate
+ NodeOrder over api.Devices).  Importing this module registers the GPU
device factory with the cache so every NodeInfo gets enriched.
"""

from __future__ import annotations

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin


@register_plugin("deviceshare")
class DeviceSharePlugin(Plugin):
    name = "deviceshare"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.gpu_weight = float(self.arguments.get("deviceshare.gpu.weight", 1))

    def on_session_open(self, ssn):
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_predicate_prepare_fn(self.name, self._prepare_predicate)
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_node_order_prepare_fn(self.name, self._prepare_score)

    @staticmethod
    def _predicate(task: TaskInfo, node: NodeInfo):
        for dev in node.others.values():
            if hasattr(dev, "has_device_request") and \
                    dev.has_device_request(task):
                status = dev.filter_node(task)
                if status is not None:
                    return status
        return None

    @staticmethod
    def _prepare_predicate(task: TaskInfo):
        """Batched _predicate (PreFilter): whether the task requests
        any device is task-only — a deviceless task skips the whole
        per-node device walk (equivalence pinned in test_sweep.py)."""
        def check(node: NodeInfo):
            for dev in node.others.values():
                if hasattr(dev, "has_device_request") and \
                        dev.has_device_request(task):
                    status = dev.filter_node(task)
                    if status is not None:
                        return status
            return None

        def no_request(node: NodeInfo):
            return None

        probe = DeviceSharePlugin._requests_any_device(task)
        return check if probe else no_request

    @staticmethod
    def _requests_any_device(task: TaskInfo) -> bool:
        """True unless EVERY registered device class proves (via its
        class-level task_requests_device probe) that the task asks
        for none of it.  A device class without the probe keeps the
        full per-node walk — the fast path must never skip a device
        it cannot reason about."""
        from volcano_tpu_torch.cache.cache import REGISTERED_DEVICES
        for factory in REGISTERED_DEVICES.values():
            probe = getattr(factory, "task_requests_device", None)
            if probe is None or probe(task):
                return True
        return False

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        total = 0.0
        for dev in node.others.values():
            if hasattr(dev, "has_device_request") and \
                    dev.has_device_request(task):
                total += self.gpu_weight * dev.score_node(task)
        return total

    def _prepare_score(self, task: TaskInfo):
        """Batched _score (PreScore), same fast path as the
        predicate's prepared form."""
        weight = self.gpu_weight

        def score(node: NodeInfo) -> float:
            total = 0.0
            for dev in node.others.values():
                if hasattr(dev, "has_device_request") and \
                        dev.has_device_request(task):
                    total += weight * dev.score_node(task)
            return total

        def zero(node: NodeInfo) -> float:
            return 0.0

        return score if self._requests_any_device(task) else zero

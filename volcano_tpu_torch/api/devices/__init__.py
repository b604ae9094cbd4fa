"""Pluggable device layer (reference: pkg/scheduler/api/shared_device_pool.go).

A Devices implementation owns the per-node accounting for one device
class.  The deviceshare plugin bridges these into predicate + score
callbacks.  The NVIDIA GPU is the first-class device here (reference
ships nvidia vGPU/gpushare + Ascend NPU; this model keeps whole GPUs
with atomic NVLink-domain host semantics, no memory/core sharing).
"""

from __future__ import annotations

import abc
from typing import Optional

from volcano_tpu_torch.api.fit_error import Status


class Devices(abc.ABC):
    """Per-node device state (shared_device_pool.go:33 Devices iface)."""

    name = "device"

    @abc.abstractmethod
    def has_device_request(self, task) -> bool:
        """Does this task ask for this device class?"""

    @abc.abstractmethod
    def filter_node(self, task) -> Optional[Status]:
        """None if the node can serve the task's device request."""

    @abc.abstractmethod
    def score_node(self, task) -> float:
        """Device-aware node score (higher is better)."""


from volcano_tpu_torch.api.devices.gpu.device_info import GPUDevices  # noqa: E402,F401

"""GPU NVLink-domain device model."""

from volcano_tpu_torch.api.devices.gpu.topology import (
    DomainTopology, parse_topology, domain_for, hop_distance,
)
from volcano_tpu_torch.api.devices.gpu.device_info import GPUDevices

__all__ = ["DomainTopology", "parse_topology", "domain_for",
           "hop_distance", "GPUDevices"]

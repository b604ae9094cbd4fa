"""GPU device accounting for one node.

Reference parity: pkg/scheduler/api/devices/nvidia/vgpu/device_info.go
(GPUDevices implementing the Devices interface), with the TPU slice
rule of `volcano_tpu`'s TPUDevices carried over to NVLink domains: GPUs
are NOT shareable or partitionable at schedule time; a host in a
multi-host NVLink domain must be consumed whole (all its GPUs by one
pod) because the NCCL job owns the domain; single-host domains may pack
several small pods at 1, 2, 4 or 8 GPUs.
"""

from __future__ import annotations

import logging
from typing import Optional

from volcano_tpu_torch.api.devices import Devices
from volcano_tpu_torch.api.fit_error import Status, unschedulable
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import GPU_PRODUCT_LABEL
from volcano_tpu_torch.api.devices.gpu.topology import (DomainTopology,
                                                        parse_topology)

log = logging.getLogger(__name__)

_VALID_SUBHOST_GPUS = {1, 2, 4, 8}


class GPUDevices(Devices):
    name = "gpu"

    def __init__(self, node_info):
        self.node = node_info
        # the label-derived identity is static per Node object (watch
        # events replace nodes wholesale), so memoize it there — same
        # pattern as node_info._parsed_res
        raw = node_info.node
        static = raw.__dict__.get("_gpu_static") if raw else None
        if static is None:
            domain_name = node_info.nvlink_domain
            product = node_info.labels.get(GPU_PRODUCT_LABEL, "")
            shape = parse_topology(node_info.domain_shape)
            static = (domain_name, product, shape, node_info.host_index,
                      DomainTopology(domain_name, product, *shape)
                      if shape else None)
            if raw is not None:
                raw._gpu_static = static
        (self.domain_name, self.product, self.shape,
         self.host_index, self.domain) = static
        self.gpus_total = node_info.allocatable.get(GPU)

    @property
    def gpus_free(self) -> float:
        return self.node.idle.get(GPU)

    @property
    def gpus_free_future(self) -> float:
        """Free GPUs once in-flight releases complete — the filter must
        not veto placements that pipeline onto releasing hosts
        (preempt/reclaim victims)."""
        return self.node.future_idle().get(GPU)

    @property
    def is_gpu_node(self) -> bool:
        return self.gpus_total > 0

    def has_device_request(self, task) -> bool:
        return task.resreq.get(GPU) > 0

    @staticmethod
    def task_requests_device(task) -> bool:
        """Class-level twin of has_device_request (the request is
        task-only for GPUs): lets deviceshare's prepared sweep skip
        the per-node device walk for GPU-less tasks."""
        return task.resreq.get(GPU) > 0

    def filter_node(self, task) -> Optional[Status]:
        req = task.resreq.get(GPU)
        if req <= 0:
            return None
        if not self.is_gpu_node:
            return unschedulable("node has no GPUs", "gpu",
                                 resolvable=False)
        if self.domain and self.domain.is_multi_host:
            # multi-host NVLink domain: a pod takes a whole host's GPUs
            # — the NCCL job on each host drives all local GPUs.
            if req != self.domain.gpus_per_host:
                return unschedulable(
                    f"multi-host NVLink domain requires whole-host "
                    f"requests of {self.domain.gpus_per_host} GPUs, "
                    f"got {req:g}", "gpu", resolvable=False)
            if self.gpus_free_future < req:
                # evicting the occupant frees the whole host — preempt/
                # reclaim may wave this through and re-check post-evict
                return unschedulable(
                    "GPU host already occupied", "gpu",
                    evict_curable=True)
        else:
            if req not in _VALID_SUBHOST_GPUS:
                return unschedulable(
                    f"invalid GPU request {req:g} "
                    f"(must be one of {sorted(_VALID_SUBHOST_GPUS)})",
                    "gpu", resolvable=False)
            if req > self.gpus_total:
                return unschedulable(
                    f"node has only {self.gpus_total:g} GPUs",
                    "gpu", resolvable=False)
            if req > self.gpus_free_future:
                return unschedulable("not enough free GPUs", "gpu",
                                     evict_curable=True)
        return None

    def score_node(self, task) -> float:
        """Pack partially-used single-host domains first so whole hosts
        (and whole domains) stay free for gang jobs."""
        req = task.resreq.get(GPU)
        if req <= 0 or not self.is_gpu_node:
            return 0.0
        used_frac = 1.0 - (self.gpus_free / self.gpus_total
                           if self.gpus_total else 0.0)
        return 100.0 * used_frac

"""Numatopology — per-node NUMA inventory object.

Reference parity: staging nodeinfo/v1alpha1 Numatopology CRD
(numatopology_types.go: spec.policies, spec.numares with per-NUMA
allocatable, spec.resReserved) consumed by plugins/numaaware.
GPU-first reading: on a GPU host the inventory that matters is which
cpu NUMA node each PCIe switch's GPUs hang off, so `numa_res` carries
both "cpu" (millicores) and "nvidia.com/gpu" per NUMA cell.

The node agent (or a kubelet shim) publishes one Numatopology per
node; the numaaware plugin prefers it over the legacy annotation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from volcano_tpu_torch.api.resource import GPU

# node-side kubelet policies, mirroring the reference's spec.policies
TOPOLOGY_MANAGER_POLICY = "TopologyManagerPolicy"
CPU_MANAGER_POLICY = "CPUManagerPolicy"

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA = "single-numa-node"


@dataclass
class Numatopology:
    """NUMA inventory of one node (name == node name).

    `numa_res` carries the node's CURRENT free amount per cell as of
    the exporter's last refresh (reference semantics: the
    resource-exporter republishes from live cgroup state) — not the
    static capacity.  The numaaware plugin layers its own in-session
    deductions on top, so placements made between refreshes are
    accounted for too.
    """

    name: str
    # resource -> numa cell id -> CURRENTLY FREE amount
    # (cpu in MILLIcores to match Resource's internal unit)
    numa_res: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # kubelet policies: {"TopologyManagerPolicy": "single-numa-node", ...}
    policies: Dict[str, str] = field(default_factory=dict)
    # resources the kubelet holds back per node (not per cell)
    res_reserved: Dict[str, float] = field(default_factory=dict)
    # static per-cell capacity; when set, the node agent acts as the
    # exporter and recomputes numa_res from it each sync (see
    # recompute_free)
    capacity_res: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def cell_free(self, resource: str, cell: str) -> float:
        return self.numa_res.get(resource, {}).get(cell, 0.0)

    def cells(self):
        out = set()
        for per_cell in self.numa_res.values():
            out.update(per_cell)
        return sorted(out)

    def recompute_free(self, pod_requests) -> None:
        """Exporter refresh: numa_res = capacity_res minus the running
        pods' requests packed with deduct_request — the SAME algorithm
        the numaaware plugin applies in-session, so the exporter's
        published free cells and the scheduler's deductions agree by
        construction.  pod_requests: iterable of (cpu_millis, gpus).

        No-op when capacity_res is unset — then numa_res is operator-
        published and whoever publishes it owns its freshness.
        """
        if not self.capacity_res:
            return
        cells = sorted({c for per in self.capacity_res.values()
                        for c in per})
        free = [[self.capacity_res.get("cpu", {}).get(c, 0.0),
                 self.capacity_res.get(GPU, {}).get(c, 0.0)]
                for c in cells]
        for cpu_m, gpu in sorted(pod_requests,
                                 key=lambda r: -(r[0] + r[1])):
            deduct_request(free, cpu_m, gpu)
        # only the two tracked resources are recomputed; anything else
        # published in capacity_res (or operator-set in numa_res) is
        # carried through untouched rather than dropped
        recomputed = {
            "cpu": {c: free[i][0] for i, c in enumerate(cells)},
            GPU: {c: free[i][1] for i, c in enumerate(cells)},
        }
        for res, per_cell in self.capacity_res.items():
            if res not in recomputed:
                recomputed[res] = dict(per_cell)
        for res, per_cell in self.numa_res.items():
            if res not in recomputed:
                recomputed[res] = per_cell
        self.numa_res = recomputed


def deduct_request(cells, need_cpu: float, need_gpu: float):
    """Deduct one request from `cells` ([[cpu_free, gpu_free], ...])
    in place: best-fit into the tightest cell that holds it whole,
    else drain largest-first (how the kubelet would spread a request
    no single cell can satisfy).  Returns [(index, dcpu, dgpu)]
    actually taken — the exact-reversal record.

    Single source of truth for the packing heuristic: the numaaware
    plugin's in-session deductions and the node agent's exporter
    refresh both call this, so their views never drift.
    """
    taken = []
    fitting = [(cpu + gpu, i) for i, (cpu, gpu) in enumerate(cells)
               if need_cpu <= cpu and need_gpu <= gpu]
    if fitting:
        _, i = min(fitting)
        cells[i][0] -= need_cpu
        cells[i][1] -= need_gpu
        taken.append((i, need_cpu, need_gpu))
        return taken
    for i in sorted(range(len(cells)),
                    key=lambda j: -(cells[j][0] + cells[j][1])):
        if need_cpu <= 0 and need_gpu <= 0:
            break
        d_cpu = min(need_cpu, cells[i][0])
        d_gpu = min(need_gpu, cells[i][1])
        if d_cpu <= 0 and d_gpu <= 0:
            continue
        cells[i][0] -= d_cpu
        cells[i][1] -= d_gpu
        need_cpu -= d_cpu
        need_gpu -= d_gpu
        taken.append((i, d_cpu, d_gpu))
    return taken


def gpu_host_numatopology(node_name: str, cpu_millis: float,
                          gpus: int, numa_cells: int = 2,
                          policy: str = POLICY_BEST_EFFORT) -> Numatopology:
    """Fresh-host inventory for a typical GPU host: GPUs and cores
    split evenly across NUMA cells (an HGX H100 host is 2-socket, 4
    GPUs per socket).  "Fresh" = everything free; an exporter
    republishing for a busy host passes live free values."""
    cells = [str(i) for i in range(max(1, numa_cells))]
    per_cpu = cpu_millis / len(cells)
    base, extra = divmod(gpus, len(cells))
    numa_res = {
        "cpu": {c: per_cpu for c in cells},
        GPU: {c: float(base + (1 if i < extra else 0))
              for i, c in enumerate(cells)},
    }
    return Numatopology(name=node_name, numa_res=numa_res,
                        policies={TOPOLOGY_MANAGER_POLICY: policy},
                        capacity_res={k: dict(v)
                                      for k, v in numa_res.items()})

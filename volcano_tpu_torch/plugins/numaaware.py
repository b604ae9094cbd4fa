"""Numaaware plugin — host-to-GPU locality on GPU hosts.

Reference parity: plugins/numaaware/numaaware.go:85,169,191 (NUMA fit
from the Numatopology CRD with topology-manager policies).  GPU-first
reading: on an HGX host the relevant locality is cpu-NUMA-node to the
GPUs behind its PCIe switches (api/numatopology.py,
gpu_host_numatopology: 2 cells of 4).

Inventory sources, in preference order:
  1. a `Numatopology` object published per node
     (cluster.numatopologies[node] — api/numatopology.py).  Its
     `numa_res` carries the node's CURRENT per-cell free amounts as
     published by the node agent/exporter (reference semantics: the
     resource-exporter refreshes the CRD from live cgroup state);
     `res_reserved` is spread evenly across cells and subtracted.
  2. legacy node annotation  numa.volcano-tpu.io/nodes:
      '{"0": {"cpu": 4, "gpu": 4}, "1": {"cpu": 4, "gpu": 4}}'

Between exporter refreshes the scheduler may place several pods on the
same node in one session, so the plugin keeps a session-local copy of
each node's cells and deducts every allocation from the best-fitting
cell (reversed exactly on deallocate) — the gate checks free space,
not capacity.

The binding policy is the node's TopologyManagerPolicy; a pod may
opt into a stricter one via  numa.volcano-tpu.io/policy:
  best-effort | restricted | single-numa-node
(restricted and single-numa-node both gate placement; best-effort
only scores — matching the reference's policy semantics.)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.api.numatopology import (
    POLICY_BEST_EFFORT,
    POLICY_NONE,
    POLICY_RESTRICTED,
    POLICY_SINGLE_NUMA,
    TOPOLOGY_MANAGER_POLICY,
    Numatopology,
    deduct_request,
)
from volcano_tpu_torch.api.resource import GPU, parse_cpu
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import EventHandler

NUMA_NODES_ANNOTATION = "numa.volcano-tpu.io/nodes"
NUMA_POLICY_ANNOTATION = "numa.volcano-tpu.io/policy"
MAX_SCORE = 100.0

_GATING = (POLICY_RESTRICTED, POLICY_SINGLE_NUMA)
_KNOWN = (POLICY_BEST_EFFORT, POLICY_RESTRICTED, POLICY_SINGLE_NUMA)


def numa_inventory(node: NodeInfo) -> Optional[Dict[str, Dict[str, float]]]:
    """Legacy annotation inventory: {cell: {"cpu": cores, "gpu": gpus}}."""
    if node.node is None:
        return None
    raw = node.node.annotations.get(NUMA_NODES_ANNOTATION)
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


@register_plugin("numaaware")
class NumaAwarePlugin(Plugin):
    name = "numaaware"

    def on_session_open(self, ssn):
        from volcano_tpu_torch import features
        if not features.enabled("ResourceTopology"):
            return   # feature-gated off (features.py)
        self._ssn = ssn
        self._topologies: Dict[str, Numatopology] = dict(
            getattr(ssn.cache.cluster, "numatopologies", {}) or {})
        # node -> [[cpu_free_millis, gpu_free], ...] live for this session
        self._cells: Dict[str, Optional[List[List[float]]]] = {}
        # node -> reserved-adjusted per-cell capacity ceilings (only
        # when the topology publishes capacity_res)
        self._cell_caps: Dict[str, List[List[float]]] = {}
        # task uid -> [(node, cell index, cpu, gpu)] for exact reversal
        self._deducted: Dict[str, List[Tuple[str, int, float, float]]] = {}
        # node -> {needs: merged hint} (see _merged_hint; dropped on
        # any cell mutation for that node)
        self._hint_cache: Dict[str, dict] = {}
        # running victims evicted this session: their consumption was
        # never in our cells (exporter free excludes running pods), so
        # eviction CREDITS their request to the least-free cell (in the
        # single-NUMA regime that is where the victim almost surely
        # sat) — letting preempt free a cell — and the matching unevict
        # on statement discard reverses the credit exactly
        self._credited: Dict[str, List[Tuple[str, int, float, float]]] = {}
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_event_handler(EventHandler(
            allocate_fn=self._on_allocate,
            deallocate_fn=self._on_deallocate))

    # -- live inventory -----------------------------------------------

    def _build_cells(self, node: NodeInfo) -> Optional[List[List[float]]]:
        topo = self._topologies.get(node.name)
        if topo is not None:
            cells = topo.cells()
            if cells:
                res_cpu = float(topo.res_reserved.get("cpu", 0.0))
                res_gpu = float(topo.res_reserved.get(GPU, 0.0))
                n = len(cells)
                if topo.capacity_res:
                    # reserved-adjusted ceilings for eviction credits
                    # vtplint: disable=shared-cache-unkeyed (idempotent per-node memo, fully built before the GIL-atomic publish; mutation paths run inside Session seams on the owner thread)
                    self._cell_caps[node.name] = [
                        [max(0.0, topo.capacity_res.get("cpu", {})
                             .get(c, 0.0) - res_cpu / n),
                         max(0.0, topo.capacity_res.get(GPU, {})
                             .get(c, 0.0) - res_gpu / n)]
                        for c in cells]
                return [[max(0.0, topo.cell_free("cpu", c) - res_cpu / n),
                         max(0.0, topo.cell_free(GPU, c) - res_gpu / n)]
                        for c in cells]
        inventory = numa_inventory(node)
        if inventory is None:
            return None
        return [[parse_cpu(numa.get("cpu", 0)), float(numa.get("gpu", 0))]
                for numa in inventory.values()]

    def _live_cells(self, node: NodeInfo) -> Optional[List[List[float]]]:
        if node.name not in self._cells:
            # vtplint: disable=shared-cache-unkeyed (idempotent per-node memo: cells are pure in unchanged node state and published fully built; allocate-path invalidation runs inside Session seams)
            self._cells[node.name] = self._build_cells(node)
        return self._cells[node.name]

    # -- allocation bookkeeping ---------------------------------------

    def _on_allocate(self, event) -> None:
        task = event.task
        credited = self._credited.pop(task.uid, None)
        if credited is not None and credited and \
                credited[0][0] == task.node_name:
            # unevict of a running victim back onto its node (statement
            # discard): reverse the eviction credit exactly
            for node_name, i, cpu, gpu in credited:
                cells = self._cells.get(node_name)
                if cells and i < len(cells):
                    cells[i][0] -= cpu
                    cells[i][1] -= gpu
                self._hint_cache.pop(node_name, None)
            return
        node = self._ssn.nodes.get(task.node_name)
        if node is None:
            return
        cells = self._live_cells(node)
        if not cells:
            return
        taken = deduct_request(cells, task.resreq.milli_cpu,
                               task.resreq.get(GPU))
        # record even an EMPTY deduction: the entry marks "allocated
        # in-session", so a later deallocate of this task reverses
        # exactly (possibly nothing) instead of falling into the
        # running-victim credit path and fabricating free space
        self._deducted.setdefault(task.uid, []).extend(
            (node.name, i, cpu, gpu) for i, cpu, gpu in taken)
        self._hint_cache.pop(node.name, None)

    def _on_deallocate(self, event) -> None:
        taken = self._deducted.pop(event.task.uid, None)
        if taken is None:
            # a RUNNING victim being evicted: its consumption is not in
            # our cells (exporter free excludes running pods), so credit
            # its request to the least-free cell — in the single-NUMA
            # regime that is where it almost surely sat — and keep the
            # record so a later unevict reverses this exactly
            task = event.task
            node = self._ssn.nodes.get(task.node_name or "")
            if node is None:
                return
            cells = self._live_cells(node)
            if not cells:
                return
            i = min(range(len(cells)),
                    key=lambda j: cells[j][0] + cells[j][1])
            cpu = task.resreq.milli_cpu
            gpu = task.resreq.get(GPU)
            caps = self._cell_caps.get(node.name)
            if caps is not None and i < len(caps):
                # a cell-spanning victim must not fabricate a phantom
                # cell bigger than physical capacity — clamp the credit
                # (and record only what was applied, so the unevict
                # reversal stays exact).  Without capacity data there
                # is no sound ceiling; the kubelet's single-NUMA
                # admission remains the final arbiter there.
                cpu = min(cpu, max(0.0, caps[i][0] - cells[i][0]))
                gpu = min(gpu, max(0.0, caps[i][1] - cells[i][1]))
            cells[i][0] += cpu
            cells[i][1] += gpu
            self._hint_cache.pop(node.name, None)
            self._credited.setdefault(task.uid, []).append(
                (node.name, i, cpu, gpu))
            return
        for node_name, i, cpu, gpu in taken:
            cells = self._cells.get(node_name)
            if cells and i < len(cells):
                cells[i][0] += cpu
                cells[i][1] += gpu
            self._hint_cache.pop(node_name, None)

    # -- policy -------------------------------------------------------

    def _node_policy(self, node: NodeInfo) -> str:
        topo = self._topologies.get(node.name)
        if topo is None:
            return POLICY_NONE
        return topo.policies.get(TOPOLOGY_MANAGER_POLICY, POLICY_NONE)

    def _effective_policy(self, task: TaskInfo, node: NodeInfo) -> str:
        """Strictest of the node's kubelet policy and the pod's opt-in."""
        pod = task.pod.annotations.get(NUMA_POLICY_ANNOTATION, POLICY_NONE)
        node_p = self._node_policy(node)
        order = (POLICY_NONE, POLICY_BEST_EFFORT, POLICY_RESTRICTED,
                 POLICY_SINGLE_NUMA)
        pod_rank = order.index(pod) if pod in order else 0
        node_rank = order.index(node_p) if node_p in order else 0
        return order[max(pod_rank, node_rank)]

    @staticmethod
    def _needs(task: TaskInfo):
        return (task.resreq.milli_cpu, task.resreq.get(GPU))

    # -- session hooks ------------------------------------------------

    def _merged_hint(self, node: NodeInfo, cells, needs):
        """Session-memoized merged hint: the subset enumeration is
        combinatorial and _predicate + _score would otherwise compute
        it twice per (task, node); cell mutations (allocate /
        deallocate / credit) invalidate the node's entries."""
        # vtplint: disable=shared-cache-unkeyed (idempotent per node+needs memo: a racing setdefault/store publishes an equal hint; invalidation runs inside Session seams on the owner thread)
        per_node = self._hint_cache.setdefault(node.name, {})
        hint = per_node.get(needs)
        if hint is None:
            from volcano_tpu_torch.plugins import numa_policy
            hint = numa_policy.merged_hint_for(cells, needs)
            per_node[needs] = hint
        return hint

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        policy = self._effective_policy(task, node)
        if policy not in _GATING:
            return None
        needs = self._needs(task)
        if all(n <= 0 for n in needs):
            # no alignable resources -> no hint providers -> admit
            # (kubelet admits hint-less pods under every policy)
            return None
        cells = self._live_cells(node)
        if cells is None:
            return None  # no topology published: don't block
        from volcano_tpu_torch.plugins import numa_policy
        hint, _ = self._merged_hint(node, cells, needs)
        if numa_policy.admit(policy, hint):
            return None
        # resolvable only if the CAPACITY view could admit — then
        # eviction can free it (see _on_deallocate crediting).  A
        # request no cell layout can ever admit cannot be cured by
        # evicting victims; marking it resolvable would make preempt
        # kill fresh victims every cycle.
        reason = ("request cannot fit a single NUMA node"
                  if policy == POLICY_SINGLE_NUMA else
                  "no preferred (minimal-width) NUMA assignment")
        return unschedulable(
            reason, "numaaware",
            resolvable=self._capacity_admits(task, node, policy),
            evict_curable=True)

    def _capacity_admits(self, task: TaskInfo, node: NodeInfo,
                         policy: str) -> bool:
        """Could the policy EVER admit this request on this node?
        Only a published capacity_res can prove 'never' — published
        free values exclude running victims, so without capacity data
        we stay permissive (resolvable) and rely on the eviction-cure
        re-check in preempt/reclaim to roll back evictions that don't
        help.  Ceilings are reserved-adjusted, mirroring _build_cells,
        so preemption can never place into kubelet-reserved headroom
        that the normal allocate path refuses."""
        caps = self._cell_caps.get(node.name)
        if caps is None:
            topo = self._topologies.get(node.name)
            if topo is None or not topo.capacity_res:
                return True
            self._live_cells(node)   # builds _cell_caps as a side effect
            caps = self._cell_caps.get(node.name)
            if caps is None:
                return True
        from volcano_tpu_torch.plugins import numa_policy
        needs = self._needs(task)
        if all(n <= 0 for n in needs):
            return True
        hint, _ = numa_policy.merged_hint_for(caps, needs)
        return numa_policy.admit(policy, hint)

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        """Narrower merged affinity scores higher (best-effort places
        by hint even though it never rejects); preferred assignments
        beat unpreferred at any width."""
        if self._effective_policy(task, node) not in _KNOWN:
            return 0.0
        needs = self._needs(task)
        if all(n <= 0 for n in needs):
            return 0.0
        cells = self._live_cells(node)
        if not cells:
            return 0.0
        hint, _ = self._merged_hint(node, cells, needs)
        width = len(hint.mask) if hint.mask is not None else len(cells)
        score = MAX_SCORE * (len(cells) - width + 1) / len(cells)
        return score if hint.preferred else score / 2

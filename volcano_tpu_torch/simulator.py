"""Simulated GPU cluster provisioning — the KWOK-analogue harness.

Reference parity: benchmark/scripts/create-kwok-nodes.sh +
create-hypernodes.sh (fake nodes + synthetic rack/spine topologies).
Here fake nodes are fake GPU hosts: GPU Feature Discovery labels
(product, NVLink clique), GPUs-per-host allocatable, the domain's shape
and each host's index in it, grouped into InfiniBand fabrics — so gang
+ topology scheduling is exercised at thousands-of-hosts scale with
zero real machines.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from volcano_tpu_torch.api.node_info import Node
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (
    GPU_CLIQUE_LABEL,
    GPU_DOMAIN_SHAPE_LABEL,
    GPU_HOST_INDEX_LABEL,
    GPU_PRODUCT_LABEL,
)
from volcano_tpu_torch.api.devices.gpu.topology import (DomainTopology,
                                                        domain_for)
from volcano_tpu_torch.cache.fake_cluster import FakeCluster
from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL


def domain_nodes(domain: DomainTopology, ib_fabric: str = "",
                 cpu_per_host: int = 112, mem_gi: int = 192) -> List[Node]:
    """Materialize one NVLink domain as its host nodes with full GPU
    labels."""
    from volcano_tpu_torch.api.goodput import GENERATION_LABEL, generation_of
    nodes = []
    for host in range(domain.hosts):
        labels = {
            GPU_CLIQUE_LABEL: domain.name,
            GPU_DOMAIN_SHAPE_LABEL: domain.shape,
            GPU_HOST_INDEX_LABEL: str(host),
            GPU_PRODUCT_LABEL: domain.product,
        }
        # hardware generation attribute (api/goodput.py): the key the
        # throughput-vector estimator and frag gauges group by
        labels[GENERATION_LABEL] = generation_of(labels)
        if ib_fabric:
            labels[IB_FABRIC_LABEL] = ib_fabric
        nodes.append(Node(
            name=f"{domain.name}-w{host}",
            labels=labels,
            allocatable={"cpu": cpu_per_host, "memory": f"{mem_gi}Gi",
                         GPU: domain.gpus_per_host, "pods": 110},
        ))
    return nodes


def make_gpu_cluster(
        domains: Sequence[Tuple[str, str]],
        ib_fabrics: Optional[Dict[str, str]] = None,
        extra_nodes: Sequence[Node] = (),
        discover_topology: bool = True) -> FakeCluster:
    """Build a FakeCluster of NVLink domains.

    domains: [(domain_name, kind)] with kind from topology.WELL_KNOWN
    (e.g. ("nvl-a", "hgx-h100-8")).  ib_fabrics maps domain name -> IB
    fabric name (defaults to one shared fabric "ib-0").  When
    discover_topology, the hypernode controller runs once so the
    topology tree exists.
    """
    cluster = FakeCluster()
    for name, kind in domains:
        domain = domain_for(name, kind)
        fabric = (ib_fabrics or {}).get(name, "ib-0")
        for node in domain_nodes(domain, ib_fabric=fabric):
            cluster.add_node(node)
    for node in extra_nodes:
        cluster.add_node(node)

    if discover_topology:
        from volcano_tpu_torch.controllers.hypernode import HyperNodeController
        ctrl = HyperNodeController()
        ctrl.initialize(cluster)
        ctrl.sync()
    return cluster


# -- chaos helpers (failover tooling / tests) --------------------------

def fail_host(cluster, node_name: str, provider=None,
              chips_healthy: int = 0):
    """Inject a host failure without hand-editing node objects.

    With *provider* (a FakeUsageProvider whose NodeAgent is being
    driven): flip the GPU telemetry so the agent's K-consecutive-
    ticks hysteresis detects the failure the production way (drive
    agent.sync() yourself).  Without one: emulate the agent's FAILED
    endpoint directly — cordon, label, and post the SliceHealthReport
    the failover controller reacts to — for tests/chaos tools with no
    agent in the loop."""
    from volcano_tpu_torch.api.resource import Resource
    from volcano_tpu_torch.api.slicehealth import (SliceHealthReport,
                                             VERDICT_FAILED)
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    node = cluster.nodes[node_name]
    detected = int(Resource.from_resource_list(node.allocatable)
                   .get(GPU)) or 8
    if provider is not None:
        provider.set(node_name, cpu_fraction=0.2,
                     gpu_chips_detected=detected,
                     gpu_chips_healthy=chips_healthy)
        return node
    from volcano_tpu_torch.agent.agent import (AGENT_CORDONED_ANNOTATION,
                                         GPU_HEALTHY_LABEL)
    import time as _time
    node.labels[GPU_HEALTHY_LABEL] = "false"
    node.unschedulable = True
    node.annotations[AGENT_CORDONED_ANNOTATION] = "true"
    cluster.put_object("node", node)
    cluster.put_object("slicehealthreport", SliceHealthReport(
        node=node_name, slice=node.labels.get(GPU_CLIQUE_LABEL, ""),
        verdict=VERDICT_FAILED, chips_detected=detected,
        chips_healthy=chips_healthy, consecutive_bad=3,
        first_bad_ts=round(_time.time(), 3)))
    return node


def heal_host(cluster, node_name: str, provider=None):
    """Undo fail_host: healthy telemetry (provider mode) or a Healthy
    report + uncordon (direct mode)."""
    from volcano_tpu_torch.api.resource import Resource
    from volcano_tpu_torch.api.slicehealth import (SliceHealthReport,
                                             VERDICT_HEALTHY)
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    node = cluster.nodes[node_name]
    detected = int(Resource.from_resource_list(node.allocatable)
                   .get(GPU)) or 8
    if provider is not None:
        provider.set(node_name, cpu_fraction=0.2,
                     gpu_chips_detected=detected,
                     gpu_chips_healthy=detected)
        return node
    from volcano_tpu_torch.agent.agent import (AGENT_CORDONED_ANNOTATION,
                                         GPU_HEALTHY_LABEL)
    node.labels[GPU_HEALTHY_LABEL] = "true"
    if node.annotations.pop(AGENT_CORDONED_ANNOTATION, None):
        node.unschedulable = False
    cluster.put_object("node", node)
    cluster.put_object("slicehealthreport", SliceHealthReport(
        node=node_name, slice=node.labels.get(GPU_CLIQUE_LABEL, ""),
        verdict=VERDICT_HEALTHY, chips_detected=detected,
        chips_healthy=detected, consecutive_good=3))
    return node

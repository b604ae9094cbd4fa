"""The port's GPU device layer against the reference's TPU one, on
mirrored clusters (the same hosts, the same devices a host and the same
tier-2 grouping): a TPU v5e-16 slice (4 hosts x 4 chips) mirrors a
4 x 4 NVLink domain, a single-host v5e-4 mirrors a 1 x 4 host, and DCN
pods mirror InfiniBand fabrics.  Tolerance: exact.

Covered: GPUDevices' verdicts, flags and scores against TPUDevices';
hop distances against the hypernode tree's LCA tiers; the hypernode
trees of both discoverers; `generation_of`; the GPU chip collector on
a directory of fake device nodes; and the health handler's hysteresis
against TpuHealthHandler's, sync by sync.
"""

import itertools

import pytest

from volcano_tpu.agent import agent as ragent
from volcano_tpu.agent import collect as rcollect
from volcano_tpu.agent import handlers as rhandlers
from volcano_tpu.api import goodput as rgoodput
from volcano_tpu.api.devices.tpu.device_info import TPUDevices
from volcano_tpu.api.devices.tpu.topology import SliceTopology
from volcano_tpu.api.hypernode import HyperNodesInfo as RHyperNodesInfo
from volcano_tpu.api.job_info import TaskInfo as RTaskInfo
from volcano_tpu.api.node_info import NodeInfo as RNodeInfo
from volcano_tpu.api.pod import make_pod as rmake_pod
from volcano_tpu.api.resource import TPU
from volcano_tpu.api.types import TaskStatus as RTaskStatus
from volcano_tpu.cache.fake_cluster import FakeCluster as RFakeCluster
from volcano_tpu.controllers.hypernode import (
    FabricDiscoverer as RFabricDiscoverer,
    HyperNodeController as RHyperNodeController)
from volcano_tpu.simulator import slice_nodes
from volcano_tpu_torch.agent import agent as tagent
from volcano_tpu_torch.agent import collect as tcollect
from volcano_tpu_torch.agent import handlers as thandlers
from volcano_tpu_torch.api import goodput as tgoodput
from volcano_tpu_torch.api.devices.gpu import topology as gtopo
from volcano_tpu_torch.api.devices.gpu.device_info import GPUDevices
from volcano_tpu_torch.api.hypernode import HyperNodesInfo as THyperNodesInfo
from volcano_tpu_torch.api.job_info import TaskInfo as TTaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo as TNodeInfo
from volcano_tpu_torch.api.pod import make_pod as tmake_pod
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (GPU_CLIQUE_LABEL,
                                         GPU_HOST_INDEX_LABEL)
from volcano_tpu_torch.api.types import TaskStatus as TTaskStatus
from volcano_tpu_torch.cache.fake_cluster import FakeCluster as TFakeCluster
from volcano_tpu_torch.controllers.hypernode import (
    FabricDiscoverer as TFabricDiscoverer,
    HyperNodeController as THyperNodeController)
from volcano_tpu_torch.simulator import domain_nodes, make_gpu_cluster

V5E = "tpu-v5-lite-podslice"
# (hosts, devices a host) -> the TPU slice topology of that shape
TPU_SHAPES = {(4, 4): (4, 4), (1, 4): (2, 2)}
# the tier names each discoverer emits, port -> reference
TIER_NAMES = {"nvlink-domain": "ici-slice", "ib-fabric": "dcn-pod"}


def _tpu_nodes(name, shape, pod=""):
    return slice_nodes(SliceTopology(name, V5E, TPU_SHAPES[shape]),
                       dcn_pod=pod)


def _gpu_nodes(name, shape, fabric=""):
    return domain_nodes(gtopo.DomainTopology(name, gtopo.H100_SXM, *shape),
                        ib_fabric=fabric)


# -- GPUDevices against TPUDevices --------------------------------------

REQUESTS = (0, 1, 2, 3, 4, 8, 16)
# the occupant a node holds before the request is checked: a 2-device
# pod on a single host, a whole host on a multi-host domain
OCCUPANT = {(1, 4): 2, (4, 4): 4}


def _node_info(side, shape, state):
    if side == "tpu":
        raw = _tpu_nodes("s", shape)[0]
        ni, mk, task, res, st = (RNodeInfo(raw), rmake_pod, RTaskInfo, TPU,
                                 RTaskStatus)
    else:
        raw = _gpu_nodes("s", shape)[0]
        ni, mk, task, res, st = (TNodeInfo(raw), tmake_pod, TTaskInfo, GPU,
                                 TTaskStatus)
    if state != "free":
        phase = st.RUNNING if state == "occupied" else st.RELEASING
        ni.add_task(task(mk("occupant", requests={"cpu": 1,
                                                  res: OCCUPANT[shape]},
                            phase=phase)))
    return ni


def _task(side, req):
    requests = {"cpu": 1}
    if req:
        requests[TPU if side == "tpu" else GPU] = req
    if side == "tpu":
        return RTaskInfo(rmake_pod("ask", requests=requests))
    return TTaskInfo(tmake_pod("ask", requests=requests))


def _verdict(status):
    if status is None:
        return None
    return (status.code, status.evict_curable,
            {"tpu": "gpu"}.get(status.plugin, status.plugin))


@pytest.mark.parametrize("req", REQUESTS)
@pytest.mark.parametrize("shape", [(1, 4), (4, 4)],
                         ids=["single_host", "multi_host"])
@pytest.mark.parametrize("state", ["free", "occupied", "releasing"])
def test_gpu_devices_match_tpu_devices(req, shape, state):
    tpu = TPUDevices(_node_info("tpu", shape, state))
    gpu = GPUDevices(_node_info("gpu", shape, state))
    ttask, gtask = _task("tpu", req), _task("gpu", req)
    assert gpu.has_device_request(gtask) == tpu.has_device_request(ttask)
    assert GPUDevices.task_requests_device(gtask) == \
        TPUDevices.task_requests_device(ttask)
    assert _verdict(gpu.filter_node(gtask)) == \
        _verdict(tpu.filter_node(ttask))
    assert gpu.score_node(gtask) == tpu.score_node(ttask)
    assert gpu.is_gpu_node == tpu.is_tpu_node
    assert (gpu.gpus_free, gpu.gpus_free_future) == \
        (tpu.chips_free, tpu.chips_free_future)
    assert (gpu.domain.is_multi_host, gpu.domain.hosts) == \
        (tpu.slice.is_multi_host, tpu.slice.num_hosts)


@pytest.mark.parametrize("req", REQUESTS)
def test_gpu_devices_on_a_gpu_less_node(req):
    from volcano_tpu.api.node_info import Node as RNode
    from volcano_tpu_torch.api.node_info import Node as TNode
    alloc = {"cpu": 8, "memory": "16Gi"}
    tpu = TPUDevices(RNodeInfo(RNode(name="cpu-0", allocatable=alloc)))
    gpu = GPUDevices(TNodeInfo(TNode(name="cpu-0", allocatable=alloc)))
    ttask, gtask = _task("tpu", req), _task("gpu", req)
    assert _verdict(gpu.filter_node(gtask)) == \
        _verdict(tpu.filter_node(ttask))
    assert gpu.score_node(gtask) == tpu.score_node(ttask) == 0.0


@pytest.mark.parametrize("kind,fits,refused", [
    ("hgx-h100-8", (1, 2, 4, 8), (3, 16)),
    ("dgx-h100-256", (8,), (1, 2, 4, 16)),
])
def test_well_known_domains(kind, fits, refused):
    """The public shapes: an HGX host packs 1, 2, 4 or 8 GPUs; a host
    of a multi-host NVLink domain is taken whole."""
    domain = gtopo.domain_for("d", kind)
    node = TNodeInfo(domain_nodes(domain)[0])
    dev = GPUDevices(node)
    assert dev.domain == domain
    assert dev.domain.is_multi_host == (domain.hosts > 1)
    for req in fits:
        assert dev.filter_node(_task("gpu", req)) is None, req
    for req in refused:
        status = dev.filter_node(_task("gpu", req))
        assert status is not None and not status.evict_curable, req


def test_parse_topology():
    assert gtopo.parse_topology("32x8") == (32, 8)
    assert gtopo.parse_topology("1x8") == (1, 8)
    for bad in ("", "8", "4x4x4", "0x8", "ax8"):
        assert gtopo.parse_topology(bad) == (), bad
    d = gtopo.domain_for("x", "dgx-h100-256")
    assert (d.name, d.hosts, d.gpus_per_host, d.shape) == \
        ("x", 32, 8, "32x8")


# -- hop distances and hypernode trees -----------------------------------

# (name, (hosts, devices a host), tier-2 group)
MIRROR = [("sa", (4, 4), "p0"), ("sb", (4, 4), "p1"),
          ("sc", (1, 4), "p0"), ("sd", (1, 4), "")]


def _clusters():
    rc, tc = RFakeCluster(), TFakeCluster()
    for name, shape, group in MIRROR:
        for n in _tpu_nodes(name, shape, group):
            rc.add_node(n)
        for n in _gpu_nodes(name, shape, group):
            tc.add_node(n)
    for cluster, ctrl in ((rc, RHyperNodeController()),
                          (tc, THyperNodeController())):
        ctrl.initialize(cluster)
        ctrl.sync()
    return rc, tc


def _tree(cluster):
    return sorted((hn.name, hn.tier, TIER_NAMES.get(hn.tier_name,
                                                    hn.tier_name),
                   sorted((m.kind, m.exact) for m in hn.members))
                  for hn in cluster.hypernodes.values())


def test_label_discovery_trees_match():
    rc, tc = _clusters()
    assert set(rc.nodes) == set(tc.nodes)
    assert _tree(tc) == _tree(rc)
    assert {hn.tier_name for hn in tc.hypernodes.values()} == \
        {"nvlink-domain", "ib-fabric"}


def test_hop_distance_is_the_lca_tier():
    """0 on one host; between hosts, 1 inside an NVLink domain and 2
    across the IB fabric, which is the tier of the two hosts' lowest
    common hypernode in the port's tree and in the reference's."""
    rc, tc = _clusters()
    names = sorted(tc.nodes)
    rinfo = RHyperNodesInfo(rc.hypernodes.values(), names)
    tinfo = THyperNodesInfo(tc.hypernodes.values(), names)
    def host(name):
        labels = tc.nodes[name].labels
        return (labels[GPU_CLIQUE_LABEL], int(labels[GPU_HOST_INDEX_LABEL]))
    for a, b in itertools.product(names, repeat=2):
        hop = gtopo.hop_distance(host(a), host(b))
        assert tinfo.lca_tier_of_nodes(a, b) == \
            rinfo.lca_tier_of_nodes(a, b)
        if a == b:
            assert hop == gtopo.SAME_HOST
        elif tinfo.lca_tier_of_nodes(a, b) <= 2:
            assert hop == tinfo.lca_tier_of_nodes(a, b), (a, b)
        else:  # no common fabric: the virtual root's tier
            assert hop == gtopo.ACROSS_FABRIC, (a, b)


FABRIC_RECORDS = [
    # two multi-host domains, named by their records, and a host seen
    # only through its uplink (a single-host domain has no links)
    ("link", "h0", "h1", "dom-a"), ("link", "h1", "h2", "dom-a"),
    ("link", "h3", "h4", "dom-b"),
    ("up", "h0", "g0"), ("up", "h1", "g0"), ("up", "h2", "g1"),
    ("up", "h3", "g1"), ("up", "h4", "g1"), ("up", "h5", "g0"),
    # a domain whose links disagree on its name, and a name collision
    ("link", "h6", "h7", "x"), ("link", "h7", "h8", "y"),
    ("link", "h9", "h10", "dom-a"),
]


def _records(side):
    link, up = ("ici", "dcn") if side == "tpu" else ("nvlink", "ib")
    up_key = "pod" if side == "tpu" else "fabric"
    out = []
    for rec in FABRIC_RECORDS:
        if rec[0] == "link":
            out.append({"kind": link, "a": rec[1], "b": rec[2],
                        "fabric": rec[3]})
        else:
            out.append({"kind": up, "host": rec[1], up_key: rec[2]})
    return out


def test_fabric_discovery_trees_match():
    ref = RFabricDiscoverer.build(_records("tpu"))
    port = TFabricDiscoverer.build(_records("gpu"))

    def shape(hns, rename):
        return [(hn.name.replace(*rename), hn.tier,
                 TIER_NAMES.get(hn.tier_name, hn.tier_name),
                 sorted((m.kind, m.exact.replace(*rename))
                        for m in hn.members)) for hn in hns]
    assert shape(port, ("-ib", "-dcn")) == shape(ref, ("", ""))
    assert {hn.tier_name for hn in port} == {"nvlink-domain", "ib-fabric"}


def test_make_gpu_cluster_builds_the_tree():
    cluster = make_gpu_cluster([("na", "hgx-h100-8"),
                                ("nb", "dgx-h100-256")],
                               ib_fabrics={"na": "ib-a", "nb": "ib-a"})
    assert len(cluster.nodes) == 33
    tiers = {hn.name: (hn.tier, hn.tier_name)
             for hn in cluster.hypernodes.values()}
    assert tiers == {"na": (1, "nvlink-domain"), "nb": (1, "nvlink-domain"),
                     "ib-a": (2, "ib-fabric")}
    assert cluster.nodes["nb-w31"].allocatable[GPU] == 8


# -- generations ---------------------------------------------------------

@pytest.mark.parametrize("product,gen", [
    ("NVIDIA-H100-80GB-HBM3", "h100"), ("NVIDIA-H100-PCIe", "h100"),
    ("NVIDIA-H200", "h200"), ("NVIDIA-A100-SXM4-80GB", "a100"),
    ("Tesla-V100-SXM2-16GB", "v100"), ("NVIDIA-B200", "b200"),
    ("NVIDIA-GB200", "gb200"), ("NVIDIA-L4", "other"), ("", "other"),
])
def test_generation_of_gpu_products(product, gen):
    assert tgoodput.generation_of(
        {tgoodput.ACCELERATOR_LABEL: product}) == gen
    assert gen in tgoodput.GENERATIONS


def test_generation_of_follows_the_reference_rules():
    """The explicit label wins, an unknown label value or product maps
    to "other", and no labels at all is "other" -- on both sides, with
    the reference's TPU names mapped to GPU ones."""
    r, t = rgoodput.generation_of, tgoodput.generation_of
    assert r({rgoodput.ACCELERATOR_LABEL: V5E}) == "v5e"
    assert t({tgoodput.ACCELERATOR_LABEL: gtopo.H100_SXM}) == "h100"
    assert r({rgoodput.GENERATION_LABEL: "v4",
              rgoodput.ACCELERATOR_LABEL: V5E}) == "v4"
    assert t({tgoodput.GENERATION_LABEL: "a100",
              tgoodput.ACCELERATOR_LABEL: gtopo.H100_SXM}) == "a100"
    assert r({rgoodput.GENERATION_LABEL: "tpu-v9"}) == \
        t({tgoodput.GENERATION_LABEL: "rtx-9090"}) == "other"
    assert r({rgoodput.ACCELERATOR_LABEL: "tpu-v9-slice"}) == \
        t({tgoodput.ACCELERATOR_LABEL: "NVIDIA-RTX-9090"}) == "other"
    assert r({}) == t({}) == r(None) == t(None) == "other"
    assert len(tgoodput.GENERATIONS) == len(set(tgoodput.GENERATIONS))


def test_simulated_nodes_carry_their_generation():
    node = _gpu_nodes("s", (4, 4))[0]
    assert node.labels[tgoodput.GENERATION_LABEL] == "h100"


# -- the chip collector ----------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 4, 8])
@pytest.mark.parametrize("declared", [None, 4])
def test_gpu_chip_collector_counts_device_nodes(tmp_path, n, declared):
    """One /dev/nvidia<N> a GPU; nvidiactl, nvidia-uvm and the other
    driver nodes do not count.  Against TpuChipCollector on as many
    /dev/accel<N> nodes."""
    gdir, tdir = tmp_path / "gpu", tmp_path / "tpu"
    gdir.mkdir()
    tdir.mkdir()
    for i in range(n):
        (gdir / f"nvidia{i}").touch()
        (tdir / f"accel{i}").touch()
    for other in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                  "nvidia-modeset", "nvidia-caps"):
        (gdir / other).touch()
    gpu = tcollect.GpuChipCollector(str(gdir / "nvidia[0-9]*"),
                                    declared=declared)
    tpu = rcollect.TpuChipCollector(str(tdir / "accel*"),
                                    declared=declared)
    got, want = gpu.collect("n"), tpu.collect("n")
    assert got == {k.replace("tpu_", "gpu_"): v for k, v in want.items()}
    if n:
        assert got["gpu_chips_healthy"] == n


def test_gpu_collector_is_registered_and_default_glob():
    assert tcollect.registered_collectors()["gpu"] is \
        tcollect.GpuChipCollector
    assert "tpu" not in tcollect.registered_collectors()
    assert tcollect.GpuChipCollector().device_glob == "/dev/nvidia[0-9]*"
    provider = tcollect.build_provider("gpu")
    assert isinstance(provider.collectors[0], tcollect.GpuChipCollector)


# -- the health handler ---------------------------------------------------

# (detected, healthy) a sync: healthy, a blip, a failure held past the
# hysteresis, a recovery that flaps once, then a held recovery
SAMPLES = ([(4, 4)] * 2 + [(4, 3)] + [(4, 4)] + [(4, 2)] * 4
           + [(4, 4)] * 2 + [(4, 3)] + [(4, 4)] * 4 + [(0, 0)] + [(4, 4)])


def _drive(side):
    if side == "tpu":
        cluster = RFakeCluster()
        node = _tpu_nodes("s", (1, 4))[0]
        amod, handler, prefix = ragent, rhandlers.TpuHealthHandler, "tpu"
        healthy_label = ragent.TPU_HEALTHY_LABEL
    else:
        cluster = TFakeCluster()
        node = _gpu_nodes("s", (1, 4))[0]
        amod, handler, prefix = tagent, thandlers.GpuHealthHandler, "gpu"
        healthy_label = tagent.GPU_HEALTHY_LABEL
    cluster.add_node(node)
    provider = amod.FakeUsageProvider()
    agent = amod.NodeAgent(cluster, node.name, provider=provider,
                           handlers=[handler])
    out = []
    for detected, healthy in SAMPLES:
        provider.set(node.name, cpu_fraction=0.2,
                     **{f"{prefix}_chips_detected": detected,
                        f"{prefix}_chips_healthy": healthy})
        agent.sync()
        n = cluster.nodes[node.name]
        report = cluster.slicehealthreports.get(node.name)
        out.append((n.labels.get(healthy_label), n.unschedulable,
                    n.annotations.get(amod.AGENT_CORDONED_ANNOTATION),
                    None if report is None else
                    (report.verdict, report.chips_detected,
                     report.chips_healthy, report.consecutive_bad,
                     report.consecutive_good)))
    events = [(reason.replace("TPU", "GPU"), msg.replace("chips", "GPUs"))
              for _, reason, msg in cluster.events]
    return out, events


def test_health_handler_matches_tpu_hysteresis():
    """Healthy -> Suspect -> Failed -> Healthy at the same syncs as
    TpuHealthHandler: cordon only on Failed, uncordon after three good
    syncs, no change on a sync without telemetry."""
    got, got_events = _drive("gpu")
    want, want_events = _drive("tpu")
    assert got == want
    assert got_events == want_events
    verdicts = [r[3][0] for r in got if r[3] is not None]
    assert "Failed" in verdicts and verdicts[-1] == "Healthy"
    assert thandlers.GpuHealthHandler.FAIL_SYNCS == \
        thandlers.GpuHealthHandler.RECOVER_SYNCS == 3

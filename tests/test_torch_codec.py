"""The port's wire codec against the reference's.

Every class the port's codec registers round-trips through it.  For
the kinds the control plane ships (pods, podgroups, vcjobs, queues,
hypernodes, jobflows, hyperjobs, commands), mirrored objects built on
each side encode to the same wire JSON once the device's resource name
is mapped (google.com/tpu -> nvidia.com/gpu): the codec's tags are
class names, so mirrored classes encode alike.  The GPU layer's wire
classes, `Node` and `Numatopology`, are named below with what differs.
Tolerance: exact.
"""

import dataclasses

import pytest

from volcano_tpu.api import codec as rcodec
from volcano_tpu.api.devices.tpu.topology import SliceTopology
from volcano_tpu.analysis.registry import _synthesize
from volcano_tpu.api.numatopology import tpu_host_numatopology
from volcano_tpu.simulator import slice_nodes
from volcano_tpu_torch.api import codec as tcodec
from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
from volcano_tpu_torch.api.numatopology import gpu_host_numatopology
from volcano_tpu_torch.simulator import domain_nodes

TPU, GPU = "google.com/tpu", "nvidia.com/gpu"


def _mapped(wire: str) -> str:
    return wire.replace(TPU, GPU)


def _sides():
    """(reference modules, port modules) by short name."""
    import importlib
    names = ("api.pod", "api.podgroup", "api.queue", "api.vcjob",
             "api.hypernode", "api.jobflow", "api.resource", "api.types",
             "controllers.hyperjob")
    out = []
    for pkg in ("volcano_tpu", "volcano_tpu_torch"):
        out.append({n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
                    for n in names})
    return out


REF_M, PORT_M = _sides()


def _pinned(obj):
    """The object with its minted identity fixed: every uid (a counter
    and a random suffix) and creation time in its tree."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name == "uid":
                setattr(obj, f.name, "uid-pinned")
            elif f.name == "creation_time":
                setattr(obj, f.name, 1.0)
            else:
                _pinned(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _pinned(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            _pinned(x)
    return obj


# -- every registered class round-trips ------------------------------
# (instances from the reference linter's synthesizer: each class's
# defaults, and a simple value for each required field)

def _registry(codec):
    codec._build_registry()
    return codec._CLASSES, codec._ENUMS, codec._FIELDS


@pytest.mark.parametrize("name", sorted(_registry(tcodec)[0]))
def test_every_registered_class_roundtrips(name):
    cls = tcodec._CLASSES[name]
    obj = _synthesize(cls)
    wire = tcodec.dumps(obj)
    back = tcodec.loads(wire)
    assert type(back) is cls
    assert tcodec.dumps(back) == wire


@pytest.mark.parametrize("name", sorted(_registry(tcodec)[1]))
def test_every_registered_enum_roundtrips(name):
    for member in tcodec._ENUMS[name]:
        assert tcodec.loads(tcodec.dumps(member)) is member


def test_registries_hold_the_same_classes():
    rclasses, renums, rfields = _registry(rcodec)
    tclasses, tenums, tfields = _registry(tcodec)
    assert sorted(tclasses) == sorted(rclasses)
    assert sorted(tenums) == sorted(renums)
    # field for field: mirrored classes carry the same wire shape
    assert tfields == rfields
    for name in renums:
        assert [(m.name, m.value) for m in tenums[name]] == \
            [(m.name, m.value) for m in renums[name]], name
    # and neither registry holds the other package's classes
    assert all(c.__module__.startswith("volcano_tpu_torch.")
               for c in tclasses.values())
    assert not any(c.__module__.startswith("volcano_tpu_torch.")
                   for c in rclasses.values())


# -- mirrored objects encode alike -----------------------------------

def _pod(m, dev):
    p = m["pod"]
    pod = p.make_pod(
        "w-0", requests={"cpu": "4", "memory": "8Gi", dev: 4},
        labels={"volcano-tpu.io/task-spec": "worker"},
        annotations={"scheduling.volcano-tpu.io/group-name": "pg1"},
        phase=m["types"].TaskStatus.RUNNING, node_name="host-0",
        priority=10,
        tolerations=[p.Toleration(key=dev, operator="Exists",
                                  effect="NoSchedule")],
        affinity_node_terms=[{"zone": ["z1"]}])
    pod.containers[0].ports = [8470, 8471]
    pod.containers[0].env = {"NUM_PROCESSES": "4"}
    return pod


def _podgroup(m, dev):
    pg = m["podgroup"]
    return pg.PodGroup(
        name="pg1", min_member=4, min_task_member={"worker": 4},
        min_resources=m["resource"].Resource({dev: 16, "cpu": 4000}),
        network_topology=pg.NetworkTopologySpec(
            mode=m["types"].NetworkTopologyMode.HARD,
            highest_tier_allowed=1),
        sub_group_policies=[pg.SubGroupPolicy(name="sg0", min_member=2)],
        phase=m["types"].PodGroupPhase.INQUEUE)


def _vcjob(m, dev):
    v, t = m["vcjob"], m["types"]
    return v.VCJob(
        name="train", min_available=8, queue="tenant-a",
        network_topology=m["podgroup"].NetworkTopologySpec(
            highest_tier_allowed=2),
        tasks=[v.TaskSpec(
            name="worker", replicas=8, subgroup="a",
            template=m["pod"].make_pod("tmpl", requests={"cpu": 1, dev: 4}),
            policies=[v.LifecyclePolicy(action=t.JobAction.RESTART_JOB,
                                        event=t.JobEvent.POD_FAILED)],
            depends_on=v.DependsOn(name=["ps"]))],
        plugins={"svc": []}, phase=t.JobPhase.RUNNING)


def _queue(m, dev):
    r = m["resource"].Resource
    return m["queue"].Queue(name="tenant-a", weight=4,
                            capability=r({"cpu": 1000, dev: 64}),
                            guarantee=r({dev: 16}), parent="root",
                            priority=5)


def _hypernode(m, dev):
    return m["hypernode"].HyperNode.of_nodes("d0", 1, ["d0-w0", "d0-w1"])


def _jobflow(m, dev):
    jf = m["jobflow"]
    return jf.JobFlow(name="f", flows=[
        jf.Flow(name="train", depends_on=jf.FlowDependsOn(
            targets=["prep"]))])


def _hyperjob(m, dev):
    hj = m["hyperjob"]
    return hj.HyperJob(name="hj", min_available=2, replicated_jobs=[
        hj.ReplicatedJob(name="rj", replicas=2, template=_vcjob(m, dev),
                         split_policy=hj.SplitPolicy(
                             accelerators=8, accelerator_type=dev))])


def _command(m, dev):
    return {"target": "default/train", "action": "RestartJob",
            "cid": "0123456789ab"}


MIRRORED = {"pod": _pod, "podgroup": _podgroup, "vcjob": _vcjob,
            "queue": _queue, "hypernode": _hypernode, "jobflow": _jobflow,
            "hyperjob": _hyperjob, "command": _command}


@pytest.mark.parametrize("kind", sorted(MIRRORED))
def test_mirrored_objects_encode_alike(kind):
    ref = _pinned(MIRRORED[kind](REF_M, TPU))
    port = _pinned(MIRRORED[kind](PORT_M, GPU))
    want = _mapped(rcodec.dumps(ref))
    got = tcodec.dumps(port)
    assert got == want
    # and each side decodes the other's bytes into its own classes
    back = tcodec.loads(want)
    assert tcodec.dumps(back) == got
    if dataclasses.is_dataclass(port):
        assert type(back) is type(port)


def test_hyperjob_split_default_is_the_gpu():
    """The one default of a mirrored wire class that differs: the
    split policy counts the side's accelerator.  Elided on the wire
    as a default, so an unset policy decodes to the receiver's."""
    from volcano_tpu.controllers.hyperjob import SplitPolicy as RSplit
    from volcano_tpu_torch.controllers.hyperjob import SplitPolicy as TSplit
    assert RSplit().accelerator_type == TPU
    assert TSplit().accelerator_type == GPU
    assert tcodec.dumps(TSplit()) == rcodec.dumps(RSplit())
    assert tcodec.loads(rcodec.dumps(RSplit())).accelerator_type == GPU


# -- the GPU layer's wire classes ------------------------------------

# Node: the same dataclass; what differs is the data its labels carry.
# A TPU host's GKE labels and the NVLink domain's that stand for them.
NODE_LABELS = {
    "cloud.google.com/gke-tpu-slice": "nvidia.com/gpu.clique",
    "cloud.google.com/gke-tpu-topology":
        "volcano-tpu.io/nvlink-domain-shape",
    "cloud.google.com/gke-tpu-worker-id": "volcano-tpu.io/nvlink-host-index",
    "cloud.google.com/gke-tpu-accelerator": "nvidia.com/gpu.product",
    "volcano-tpu.io/dcn-pod": "volcano-tpu.io/ib-fabric",
    "volcano-tpu.io/tpu-generation": "volcano-tpu.io/gpu-generation",
}
# the TPU label with no NVLink counterpart: a host's ICI coordinates
TPU_ONLY_LABELS = {"volcano-tpu.io/ici-coords"}


def test_node_differs_only_in_its_labels_and_allocatable():
    ref = slice_nodes(SliceTopology("sa", "tpu-v5-lite-podslice", (4, 4)),
                      dcn_pod="p0")
    port = domain_nodes(DomainTopology("sa", "NVIDIA-H100-80GB-HBM3", 4, 4),
                        ib_fabric="p0")
    assert [n.name for n in port] == [n.name for n in ref]
    for r, t in zip(ref, port):
        assert set(r.labels) == set(NODE_LABELS) | TPU_ONLY_LABELS
        assert set(t.labels) == set(NODE_LABELS.values())
        assert t.labels["nvidia.com/gpu.clique"] == \
            r.labels["cloud.google.com/gke-tpu-slice"]
        assert t.labels["volcano-tpu.io/nvlink-domain-shape"] == \
            r.labels["cloud.google.com/gke-tpu-topology"]
        assert t.labels["volcano-tpu.io/nvlink-host-index"] == \
            r.labels["cloud.google.com/gke-tpu-worker-id"]
        assert t.labels["volcano-tpu.io/ib-fabric"] == \
            r.labels["volcano-tpu.io/dcn-pod"]
        # four devices a host on both sides, under each side's name
        assert float(r.allocatable[TPU]) == float(t.allocatable[GPU]) == 4
        rw, tw = rcodec.encode(r), tcodec.encode(t)
        for wire in (rw, tw):
            wire["f"].pop("labels")
            wire["f"].pop("allocatable")
        assert tw == rw


def test_numatopology_counts_gpus_per_cell():
    """tpu_host_numatopology -> gpu_host_numatopology: the same cells
    and cpu split, the device counted under nvidia.com/gpu.  An HGX
    H100 host is 2 NUMA cells of 4 GPUs."""
    ref = tpu_host_numatopology("h0", 96000, 8)
    port = gpu_host_numatopology("h0", 96000, 8)
    assert tcodec.dumps(port) == _mapped(rcodec.dumps(ref))
    assert port.numa_res[GPU] == {"0": 4.0, "1": 4.0}
    # the exporter refresh packs requests alike
    ref.recompute_free([(8000, 4), (4000, 1)])
    port.recompute_free([(8000, 4), (4000, 1)])
    assert tcodec.dumps(port) == _mapped(rcodec.dumps(ref))
    assert port.numa_res[GPU] == {"0": 0.0, "1": 3.0}

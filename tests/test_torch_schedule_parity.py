"""The same job streams through the reference's control plane (TPU
slices, the `jax` job plugin) and the port's (NVLink domains, the
`torch` job plugin), on mirrored clusters: a TPU v5e-16 slice (4 hosts
x 4 chips) mirrors a 4 x 4 NVLink domain, a v5e-4 mirrors a 1 x 4 host,
DCN pods mirror IB fabrics, and each node keeps its name.

Each side runs `ControllerManager(["job", "queue"])`, the `Scheduler`
under the default conf and `default_admission()`, a controller sync, a
scheduling cycle and a cluster tick a cycle.  After every cycle the
placements, the job and podgroup phases and every injected env var of
every pod must be equal, and the tolerations equal with the device's
resource name mapped.  Tolerance: exact.
"""

import itertools
import types

import pytest

import volcano_tpu.api.pod as rpod
import volcano_tpu_torch.api.pod as tpod
from volcano_tpu.api.devices.tpu.topology import SliceTopology
from volcano_tpu.api.podgroup import NetworkTopologySpec as RTopo
from volcano_tpu.api.queue import Queue as RQueue
from volcano_tpu.api.resource import TPU
from volcano_tpu.api.types import RUN_TICKS_ANNOTATION
from volcano_tpu.api.vcjob import TaskSpec as RTaskSpec
from volcano_tpu.api.vcjob import VCJob as RVCJob
from volcano_tpu.cache.fake_cluster import FakeCluster as RFakeCluster
from volcano_tpu.controllers import ControllerManager as RManager
from volcano_tpu.controllers.hypernode import HyperNodeController as RHNC
from volcano_tpu.scheduler import Scheduler as RScheduler
from volcano_tpu.simulator import slice_nodes
from volcano_tpu.webhooks.admission import default_admission as radmission
from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
from volcano_tpu_torch.api.podgroup import NetworkTopologySpec as TTopo
from volcano_tpu_torch.api.queue import Queue as TQueue
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.vcjob import TaskSpec as TTaskSpec
from volcano_tpu_torch.api.vcjob import VCJob as TVCJob
from volcano_tpu_torch.cache.fake_cluster import FakeCluster as TFakeCluster
from volcano_tpu_torch.controllers import ControllerManager as TManager
from volcano_tpu_torch.controllers.hypernode import HyperNodeController as THNC
from volcano_tpu_torch.scheduler import Scheduler as TScheduler
from volcano_tpu_torch.simulator import domain_nodes
from volcano_tpu_torch.webhooks.admission import default_admission as tadmission

TPU_SHAPES = {(4, 4): (4, 4), (1, 4): (2, 2)}

REF = types.SimpleNamespace(
    pod=rpod, VCJob=RVCJob, TaskSpec=RTaskSpec, Queue=RQueue, Topo=RTopo,
    FakeCluster=RFakeCluster, Manager=RManager, HNC=RHNC,
    Scheduler=RScheduler, admission=radmission, device=TPU, plugin="jax",
    nodes=lambda name, shape, group: slice_nodes(
        SliceTopology(name, "tpu-v5-lite-podslice", TPU_SHAPES[shape]),
        dcn_pod=group))
PORT = types.SimpleNamespace(
    pod=tpod, VCJob=TVCJob, TaskSpec=TTaskSpec, Queue=TQueue, Topo=TTopo,
    FakeCluster=TFakeCluster, Manager=TManager, HNC=THNC,
    Scheduler=TScheduler, admission=tadmission, device=GPU, plugin="torch",
    nodes=lambda name, shape, group: domain_nodes(
        DomainTopology(name, "NVIDIA-H100-80GB-HBM3", *shape),
        ib_fabric=group))


class Plane:
    """One side's cluster, controllers and scheduler."""

    def __init__(self, side, domains, queues=()):
        # uids sort the same on both sides: each side's pods and jobs
        # count from 1 (the counter is module state of each api.pod)
        side.pod._uid_counter = itertools.count(1)
        self.side = side
        self.cluster = side.FakeCluster()
        for name, shape, group in domains:
            for node in side.nodes(name, shape, group):
                self.cluster.add_node(node)
        hnc = side.HNC()
        hnc.initialize(self.cluster)
        hnc.sync()
        for name, weight in queues:
            self.cluster.add_queue(side.Queue(name=name, weight=weight))
        self.cluster.admission = side.admission()
        self.mgr = side.Manager(self.cluster, enabled=["job", "queue"])
        self.sched = side.Scheduler(self.cluster, schedule_period=0)

    def submit(self, spec):
        """spec: (name, [(task, replicas, devices, subgroup)], min,
        queue, run_ticks, hard_tier)."""
        s = self.side
        name, tasks, min_available, queue, run_ticks, tier = spec
        annotations = {RUN_TICKS_ANNOTATION: str(run_ticks)} \
            if run_ticks else {}
        specs = []
        for task, replicas, devices, subgroup in tasks:
            requests = {"cpu": 4}
            if devices:
                requests[s.device] = devices
            specs.append(s.TaskSpec(
                name=task, replicas=replicas, subgroup=subgroup,
                template=s.pod.Pod(name="t", annotations=annotations,
                                   containers=[s.pod.Container(
                                       requests=requests)])))
        self.cluster.add_vcjob(s.VCJob(
            name=name, min_available=min_available, tasks=specs,
            queue=queue, plugins={s.plugin: [], "svc": []},
            network_topology=None if tier is None else
            s.Topo(highest_tier_allowed=tier)))

    def cycle(self):
        self.mgr.sync_all()
        self.sched.run_once()
        self.cluster.tick()

    def state(self):
        c = self.cluster
        pods = {k: (p.node_name, p.phase.value, dict(p.containers[0].env),
                    sorted((t.key.replace(self.side.device, "DEVICE"),
                            t.operator, t.effect) for t in p.tolerations))
                for k, p in c.pods.items()}
        return {"pods": pods,
                "jobs": {k: j.phase.value for k, j in c.vcjobs.items()},
                "podgroups": {k: g.phase.value
                              for k, g in c.podgroups.items()}}


def run_both(domains, stream, cycles, queues=()):
    """Drive both planes through the same stream, {cycle: [specs]}, and
    return the reference's state after every cycle, having held the
    port's to it."""
    ref, port = Plane(REF, domains, queues), Plane(PORT, domains, queues)
    states = []
    for cycle in range(cycles):
        for spec in stream.get(cycle, ()):
            ref.submit(spec)
            port.submit(spec)
        ref.cycle()
        port.cycle()
        want, got = ref.state(), port.state()
        assert got == want, f"cycle {cycle} differs"
        states.append(want)
    return states


def _bound(state, job):
    return {k: v[0] for k, v in state["pods"].items()
            if k.startswith(f"default/{job}-")}


def test_flat_gang():
    states = run_both([("sa", (4, 4), "p0")],
                      {0: [("flat", [("worker", 4, 4, "")], 4, "default",
                            0, None)]}, 3)
    assert states[-1]["jobs"] == {"default/flat": "Running"}
    assert sorted(_bound(states[-1], "flat").values()) == \
        [f"sa-w{i}" for i in range(4)]


def test_two_subgroups_land_in_two_domains_of_two_fabrics():
    states = run_both(
        [("sa", (4, 4), "p0"), ("sb", (4, 4), "p1")],
        {0: [("multi", [("a", 4, 4, "a"), ("b", 4, 4, "b")], 8,
              "default", 0, None)]}, 3)
    bound = _bound(states[-1], "multi")
    assert len(bound) == 8 and all(bound.values())
    domains = {task: {n.split("-w")[0] for k, n in bound.items()
                      if f"-{task}-" in k} for task in ("a", "b")}
    assert domains["a"] != domains["b"]
    assert all(len(d) == 1 for d in domains.values())
    env = states[-1]["pods"]["default/multi-b-0"][2]
    assert (env["TPU_SLICE_ID"], env["TPU_NUM_SLICES"]) == ("1", "2")


def test_gang_that_does_not_fit_stays_pending():
    states = run_both([("sa", (4, 4), "p0")],
                      {0: [("big", [("worker", 5, 4, "")], 5, "default",
                            0, None)]}, 3)
    assert states[-1]["jobs"] == {"default/big": "Pending"}
    assert not any(_bound(states[-1], "big").values())


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_sub_host_packing(devices):
    jobs = [(f"p{i}", [("worker", 1, devices, "")], 1, "default", 0, None)
            for i in range(12 // devices)]
    states = run_both([("sc", (1, 4), "p0"), ("sd", (1, 4), "p0")],
                      {0: jobs}, 3)
    bound = [v[0] for v in states[-1]["pods"].values() if v[0]]
    # every job that fits is placed, hosts packed before the next
    assert len(bound) == min(len(jobs), 8 // devices)


def _backlog():
    """A 64-host cluster (8 4x4 domains and 32 single hosts in two
    fabrics) and ~50 jobs over two queues, arriving over 6 cycles, each
    finishing after a few ticks: single-host jobs of 1, 2 and 4
    devices, whole-host gangs of 2, 4 and 8 hosts, two-subgroup jobs,
    and gangs capped at the fabric's tier."""
    domains = [(f"m{i}", (4, 4), f"f{i % 2}") for i in range(8)] + \
        [(f"h{i}", (1, 4), f"f{i % 2}") for i in range(32)]
    stream = {}
    for i in range(50):
        queue = ("q-a", "q-b")[i % 2]
        kind = i % 7
        if kind in (0, 1, 2):
            tasks, n = [("worker", 1, (1, 2, 4)[kind], "")], 1
        elif kind == 3:
            tasks, n = [("worker", (2, 4, 8)[i % 3], 4, "")], (2, 4, 8)[i % 3]
        elif kind == 4:
            tasks, n = [("a", 2, 4, "a"), ("b", 2, 4, "b")], 4
        else:
            tasks, n = [("worker", 4, 4, "")], 4
        tier = 2 if kind == 6 else None
        stream.setdefault(i // 9, []).append(
            (f"j{i}", tasks, n, queue, 2 + i % 4, tier))
    return domains, stream


def test_two_queue_backlog_on_64_hosts():
    domains, stream = _backlog()
    states = run_both(domains, stream, 14,
                      queues=[("q-a", 1), ("q-b", 3)])
    phases = states[-1]["jobs"].values()
    assert len(states[-1]["jobs"]) == 50
    assert "Running" in phases or "Completed" in phases
    # the stream keeps the cluster busy, then drains
    bound_per_cycle = [sum(1 for v in s["pods"].values()
                           if v[1] == "Running") for s in states]
    assert max(bound_per_cycle) > 16

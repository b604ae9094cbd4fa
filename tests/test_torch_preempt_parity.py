"""Preemption and reclaim in the port against the reference.

The eight scenarios of the reference's `tests/test_preempt_reclaim.py`
(preempt, the victim's gang floor, critical pods, reclaim across
queues, an unreclaimable queue, hierarchical capacity, gangpreempt's
two-cycle nomination and gangreclaim), and gangreclaim against whole
gangs of a queue above its share (the state `chip_smoke.py`'s third
preemption round drives on the card), run through both packages'
`uthelper.TestContext` on mirrored clusters: a TPU v5e-16 slice (4 hosts
x 4 chips) mirrors a 4 x 4 NVLink domain, the DCN pod an IB fabric of
the same name, and every node keeps its name.  Then one of the
schedule parity's job streams runs through both control planes under
the default conf with gangpreempt, preempt and reclaim before
backfill, with traffic that makes them fire.

After every cycle the evictions, binds, pipelined tasks, hypernode
nominations and events must be equal, the events' texts with the
device mapped (`google.com/tpu` -> `nvidia.com/gpu`, "TPU slice" ->
"NVLink domain", "chips" -> "GPUs", then "TPU" -> "GPU").  The reference
test's own assertions then hold on both sides.  Tolerance: exact.
"""

import importlib
import itertools
import types

import pytest

from test_torch_schedule_parity import PORT as PLANE_PORT
from test_torch_schedule_parity import REF as PLANE_REF
from test_torch_schedule_parity import Plane

PRODUCT = "NVIDIA-H100-80GB-HBM3"


def _side(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    types_ = m("api.types")
    return types.SimpleNamespace(
        pkg=pkg, pod=m("api.pod"), Node=m("api.node_info").Node,
        Topo=m("api.podgroup").NetworkTopologySpec,
        Queue=m("api.queue").Queue, Resource=m("api.resource").Resource,
        device="google.com/tpu" if pkg == "volcano_tpu" else "nvidia.com/gpu",
        HARD=types_.NetworkTopologyMode.HARD, Phase=types_.PodGroupPhase,
        PIPELINED=types_.TaskStatus.PIPELINED,
        NOMINATED=types_.NOMINATED_HYPERNODES_ANNOTATION,
        PriorityClass=m("cache.cluster").PriorityClass,
        TestContext=m("uthelper").TestContext,
        gang_job=m("uthelper").gang_job, m=m)


REF, PORT = _side("volcano_tpu"), _side("volcano_tpu_torch")


def _domains(s, names):
    """Two 4 x 4 units in one DCN pod / IB fabric named dcn-0, with the
    topology tree discovered."""
    if s is REF:
        return s.m("simulator").make_tpu_cluster([(n, "v5e-16")
                                                 for n in names])
    topo = s.m("api.devices.gpu.topology")
    cluster = s.m("cache.fake_cluster").FakeCluster()
    for n in names:
        for node in s.m("simulator").domain_nodes(
                topo.DomainTopology(n, PRODUCT, 4, 4), ib_fabric="dcn-0"):
            cluster.add_node(node)
    hnc = s.m("controllers.hypernode").HyperNodeController()
    hnc.initialize(cluster)
    hnc.sync()
    return cluster


def _conf(actions, second_tier):
    return {"actions": actions, "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "conformance"}]},
        {"plugins": [{"name": p} for p in second_tier]}]}


PREEMPT_CONF = _conf("enqueue, allocate, preempt, backfill",
                     ["drf", "predicates", "proportion", "nodeorder"])
RECLAIM_CONF = _conf("enqueue, allocate, reclaim, backfill",
                     ["drf", "predicates", "proportion", "nodeorder"])
CAPACITY_CONF = {"actions": "enqueue, allocate, backfill", "tiers": [
    {"plugins": [{"name": "priority"}, {"name": "gang"}]},
    {"plugins": [{"name": "predicates"}, {"name": "capacity"},
                 {"name": "nodeorder"}]}]}
TOPO_TIER = ["predicates", "proportion", "nodeorder", "deviceshare",
             "network-topology-aware"]


def _nodes(s, n, cpu="8"):
    return [s.Node(name=f"n{i}", allocatable={"cpu": cpu, "pods": 110})
            for i in range(n)]


def _hi(s):
    return [s.PriorityClass("high", 1000)]


# each scenario: side -> TestContext; the runner runs its cycles


def preempt(s):
    pg_lo, pods_lo = s.gang_job("lo", replicas=4, min_available=2,
                                requests={"cpu": 4}, running_on=["n0", "n1"],
                                pg_phase=s.Phase.RUNNING)
    pg_hi, pods_hi = s.gang_job("hi", replicas=1, requests={"cpu": 4},
                                priority_class="high",
                                pg_phase=s.Phase.INQUEUE)
    return s.TestContext(nodes=_nodes(s, 2), podgroups=[pg_lo, pg_hi],
                         pods=pods_lo + pods_hi, conf=PREEMPT_CONF,
                         priority_classes=_hi(s))


def gang_floor(s):
    pg_lo, pods_lo = s.gang_job("lo", replicas=2, min_available=2,
                                requests={"cpu": 4}, running_on=["n0", "n1"],
                                pg_phase=s.Phase.RUNNING)
    pg_hi, pods_hi = s.gang_job("hi", replicas=1, requests={"cpu": 4},
                                priority_class="high",
                                pg_phase=s.Phase.INQUEUE)
    return s.TestContext(nodes=_nodes(s, 2), podgroups=[pg_lo, pg_hi],
                         pods=pods_lo + pods_hi, conf=PREEMPT_CONF,
                         priority_classes=_hi(s))


def critical_pods(s):
    pg_lo, pods_lo = s.gang_job("lo", namespace="kube-system", replicas=4,
                                min_available=2, requests={"cpu": 4},
                                running_on=["n0", "n1"],
                                pg_phase=s.Phase.RUNNING)
    pg_hi, pods_hi = s.gang_job("hi", replicas=1, requests={"cpu": 4},
                                priority_class="high",
                                pg_phase=s.Phase.INQUEUE)
    return s.TestContext(nodes=_nodes(s, 2), podgroups=[pg_lo, pg_hi],
                         pods=pods_lo + pods_hi, conf=PREEMPT_CONF,
                         priority_classes=_hi(s))


def reclaim(s, reclaimable=True, min_available=2):
    q_a = s.Queue(name="qa", weight=3)
    q_b = s.Queue(name="qb", weight=1, reclaimable=reclaimable)
    pg_b, pods_b = s.gang_job("jb", queue="qb", replicas=4, min_available=1,
                              requests={"cpu": 4}, running_on=["n0", "n1"],
                              pg_phase=s.Phase.RUNNING)
    pg_a, pods_a = s.gang_job("ja", queue="qa", replicas=2,
                              min_available=min_available,
                              requests={"cpu": 4},
                              pg_phase=s.Phase.INQUEUE)
    return s.TestContext(nodes=_nodes(s, 2), queues=[q_a, q_b],
                         podgroups=[pg_b, pg_a], pods=pods_b + pods_a,
                         conf=RECLAIM_CONF)


def unreclaimable(s):
    return reclaim(s, reclaimable=False, min_available=None)


def capacity(s):
    eng = s.Queue(name="eng", deserved=s.Resource({"cpu": 16000}))
    ml = s.Queue(name="ml", parent="eng",
                 deserved=s.Resource({"cpu": 12000}))
    web = s.Queue(name="web", parent="eng",
                  deserved=s.Resource({"cpu": 4000}))
    pg_w, pods_w = s.gang_job("wj", queue="web", replicas=4,
                              min_available=1, requests={"cpu": 2})
    return s.TestContext(nodes=_nodes(s, 4, cpu="8"), queues=[eng, ml, web],
                         podgroups=[pg_w], pods=pods_w, conf=CAPACITY_CONF)


def _gang_topology(s, action, queues, weights=(1, 1), filler_min=1):
    cluster = _domains(s, ("sa", "sb"))
    filler_queue, train_queue = queues or ("default", "default")
    for q, w in zip(queues, weights):
        cluster.add_queue(s.Queue(name=q, weight=w))
    for d in ("sa", "sb"):
        pg, pods = s.gang_job(f"filler-{d}", queue=filler_queue, replicas=4,
                              min_available=filler_min,
                              requests={"cpu": 8, s.device: 4},
                              running_on=[f"{d}-w{i}" for i in range(4)],
                              pg_phase=s.Phase.RUNNING)
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
    name = "owed-train" if queues else "train"
    pg_hi, pods_hi = s.gang_job(
        name, queue=train_queue, replicas=4,
        requests={"cpu": 8, s.device: 4},
        priority_class="" if queues else "high",
        network_topology=s.Topo(s.HARD, 1), pg_phase=s.Phase.INQUEUE)
    cluster.add_podgroup(pg_hi)
    for p in pods_hi:
        cluster.add_pod(p)
    if not queues:
        cluster.add_priority_class(s.PriorityClass("high", 1000))
    return s.TestContext(cluster=cluster, conf=_conf(
        f"enqueue, allocate, {action}, backfill", TOPO_TIER))


def gangpreempt(s):
    return _gang_topology(s, "gangpreempt", ())


def gangreclaim(s):
    return _gang_topology(s, "gangreclaim", ("greedy", "owed"))


def gangreclaim_whole_gangs(s):
    """The state of chip_smoke.py's round 3 at a small size: the
    domains held by whole gangs (minAvailable = replicas) of a queue
    above its share after the weights turned 1:3, gangpreempt beside
    gangreclaim on the conf."""
    return _gang_topology(s, "gangpreempt, gangreclaim", ("prod", "research"),
                          weights=(1, 3), filler_min=4)


EVENT_WORDS = (("google.com/tpu", "nvidia.com/gpu"),
               ("TPU slice", "NVLink domain"), ("chips", "GPUs"),
               ("TPU", "GPU"))


def _norm(text):
    for tpu, gpu in EVENT_WORDS:
        text = text.replace(tpu, gpu)
    return text


def _trace(s, build, cycles):
    """Run `build(s)`'s context `cycles` times, the kubelet finishing
    evictions (two ticks) between cycles; returns the context and each
    cycle's record."""
    s.pod._uid_counter = itertools.count(1)
    ctx = build(s)
    c = ctx.cluster
    out = []
    for i in range(cycles):
        if i:
            c.tick()
            c.tick()
        n_ev, n_b, n_e = len(c.evictions), len(c.binds), len(c.events)
        ssn = ctx.run()
        out.append({
            "evictions": c.evictions[n_ev:],
            "binds": c.binds[n_b:],
            "pipelined": sorted((t.key, t.node_name)
                                for j in ssn.jobs.values()
                                for t in j.tasks.values()
                                if t.status is s.PIPELINED),
            "nominations": {k: pg.annotations[s.NOMINATED]
                            for k, pg in sorted(c.podgroups.items())
                            if s.NOMINATED in pg.annotations},
            "events": [(k, r, _norm(m)) for k, r, m in c.events[n_e:]]})
    return ctx, out


def _slice_of(node):
    return node.rsplit("-w", 1)[0]


def check_preempt(c):
    assert len(c.evictions) == 1 and c.evictions[0].startswith("default/lo")


def check_none(c):
    assert c.evictions == []


def check_reclaim(c):
    assert c.evictions and all(k.startswith("default/jb")
                               for k in c.evictions)
    assert sum(1 for k, _ in c.binds if k.startswith("default/ja")) == 2


def check_capacity(c):
    assert len(c.binds) == 2


def _check_gang(name, nomination):
    def check(c):
        assert len(c.evictions) >= 3
        assert all("filler" in e for e in c.evictions)
        assert nomination
        nodes = {n for k, n in c.binds if k.startswith(f"default/{name}")}
        assert len(nodes) == 4 and len({_slice_of(n) for n in nodes}) == 1
    return check


SCENARIOS = {
    "preempt": (preempt, 1, check_preempt),
    "gang_floor": (gang_floor, 1, check_none),
    "critical_pods": (critical_pods, 1, check_none),
    "reclaim": (reclaim, 2, check_reclaim),
    "unreclaimable_queue": (unreclaimable, 1, check_none),
    "hierarchical_capacity": (capacity, 1, check_capacity),
    "gangpreempt_two_cycle": (gangpreempt, 2, None),
    "gangreclaim": (gangreclaim, 2, None),
    "gangreclaim_whole_gangs": (gangreclaim_whole_gangs, 2, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, cycles, check = SCENARIOS[name]
    rctx, want = _trace(REF, build, cycles)
    tctx, got = _trace(PORT, build, cycles)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"cycle {i} differs"
    if check is None:
        job = "train" if name.startswith("gangpreempt") else "owed-train"
        check = _check_gang(job, want[0]["nominations"].get(
            f"default/{job}"))
    for ctx in (rctx, tctx):
        check(ctx.cluster)


# -- a parity stream under the preempting conf ---------------------------

PREEMPTING_ACTIONS = ["enqueue", "allocate", "elastic", "gangpreempt",
                      "preempt", "reclaim", "backfill"]


class PreemptingPlane(Plane):
    """`Plane` under the default conf with gangpreempt, preempt and
    reclaim inserted before backfill, and a high PriorityClass."""

    def __init__(self, side, domains, queues=()):
        super().__init__(side, domains, queues)
        assert self.sched.conf.actions == ["enqueue", "allocate", "elastic",
                                           "backfill"]
        self.sched.conf.actions = list(PREEMPTING_ACTIONS)
        pkg = side.pod.__name__.rsplit(".", 2)[0]
        self.cluster.add_priority_class(importlib.import_module(
            f"{pkg}.cache.cluster").PriorityClass("high", 1000))

    def submit(self, spec, priority=""):
        super().submit(spec)
        self.cluster.vcjobs[f"default/{spec[0]}"].priority_class = priority

    def state(self):
        out = super().state()
        out["evictions"] = list(self.cluster.evictions)
        out["events"] = [(k, r, _norm(m)) for k, r, m in self.cluster.events]
        return out


def test_stream_under_the_preempting_conf():
    """Two low-priority gangs (4 whole hosts, minAvailable 1) fill the two
    4 x 4 domains in queue q-b (weight 1); then a high-priority
    hard-topology gang of 4 hosts arrives in q-b (gangpreempt takes a
    domain from a filler) and two high-priority single-host jobs in q-a
    (weight 3; reclaim takes q-b's surplus).  Each cycle the two planes'
    pods, phases, evictions and events are equal."""
    domains = [("sa", (4, 4), "p0"), ("sb", (4, 4), "p0")]
    queues = [("q-a", 3), ("q-b", 1)]
    ref = PreemptingPlane(PLANE_REF, domains, queues)
    port = PreemptingPlane(PLANE_PORT, domains, queues)
    stream = {0: [((f"fill{i}", [("worker", 4, 4, "")], 1, "q-b", 40, None),
                   "") for i in range(2)],
              3: [(("gang", [("worker", 4, 4, "")], 4, "q-b", 4, 1), "high"),
                  (("one", [("worker", 1, 4, "")], 1, "q-a", 4, None),
                   "high"),
                  (("two", [("worker", 1, 4, "")], 1, "q-a", 4, None),
                   "high")]}
    states = []
    for cycle in range(12):
        for spec, priority in stream.get(cycle, ()):
            ref.submit(spec, priority)
            port.submit(spec, priority)
        ref.cycle()
        port.cycle()
        want, got = ref.state(), port.state()
        assert got == want, f"cycle {cycle} differs"
        states.append(want)
    last = states[-1]
    assert last["evictions"], "no preemption fired"
    assert all(k.startswith("default/fill") for k in last["evictions"])
    reasons = {m.split(" ")[0] for _, r, m in last["events"] if r == "Evict"}
    assert reasons == {"gang-preempted", "reclaimed"}, reasons
    for job in ("gang", "one", "two"):
        assert last["jobs"][f"default/{job}"] in ("Running", "Completed")

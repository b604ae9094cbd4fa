"""The policy plugins of the port against the reference's: capacity,
sla, pdb, cdp, tdm, nodegroup, usage, resourcequota, task-topology,
resource-strategy-fit, numaaware (with numa_policy, its hint algebra),
extender, rescheduling (with the shuffle action), datalocality, dra and
serving.

Each scenario runs through both packages' `uthelper.TestContext` under
a conf that names its plugin, on mirrored clusters (node names equal,
`google.com/tpu` mirrored by `nvidia.com/gpu`).  Three plugins run
with a name mapped: numaaware's legacy annotation counts `tpu` / `gpu`
per cell, its Numatopology objects come from `tpu_host_numatopology` /
`gpu_host_numatopology`, and rescheduling's defragmentation strategy
is `tpuFragmentation` / `gpuFragmentation`.  After every cycle the
binds, evictions, pipelined tasks, nominations and events (device
words mapped) must be equal; the reference test's own assertion then
holds on both sides.  Tolerance: exact.
"""

import json
import random
import time

import pytest

from test_torch_preempt_parity import PORT, REF, _trace

NIGHT = "volcano-tpu.io/revocable-zone"


def conf_with(*plugin_specs, actions="enqueue, allocate, backfill"):
    plugins = [{"name": "gang"}, {"name": "predicates"},
               {"name": "nodeorder"}]
    plugins += [p if isinstance(p, dict) else {"name": p}
                for p in plugin_specs]
    return {"actions": actions, "tiers": [{"plugins": plugins}]}


def nodes(s, n, cpu="8", labels=None, annotations=None):
    return [s.Node(name=f"n{i}", allocatable={"cpu": cpu, "pods": 110},
                   labels=dict(labels or {}),
                   annotations=dict(annotations or {}))
            for i in range(n)]


def _numa_key(s):
    return "tpu" if s is REF else "gpu"


def _host_numa(s, name, cpu_millis, devices, cells, policy):
    topo = s.m("api.numatopology")
    build = topo.tpu_host_numatopology if s is REF else \
        topo.gpu_host_numatopology
    return build(name, cpu_millis, devices, numa_cells=cells, policy=policy)


def _frag(s):
    return "tpuFragmentation" if s is REF else "gpuFragmentation"


# -- scenarios: side -> TestContext ---------------------------------------


def capacity(s):
    eng = s.Queue(name="eng", deserved=s.Resource({"cpu": 32000,
                                                   s.device: 8}))
    ml = s.Queue(name="ml", parent="eng",
                 deserved=s.Resource({"cpu": 24000, s.device: 6}))
    web = s.Queue(name="web", parent="eng",
                  deserved=s.Resource({"cpu": 8000, s.device: 2}))
    hosts = [s.Node(name=f"h{i}", allocatable={"cpu": 16, s.device: 4,
                                               "pods": 110})
             for i in range(4)]
    pg_w, pods_w = s.gang_job("wj", queue="web", replicas=4,
                              min_available=1,
                              requests={"cpu": 1, s.device: 1})
    pg_m, pods_m = s.gang_job("mj", queue="ml", replicas=8,
                              min_available=1,
                              requests={"cpu": 1, s.device: 1})
    return s.TestContext(nodes=hosts, queues=[eng, ml, web],
                         podgroups=[pg_w, pg_m], pods=pods_w + pods_m,
                         conf=conf_with("priority", "capacity"))


def sla(s):
    pg, pods = s.gang_job("waiting", replicas=1, requests={"cpu": 1})
    pg.creation_time = time.time() - 3600
    pg.annotations["sla.volcano-tpu.io/waiting-time"] = "60"
    return s.TestContext(nodes=nodes(s, 1), podgroups=[pg], pods=pods,
                         conf=conf_with("sla"))


def _lo_hi(s, annotate, plugin):
    pg_lo, pods_lo = s.gang_job("lo", replicas=2, min_available=1,
                                requests={"cpu": 4}, running_on=["n0", "n1"],
                                pg_phase=s.Phase.RUNNING)
    for p in pods_lo:
        annotate(p)
    pg_hi, pods_hi = s.gang_job("hi", replicas=1, requests={"cpu": 4},
                                priority_class="high",
                                pg_phase=s.Phase.INQUEUE)
    return s.TestContext(nodes=nodes(s, 2, cpu="4"),
                         podgroups=[pg_lo, pg_hi], pods=pods_lo + pods_hi,
                         priority_classes=[s.PriorityClass("high", 1000)],
                         conf=conf_with("priority", plugin,
                                        actions="enqueue, allocate, preempt"))


def pdb(s):
    def annotate(p):
        p.annotations["volcano-tpu.io/disruption-group"] = "db"
        p.annotations["volcano-tpu.io/min-available"] = "2"
    return _lo_hi(s, annotate, "pdb")


def pdb_allows(s):
    def annotate(p):
        p.annotations["volcano-tpu.io/disruption-group"] = "db"
        p.annotations["volcano-tpu.io/min-available"] = "1"
    return _lo_hi(s, annotate, "pdb")


def cdp(s):
    now = str(time.time())
    return _lo_hi(s, lambda p: p.annotations.update(
        {"volcano-tpu.io/start-time": now}), "cdp")


def cdp_cooled(s):
    then = str(time.time() - 3600)
    return _lo_hi(s, lambda p: p.annotations.update(
        {"volcano-tpu.io/start-time": then}), "cdp")


def _revocable(s):
    return s.Node(name="rev0", allocatable={"cpu": 8},
                  labels={NIGHT: "night"})


def tdm_gates(s):
    zone = s.m("api.types").REVOCABLE_ZONE_ANNOTATION
    pg, pods = s.gang_job("batch", replicas=1, requests={"cpu": 1})
    pods[0].annotations[zone] = "night"
    pg2, pods2 = s.gang_job("normal", replicas=1, requests={"cpu": 1})
    return s.TestContext(
        nodes=[_revocable(s), s.Node(name="n0", allocatable={"cpu": 1})],
        podgroups=[pg, pg2], pods=pods + pods2,
        conf=conf_with({"name": "tdm", "arguments":
                        {"tdm.revocable-zone.night": "*"}}))


def tdm_shuffle(s):
    zone = s.m("api.types").REVOCABLE_ZONE_ANNOTATION
    pg, pods = s.gang_job("evictme", replicas=1, min_available=0,
                          requests={"cpu": 1}, running_on=["rev0"],
                          pg_phase=s.Phase.RUNNING)
    pods[0].annotations[zone] = "night"
    return s.TestContext(
        nodes=[_revocable(s)], podgroups=[pg], pods=pods,
        conf=conf_with({"name": "tdm", "arguments":
                        {"tdm.revocable-zone.night": "23:59-23:59"}},
                       actions="shuffle"))


def nodegroup(s):
    label = s.m("api.types").NODEGROUP_LABEL
    q = s.Queue(name="mlq")
    q.annotations["nodegroup.volcano-tpu.io/affinity"] = "ml-nodes"
    q2 = s.Queue(name="webq")
    q2.annotations["nodegroup.volcano-tpu.io/anti-affinity"] = "ml-nodes"
    hosts = nodes(s, 2, labels={label: "ml-nodes"}) + \
        [s.Node(name="other", allocatable={"cpu": 8},
                labels={label: "web"})]
    pg, pods = s.gang_job("mljob", queue="mlq", replicas=3,
                          min_available=1, requests={"cpu": 4})
    pg2, pods2 = s.gang_job("webjob", queue="webq", replicas=2,
                            min_available=1, requests={"cpu": 4})
    return s.TestContext(nodes=hosts, queues=[q, q2], podgroups=[pg, pg2],
                         pods=pods + pods2, conf=conf_with("nodegroup"))


def usage(s):
    hot = s.Node(name="hot", allocatable={"cpu": 8},
                 annotations={"usage.volcano-tpu.io/cpu": "0.95"})
    warm = s.Node(name="warm", allocatable={"cpu": 8},
                  annotations={"usage.volcano-tpu.io/cpu": "0.5",
                               "usage.volcano-tpu.io/memory": "0.7"})
    cool = s.Node(name="cool", allocatable={"cpu": 8},
                  annotations={"usage.volcano-tpu.io/cpu": "0.1"})
    pg, pods = s.gang_job("j", replicas=3, min_available=1,
                          requests={"cpu": 4})
    return s.TestContext(nodes=[hot, warm, cool], podgroups=[pg], pods=pods,
                         conf=conf_with("usage"))


def resourcequota(s):
    pg, pods = s.gang_job("quotajob", replicas=4, requests={"cpu": 4})
    pg2, pods2 = s.gang_job("small", namespace="team", replicas=2,
                            requests={"cpu": 4})
    ctx = s.TestContext(nodes=nodes(s, 4), podgroups=[pg, pg2],
                        pods=pods + pods2, conf=conf_with("resourcequota"))
    ctx.cluster.config_maps["resourcequota/default"] = {"cpu": 8}
    ctx.cluster.config_maps["resourcequota/team"] = {"cpu": 8}
    return ctx


def task_topology(s):
    pg, pods = s.gang_job("pair", replicas=2, requests={"cpu": 1})
    pg.annotations["task-topology.volcano-tpu.io/affinity"] = \
        "worker/worker"
    pg2, pods2 = s.gang_job("apart", replicas=2, requests={"cpu": 1})
    pg2.annotations["task-topology.volcano-tpu.io/anti-affinity"] = \
        "worker/worker"
    return s.TestContext(nodes=nodes(s, 3, cpu="8"), podgroups=[pg, pg2],
                         pods=pods + pods2, conf=conf_with("task-topology"))


def resource_strategy_fit(s):
    hosts = [s.Node(name=f"t{i}", allocatable={"cpu": 8, s.device: 8})
             for i in range(2)]
    pg0, pods0 = s.gang_job("seed", replicas=1, requests={s.device: 2},
                            running_on=["t1"], pg_phase=s.Phase.RUNNING)
    pg, pods = s.gang_job("packme", replicas=3, min_available=1,
                          requests={s.device: 2})
    return s.TestContext(nodes=hosts, podgroups=[pg0, pg], pods=pods0 + pods,
                         conf=conf_with({"name": "resource-strategy-fit",
                                         "arguments":
                                         {"resourceStrategyFitWeight": 5}}))


def resource_strategy_fit_sra(s):
    hosts = [s.Node(name="gpu0", allocatable={"cpu": 8, s.device: 8}),
             s.Node(name="cpu0", allocatable={"cpu": 8})]
    pg, pods = s.gang_job("cpuonly", replicas=2, min_available=1,
                          requests={"cpu": 2})
    return s.TestContext(nodes=hosts, podgroups=[pg], pods=pods,
                         conf=conf_with({"name": "resource-strategy-fit",
                                         "arguments": {
                                             "sra.weight": 5,
                                             "sra.resources": s.device}}))


def numaaware_annotation(s):
    key = _numa_key(s)
    split = json.dumps({"0": {"cpu": 4, key: 4}, "1": {"cpu": 4, key: 4}})
    whole = json.dumps({"0": {"cpu": 8, key: 8}})
    hosts = [s.Node(name="split", allocatable={"cpu": 8, s.device: 8},
                    annotations={"numa.volcano-tpu.io/nodes": split}),
             s.Node(name="fat", allocatable={"cpu": 8, s.device: 8},
                    annotations={"numa.volcano-tpu.io/nodes": whole})]
    pg, pods = s.gang_job("numajob", replicas=1,
                          requests={"cpu": 2, s.device: 6})
    pods[0].annotations["numa.volcano-tpu.io/policy"] = "single-numa-node"
    pg2, pods2 = s.gang_job("small", replicas=2, min_available=1,
                            requests={"cpu": 2, s.device: 4})
    for p in pods2:
        p.annotations["numa.volcano-tpu.io/policy"] = "restricted"
    return s.TestContext(nodes=hosts, podgroups=[pg, pg2],
                         pods=pods + pods2, conf=conf_with("numaaware"))


def numaaware_topology(s):
    cluster = s.m("cache.fake_cluster").FakeCluster()
    cluster.add_node(s.Node(name="host", allocatable={
        "cpu": 112, s.device: 8, "pods": 110}))
    cluster.add_node(s.Node(name="host2", allocatable={
        "cpu": 112, s.device: 8, "pods": 110}))
    cluster.add_numatopology(_host_numa(s, "host", 112000, 8, 2,
                                        "best-effort"))
    cluster.add_numatopology(_host_numa(s, "host2", 112000, 8, 2,
                                        "single-numa-node"))
    pg, pods = s.gang_job("chips", replicas=1,
                          requests={"cpu": 8, s.device: 8})
    pods[0].annotations["numa.volcano-tpu.io/policy"] = "single-numa-node"
    pg2, pods2 = s.gang_job("halves", replicas=4, min_available=1,
                            requests={"cpu": 8, s.device: 4})
    return s.TestContext(cluster=cluster, podgroups=[pg, pg2],
                         pods=pods + pods2, conf=conf_with("numaaware"))


class _VetoN0:
    def predicate(self, task, node):
        return "n0 is cursed" if node.name == "n0" else None

    def score(self, task, node):
        return 10.0 if node.name == "n2" else 0.0


def extender(s):
    ext = s.m("plugins.extender")
    ext.register_extender("test-veto", _VetoN0())
    pg, pods = s.gang_job("extjob", replicas=2, min_available=1,
                          requests={"cpu": 4})
    return s.TestContext(nodes=nodes(s, 3), podgroups=[pg], pods=pods,
                         conf=conf_with("extender"))


def rescheduling_lnu(s):
    busy = s.Node(name="busy", allocatable={"cpu": 8})
    idle = s.Node(name="idle", allocatable={"cpu": 8})
    pg, pods = s.gang_job("spread", replicas=2, min_available=0,
                          requests={"cpu": 4}, running_on=["busy"],
                          pg_phase=s.Phase.RUNNING)
    return s.TestContext(
        nodes=[busy, idle], podgroups=[pg], pods=pods,
        conf=conf_with({"name": "rescheduling", "arguments":
                        {"rescheduling.interval": 0}}, actions="shuffle"))


def rescheduling_fragmentation(s):
    hosts = [s.Node(name=f"h{i}", allocatable={"cpu": 16, s.device: 8,
                                               "pods": 110})
             for i in range(4)]
    pgs, pods = [], []
    for name, devices, host in (("packa", 1, "h0"), ("packb", 2, "h1"),
                                ("packc", 6, "h2"), ("packd", 3, "h3")):
        pg, ps = s.gang_job(name, replicas=1, min_available=0,
                            requests={"cpu": 1, s.device: devices},
                            running_on=[host], pg_phase=s.Phase.RUNNING)
        pgs.append(pg)
        pods.extend(ps)
    return s.TestContext(
        nodes=hosts, podgroups=pgs, pods=pods,
        conf=conf_with({"name": "rescheduling", "arguments": {
            "rescheduling.interval": 0,
            "rescheduling.strategies": _frag(s)}}, actions="shuffle"))


def datalocality(s):
    hosts = [s.Node(name="data0", allocatable={"cpu": 8}),
             s.Node(name="far0", allocatable={"cpu": 8})]
    pg, pods = s.gang_job("trainer", replicas=1, requests={"cpu": 1})
    pods[0].annotations["data.volcano-tpu.io/claims"] = "imagenet"
    pg2, pods2 = s.gang_job("strict", replicas=1, requests={"cpu": 1})
    pods2[0].annotations["data.volcano-tpu.io/claims"] = "ckpt"
    pods2[0].annotations["data.volcano-tpu.io/claim-mode"] = "hard"
    ctx = s.TestContext(nodes=hosts, podgroups=[pg, pg2], pods=pods + pods2,
                        conf={"actions": "enqueue, allocate",
                              "tiers": [{"plugins": [
                                  {"name": "gang"}, {"name": "predicates"},
                                  {"name": "datalocality"}]}]})
    ctx.cluster.datasources = {"imagenet": {"nodes": ["data0"]},
                               "ckpt": {"nodes": ["gone"]}}
    return ctx


def dra(s):
    hosts = [s.Node(name=n, allocatable={"cpu": 32, "pods": 110})
             for n in ("n0", "n1", "n2")]
    pgs, pods = [], []
    for i, claims in enumerate((["claim-a"], ["c1"], ["c2"], ["pinned"])):
        pg, ps = s.gang_job(f"j{i}", replicas=1, requests={"cpu": 1})
        ps[0].annotations["dra.volcano-tpu.io/claims"] = ",".join(claims)
        pgs.append(pg)
        pods.extend(ps)
    ctx = s.TestContext(nodes=hosts, podgroups=pgs, pods=pods, conf={
        "actions": "enqueue, allocate",
        "tiers": [{"plugins": [{"name": "gang"}, {"name": "predicates"},
                               {"name": "dra"}]}]})
    free = {"allocated_node": "", "allocated_devices": []}
    ctx.cluster.resource_claims = {
        "claim-a": dict(free, **{"class": "accel", "count": 1}),
        "c1": dict(free, **{"class": "accel", "count": 1}),
        "c2": dict(free, **{"class": "accel", "count": 1}),
        "pinned": {"class": "accel", "count": 1, "allocated_node": "n2",
                   "allocated_devices": ["d2"]}}
    ctx.cluster.resource_slices = {
        "n0": [], "n1": [{"name": "d0", "class": "accel"}],
        "n2": [{"name": "d2", "class": "accel"}]}
    return ctx


def serving(s):
    sapi = s.m("api.serving")
    pg, pods = s.gang_job("svc", replicas=3, min_available=3,
                          requests={"cpu": 6})
    pg.annotations[sapi.SLO_P99_MS_ANNOTATION] = "200"
    pg.annotations[sapi.PG_POOL_SLICES_ANNOTATION] = "sa,sb"
    pg.phase = s.Phase.INQUEUE
    return s.TestContext(nodes=nodes(s, 2), podgroups=[pg], pods=pods,
                         conf=conf_with("serving"))


SCENARIOS = {
    "capacity": (capacity, 1),
    "sla": (sla, 1),
    "pdb_blocks": (pdb, 1),
    "pdb_allows": (pdb_allows, 1),
    "cdp_shields": (cdp, 1),
    "cdp_cooled": (cdp_cooled, 1),
    "tdm_gates": (tdm_gates, 1),
    "tdm_shuffle": (tdm_shuffle, 1),
    "nodegroup": (nodegroup, 1),
    "usage": (usage, 1),
    "resourcequota": (resourcequota, 1),
    "task_topology": (task_topology, 1),
    "resource_strategy_fit": (resource_strategy_fit, 1),
    "resource_strategy_fit_sra": (resource_strategy_fit_sra, 1),
    "numaaware_annotation": (numaaware_annotation, 1),
    "numaaware_topology": (numaaware_topology, 1),
    "extender": (extender, 1),
    "rescheduling_lnu": (rescheduling_lnu, 2),
    "rescheduling_fragmentation": (rescheduling_fragmentation, 2),
    "datalocality": (datalocality, 1),
    "dra": (dra, 1),
    "serving": (serving, 1),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_plugin_matches_reference(name):
    build, cycles = SCENARIOS[name]
    try:
        rctx, want = _trace(REF, build, cycles)
        tctx, got = _trace(PORT, build, cycles)
    finally:
        for s in (REF, PORT):
            s.m("plugins.extender")._EXTENDERS.pop("test-veto", None)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"cycle {i} differs"
    assert any(w["binds"] or w["evictions"] for w in want) or \
        name in NOTHING_MOVES, f"{name}: nothing placed or evicted"
    for ctx in (rctx, tctx):
        assert CHECKS.get(name, lambda c: True)(ctx.cluster), name
    if name == "serving":
        assert tctx.last_session.serving_anchor_slices == \
            rctx.last_session.serving_anchor_slices == {"sa", "sb"}


# scenarios whose verdict is that nothing moves (the events hold it)
NOTHING_MOVES = {"pdb_blocks", "cdp_shields", "serving"}

CHECKS = {
    "sla": lambda c: c.binds == [("default/waiting-0", "n0")],
    "pdb_blocks": lambda c: c.evictions == [],
    "pdb_allows": lambda c: len(c.evictions) == 1,
    "cdp_shields": lambda c: c.evictions == [],
    "cdp_cooled": lambda c: len(c.evictions) == 1,
    "rescheduling_fragmentation": lambda c: c.evictions[0] ==
    "default/packa-0",
    "tdm_gates": lambda c: dict(c.binds) == {"default/batch-0": "rev0",
                                             "default/normal-0": "n0"},
    "tdm_shuffle": lambda c: c.evictions == ["default/evictme-0"],
    "dra": lambda c: c.resource_claims["claim-a"]["allocated_devices"]
    in (["d0"], ["d2"]),
}


@pytest.mark.parametrize("seed", range(4))
def test_numa_policy_hints_match_reference(seed):
    """numa_policy's hint algebra (numaaware's core): the merged hint and
    the admit verdict for random cells, needs and policies."""
    ref, port = REF.m("plugins.numa_policy"), PORT.m("plugins.numa_policy")
    rng = random.Random(seed)
    for _ in range(200):
        n = rng.randint(1, 4)
        cells = [[float(rng.choice((0, 2000, 4000, 8000))),
                  float(rng.randint(0, 4))] for _ in range(n)]
        needs = (float(rng.choice((0, 1000, 3000, 6000, 12000))),
                 float(rng.randint(0, 6)))
        (want, want_ok) = ref.merged_hint_for(cells, needs)
        (got, got_ok) = port.merged_hint_for(cells, needs)
        assert (got.mask, got.preferred, got_ok) == \
            (want.mask, want.preferred, want_ok)
        for policy in ("none", "best-effort", "restricted",
                       "single-numa-node"):
            assert port.admit(policy, got) == ref.admit(policy, want)

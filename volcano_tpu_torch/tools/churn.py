"""Whole-scheduler churn fuzz: random gang arrivals/deletions under the
FULL contention pipeline (enqueue, allocate, preempt, reclaim,
gangpreempt, backfill, shuffle) with accounting invariants asserted
after every cycle.

The port's copy of the reference's ``churn_episode`` and its invariants
(``tests/test_fuzz_scheduler.py``), on the mirrored GPU cluster: each of
the reference's v5e slices (4 chips a host) is an NVLink domain of as
many hosts of 4 GPUs, node names equal.  The port's fuzz test and
``volcano_tpu_torch/tools/fuzz_sweep.py`` share it.
"""

import random

from volcano_tpu_torch.api.devices.gpu.topology import (H100_SXM,
                                                        DomainTopology)
from volcano_tpu_torch.api.pod import make_pod
from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.cache.cluster import PriorityClass
from volcano_tpu_torch.api.resource import GPU, Resource
from volcano_tpu_torch.api.types import (GROUP_NAME_ANNOTATION,
                                         PodGroupPhase, TaskStatus)
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.simulator import domain_nodes, make_gpu_cluster

FULL_CONF = {
    "actions": "enqueue, allocate, preempt, reclaim, gangpreempt, "
               "backfill, shuffle",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "deviceshare"},
                     {"name": "proportion"}, {"name": "nodeorder"},
                     {"name": "binpack"}, {"name": "pdb"},
                     {"name": "cdp"}]},
    ],
}

OCCUPYING = (TaskStatus.RUNNING, TaskStatus.BOUND, TaskStatus.BINDING)


def check_invariants(cluster):
    # 1. every placed pod's node exists; per-node sums fit allocatable
    per_node = {}
    for pod in cluster.pods.values():
        if not pod.node_name:
            continue
        if pod.phase not in OCCUPYING:
            continue
        assert pod.node_name in cluster.nodes, \
            f"pod {pod.key} bound to unknown node {pod.node_name}"
        per_node.setdefault(pod.node_name, []).append(pod)
    for node_name, pods in per_node.items():
        alloc = Resource.from_resource_list(
            cluster.nodes[node_name].allocatable)
        used = Resource()
        for p in pods:
            used.add(p.resource_requests())
        assert used.less_equal(alloc), \
            f"node {node_name} over-allocated: {used} > {alloc}"
        # 2. every NVLink domain here is multi-host, so hosts are
        # whole-host atomic: at most ONE GPU-holding pod per host
        gpu_pods = [p for p in pods if p.resource_requests().get(GPU)]
        assert len(gpu_pods) <= 1, \
            f"multi-host domain host {node_name} split between " \
            f"{[p.key for p in gpu_pods]}"
    # 3. a placed pod's node matches its LAST bind log entry (earlier
    # entries may differ legitimately after evict + re-place)
    last_bind = {}
    for key, node in cluster.binds:
        last_bind[key] = node
    for pod in cluster.pods.values():
        if pod.node_name and pod.phase in OCCUPYING and \
                pod.key in last_bind:
            assert pod.node_name == last_bind[pod.key], \
                f"{pod.key} on {pod.node_name} but last bound to " \
                f"{last_bind[pod.key]}"
    # 4. running gangs hold their minAvailable floor (the group
    # annotation may be the short name or the namespaced key)
    for pg in cluster.podgroups.values():
        if pg.phase is not PodGroupPhase.RUNNING:
            continue
        members = sum(
            1 for p in cluster.pods.values()
            if p.annotations.get(GROUP_NAME_ANNOTATION) in (pg.key,
                                                            pg.name)
            and p.phase in OCCUPYING and p.node_name)
        assert members >= pg.min_member, \
            f"gang {pg.key} nibbled below floor: " \
            f"{members}/{pg.min_member}"


def churn_episode(seed, steps=60, gang_sizes=(1, 2, 4, 4, 8),
                  p_new=0.55, p_del=0.75, p_prio=0.85,
                  p_weight=None):
    """One randomized contention episode with per-cycle invariants —
    shared by the port's fuzz test (tests/test_torch_fuzz.py, the
    reference's fixed seeds) and the extended sweep
    (volcano_tpu_torch/tools/fuzz_sweep.py), so new ops/invariants
    reach both.
    p_weight, when set, adds a queue-weight flip op driven through
    the real add_queue update path (upsert + notify — an in-place
    mutation would bypass the event-driven invalidation the op
    exists to stress)."""
    from volcano_tpu_torch.api.podgroup import PodGroup

    rng = random.Random(seed)
    cluster = make_gpu_cluster([], extra_nodes=[
        node for name, hosts in (("sa", 4), ("sb", 4), ("sc", 16))
        for node in domain_nodes(DomainTopology(name, H100_SXM, hosts, 4),
                                 ib_fabric="ib-0")])
    cluster.add_queue(Queue(name="gold", weight=3))
    cluster.add_queue(Queue(name="dirt", weight=1))
    cluster.add_priority_class(PriorityClass(name="high", value=1000))
    cluster.add_priority_class(PriorityClass(name="low", value=10))
    sched = Scheduler(cluster, conf=FULL_CONF, schedule_period=0)

    live = []
    for step in range(steps):
        op = rng.random()
        if op < p_new:
            # new gang job: random size/queue/priority
            n = rng.choice(gang_sizes)
            name = f"j{seed}-{step}"
            pg = PodGroup(name=f"pg-{name}", min_member=n,
                          queue=rng.choice(("gold", "dirt")),
                          priority_class=rng.choice(("", "high",
                                                     "low")))
            cluster.add_podgroup(pg)
            for i in range(n):
                cluster.add_pod(make_pod(
                    f"{name}-{i}",
                    requests={"cpu": rng.choice((1, 4)),
                              GPU: rng.choice((0, 4, 4))},
                    annotations={GROUP_NAME_ANNOTATION: pg.key},
                    priority_class=pg.priority_class))
            live.append((pg, name, n))
        elif op < p_del and live:
            # delete a random live job (releases its resources) —
            # through delete_podgroup so the podgroup_deleted
            # invalidation path fires, not a silent dict pop
            pg, name, n = live.pop(rng.randrange(len(live)))
            for i in range(n):
                cluster.delete_pod(f"default/{name}-{i}")
            cluster.delete_podgroup(pg.key)
        elif op < p_prio:
            # control-kind churn: a priority class vanishes and
            # returns with a FLIPPED value mid-flight — the
            # incremental snapshot must rebuild job priorities,
            # never preempt/order on a stale one (the *_deleted
            # invalidation path)
            victim = rng.choice(("high", "low"))
            old = cluster.priority_classes[victim].value
            cluster.delete_object("priority_class", victim)
            cluster.add_priority_class(PriorityClass(
                name=victim, value=1010 - old))
        elif p_weight is not None and op < p_weight:
            # queue-weight flip mid-flight, through the notify path:
            # fair-share state must follow, never a stale weight
            name = rng.choice(("gold", "dirt"))
            cluster.add_queue(Queue(name=name,
                                    weight=rng.choice((1, 2, 3, 5))))
        sched.run_once()
        cluster.tick()
        check_invariants(cluster)

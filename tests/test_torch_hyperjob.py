"""The port's HyperJob controller against the reference's, on mirrored
clusters: two TPU v5e-16 slices in two DCN pods on the reference's
side, two 4 x 4 NVLink domains in two IB fabrics on the port's, node
names equal.

A replicated job split over the two fabrics as member domains gives
the same member jobs on both sides (names, replicas, gang sizes), the
same forward annotations, and the same affinity terms with the
domain's label mapped (volcano-tpu.io/dcn-pod -> volcano-tpu.io/
ib-fabric).  The split counts each side's device (google.com/tpu ->
nvidia.com/gpu).  Tolerance: exact.
"""

import itertools

import pytest

from test_torch_schedule_parity import PORT, REF
from volcano_tpu.controllers import hyperjob as rhj
from volcano_tpu_torch.controllers import hyperjob as thj

LABELS = {"volcano-tpu.io/dcn-pod": "volcano-tpu.io/ib-fabric"}
DOMAINS = [("sa", (4, 4), "pod-a"), ("sb", (4, 4), "pod-b")]


def _cluster(side):
    side.pod._uid_counter = itertools.count(1)
    cluster = side.FakeCluster()
    for name, shape, group in DOMAINS:
        for node in side.nodes(name, shape, group):
            cluster.add_node(node)
    hnc = side.HNC()
    hnc.initialize(cluster)
    hnc.sync()
    return cluster


def _hyperjob(side, hj, mode, pods, accelerators=0):
    tmpl = side.VCJob(name="tmpl", min_available=pods, tasks=[
        side.TaskSpec(name="worker", replicas=pods, template=side.pod.Pod(
            name="t", containers=[side.pod.Container(
                requests={"cpu": 8, side.device: 4})]))])
    return hj.HyperJob(name="big", min_available=2, replicated_jobs=[
        hj.ReplicatedJob(name="train", replicas=1, template=tmpl,
                         split_policy=hj.SplitPolicy(
                             mode=mode, accelerators=accelerators))])


def _members(cluster, hj):
    out = {}
    for key, job in sorted(cluster.vcjobs.items()):
        terms = [[{LABELS.get(k, k): v for k, v in term.items()}
                  for term in spec.template_pod().affinity_node_terms]
                 for spec in job.tasks]
        out[key] = dict(
            replicas=[t.replicas for t in job.tasks],
            min_available=job.min_available,
            domain=job.annotations.get(hj.FORWARD_DOMAIN_ANNOTATION),
            pod_domains=[t.template_pod().annotations.get(
                hj.FORWARD_DOMAIN_ANNOTATION) for t in job.tasks],
            terms=terms,
            topology=None if job.network_topology is None else
            (job.network_topology.mode.value,
             job.network_topology.highest_tier_allowed))
    return out


def _split(side, hj, mode, pods, accelerators=0, occupied=()):
    cluster = _cluster(side)
    for i, node in enumerate(occupied):
        cluster.add_pod(side.pod.make_pod(
            f"occ-{i}", requests={side.device: 4}, node_name=node,
            phase=side.pod.TaskStatus.RUNNING))
    cluster.put_object("hyperjob", _hyperjob(side, hj, mode, pods,
                                             accelerators))
    ctrl = hj.HyperJobController()
    ctrl.initialize(cluster)
    ctrl.sync()
    first = _members(cluster, hj)
    ctrl.sync()     # a resync is idempotent: no member churn
    assert _members(cluster, hj) == first
    return first, cluster.hyperjobs["default/big"].split_count


def test_static_split_over_two_fabrics():
    ref = _split(REF, rhj, "static", 8, accelerators=16)
    port = _split(PORT, thj, "static", 8, accelerators=16)
    assert port == ref
    members, count = port
    assert count == 2
    assert sorted(members) == ["default/big-train-0-s0",
                               "default/big-train-0-s1"]
    assert {m["domain"] for m in members.values()} == {"pod-a", "pod-b"}
    for m in members.values():
        assert m["replicas"] == [4] and m["min_available"] == 4
        assert m["pod_domains"] == [m["domain"]]
        assert m["terms"] == [[{"volcano-tpu.io/ib-fabric": [m["domain"]]}]]


def test_auto_split_follows_free_gpus():
    """Half of fabric pod-a occupied: a 24-device replica splits 16 on
    pod-b and 8 on pod-a on both sides."""
    ref = _split(REF, rhj, "auto", 6, occupied=("sa-w0", "sa-w1"))
    port = _split(PORT, thj, "auto", 6, occupied=("sa-w0", "sa-w1"))
    assert port == ref
    members = {m["domain"]: m["replicas"][0] for m in port[0].values()}
    assert members == {"pod-b": 4, "pod-a": 2}


@pytest.mark.parametrize("side, hj", [(REF, rhj), (PORT, thj)],
                         ids=["reference", "port"])
def test_split_members_schedule_into_their_fabrics(side, hj):
    cluster = _cluster(side)
    cluster.put_object("hyperjob", _hyperjob(side, hj, "static", 8, 16))
    mgr = side.Manager(cluster, enabled=["hyperjob", "job", "podgroup",
                                         "queue"])
    sched = side.Scheduler(cluster)
    for _ in range(4):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    mgr.stop()
    placements = {}
    for pod in cluster.pods.values():
        if pod.node_name and "big-train" in pod.name:
            member = pod.name.rsplit("-worker-", 1)[0]
            placements.setdefault(member, set()).add(
                pod.node_name.rsplit("-w", 1)[0])
    assert placements == {"big-train-0-s0": {"sa"}, "big-train-0-s1": {"sb"}} \
        or placements == {"big-train-0-s0": {"sb"}, "big-train-0-s1": {"sa"}}
    for member in placements:
        assert hj.FORWARD_DOMAIN_ANNOTATION in \
            cluster.podgroups[f"default/{member}"].annotations

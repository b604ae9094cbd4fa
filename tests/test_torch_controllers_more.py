"""The elastic, failover, jobflow, serving, colocation and
garbagecollector controllers of the port against the reference's, and
a failed rank resumed from its checkpoint on gloo.

Each scenario drives both packages' controller managers (and, where
the scenario schedules, their schedulers) on mirrored clusters: two
TPU v5e-16 slices mirror two 4 x 4 NVLink domains in one fabric, node
names equal, `jax` jobs mirror `torch` jobs.  `time.time` and the
controllers' clocks read one fake clock that a cycle advances.  After every cycle the jobs' and podgroups' phases and
annotations, the pods' nodes, phases and env, the nodes' annotations,
the evictions and the events (device words mapped) must be equal; the
reference test's own assertions then hold on both sides.  Tolerance:
exact.

The last test runs the failover path end to end on the CPU: a 2-rank
gloo job of the port's worker saves a DCP checkpoint, one rank is
killed, the failover controller drains the job and stamps the resume
step, and the restarted ranks resume from that step.  Their losses
after the resume equal an uninterrupted run's within 1e-5 relative.
"""

import contextlib
import itertools
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from test_torch_preempt_parity import PORT, REF, _domains, _norm

FAILOVER_CONF = {
    "actions": "enqueue, allocate, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"},
                     {"name": "deviceshare"},
                     {"name": "network-topology-aware"}]},
    ],
}
ELASTIC_CONF = {
    "actions": "enqueue, allocate, elastic, gangpreempt, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "elastic"},
                     {"name": "conformance"}]},
        FAILOVER_CONF["tiers"][1],
    ],
    "configurations": {"elastic": {"elastic.cooldownSeconds": 0}},
}


def _plugin(s):
    return "jax" if s is REF else "torch"


# the fake clock: `time.time` for the whole scenario (the flight
# recorder's stamps and the elastic action's decisions read it) and the
# controllers' `now`
CLOCK = {"t": 1000.0}


@pytest.fixture(autouse=True)
def fake_time(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK["t"])


def _clock():
    CLOCK["t"] = 1000.0
    return CLOCK


class ControlPlane:
    """One side's mirrored cluster, controllers (on a shared fake clock)
    and, with a conf, its scheduler."""

    def __init__(self, s, controllers, conf=None, domains=("sa", "sb")):
        s.pod._uid_counter = itertools.count(1)
        self.s = s
        self.cluster = _domains(s, domains)
        self.cluster.admission = s.m("webhooks.admission").default_admission()
        self.clock = _clock()
        self.mgr = s.m("controllers").ControllerManager(
            self.cluster, enabled=controllers)
        for ctrl in self.mgr.controllers:
            if hasattr(ctrl, "now"):
                ctrl.now = lambda: self.clock["t"]
        self.sched = None if conf is None else s.m("scheduler").Scheduler(
            self.cluster, conf=conf, schedule_period=0)

    def controller(self, name):
        return next(c for c in self.mgr.controllers if c.name == name)

    def cycle(self, n=1):
        snaps = []
        for _ in range(n):
            self.mgr.sync_all()
            if self.sched is not None:
                self.sched.run_once()
            self.cluster.tick()
            self.clock["t"] += 1.0
            snaps.append(snapshot(self.cluster))
        return snaps


def snapshot(c):
    return {
        "jobs": {k: (j.phase.value, dict(j.annotations), j.retry_count,
                     [(t.name, t.replicas) for t in j.tasks])
                 for k, j in sorted(c.vcjobs.items())},
        "podgroups": {k: (g.phase.value, g.min_member, dict(g.annotations))
                      for k, g in sorted(c.podgroups.items())},
        "pods": {k: (p.node_name, p.phase.value,
                     dict(p.containers[0].env) if p.containers else {})
                 for k, p in sorted(c.pods.items())},
        "nodes": {k: (n.unschedulable, dict(n.annotations))
                  for k, n in sorted(c.nodes.items())},
        "evictions": list(c.evictions),
        "events": [(k, r, _norm(m)) for k, r, m in c.events]}


def gang_job(s, name="train", replicas=4, annotations=None, devices=4,
             hard=True, run_ticks=None):
    types_ = s.m("api.types")
    pod_ann = {} if run_ticks is None else \
        {types_.RUN_TICKS_ANNOTATION: str(run_ticks)}
    vc = s.m("api.vcjob")
    return vc.VCJob(
        name=name, min_available=replicas,
        annotations=dict(annotations or {}),
        network_topology=s.Topo(s.HARD, 1) if hard else None,
        plugins={_plugin(s): []},
        tasks=[vc.TaskSpec(name="worker", replicas=replicas,
                           template=s.pod.make_pod(
                               "t", requests={"cpu": 8, s.device: devices},
                               annotations=pod_ann))])


def _gang_nodes(c, key):
    uid = c.vcjobs[key].uid
    return sorted(p.node_name for p in c.pods.values()
                  if p.owner == uid and p.node_name)


# -- scenarios: side -> (plane, [snapshot after each cycle]) --------------


def failover(s):
    sh = s.m("api.slicehealth")
    sim = s.m("simulator")
    p = ControlPlane(s, ["job", "podgroup", "queue", "failover"],
                     FAILOVER_CONF)
    p.cluster.add_vcjob(gang_job(s, annotations={
        sh.CHECKPOINT_DIR_ANNOTATION: "/ckpt/train",
        sh.LAST_STEP_ANNOTATION: "42"}))
    snaps = p.cycle(4)
    victim = _gang_nodes(p.cluster, "default/train")[0]
    sim.fail_host(p.cluster, victim)
    snaps += p.cycle(12)
    sim.heal_host(p.cluster, victim)
    p.clock["t"] += 400.0          # past the quarantine TTL
    snaps += p.cycle(3)
    return p, snaps


def check_failover(s, p):
    sh = s.m("api.slicehealth")
    c = p.cluster
    job = c.vcjobs["default/train"]
    assert job.phase.value == "Running"
    assert job.annotations[sh.FAILOVER_GENERATION_ANNOTATION] == "1"
    assert job.annotations[sh.RESUME_STEP_ANNOTATION] == "42"
    pg = c.podgroups["default/train"]
    assert pg.annotations[sh.CHECKPOINT_DIR_ANNOTATION] == "/ckpt/train"
    assert sh.REQUEUED_ANNOTATION not in pg.annotations
    domains = {n.split("-w")[0] for n in _gang_nodes(c, "default/train")}
    assert domains == {"sb"}
    reasons = [r for _, r, _ in c.events]
    for want in ("SliceFailed", "FailoverDrain", "FailoverComplete",
                 "SliceRecovered"):
        assert want in reasons, want
    pod = next(q for q in c.pods.values() if q.owner == job.uid)
    assert pod.containers[0].env["VTP_RESUME_STEP"] == "42"
    assert pod.containers[0].env["VTP_CHECKPOINT_DIR"] == "/ckpt/train"


def elastic(s):
    eapi = s.m("api.elastic")
    p = ControlPlane(s, ["job", "podgroup", "queue", "failover", "elastic"],
                     ELASTIC_CONF)
    job = gang_job(s, name="etrain", hard=False, annotations={
        eapi.ELASTIC_MIN_SLICES_ANNOTATION: "1",
        eapi.ELASTIC_MAX_SLICES_ANNOTATION: "2",
        eapi.ELASTIC_SLICES_ANNOTATION: "1"})
    p.cluster.add_vcjob(job)
    snaps = p.cycle(12)
    # new demand: a fixed gang of one domain makes the elastic gang
    # shrink back to its floor
    p.cluster.add_vcjob(gang_job(s, name="fixed", hard=False))
    snaps += p.cycle(14)
    return p, snaps


def check_elastic(s, p):
    eapi = s.m("api.elastic")
    c = p.cluster
    pg = c.podgroups["default/etrain"]
    kinds = [h["kind"] for h in eapi.resize_history(pg)]
    assert kinds[:2] == ["grow", "shrink"], kinds
    assert c.vcjobs["default/fixed"].phase.value == "Running"
    assert len(_gang_nodes(c, "default/etrain")) == 4


def serving(s):
    sapi, eapi = s.m("api.serving"), s.m("api.elastic")
    pg_cls = s.m("api.podgroup").PodGroup
    c = _domains(s, ("sa",))
    clock = _clock()

    def pg_with(qps, updated):
        ann = {
            sapi.SLO_P99_MS_ANNOTATION: "50.0",
            sapi.MIN_REPLICAS_ANNOTATION: "1",
            sapi.MAX_REPLICAS_ANNOTATION: "4",
            sapi.TARGET_QPS_ANNOTATION: "100.0",
            eapi.ELASTIC_MIN_SLICES_ANNOTATION: "1",
            eapi.ELASTIC_MAX_SLICES_ANNOTATION: "4",
            eapi.ELASTIC_SLICES_ANNOTATION: "1",
            sapi.PG_QPS_ANNOTATION: f"{qps:.3f}",
            sapi.PG_P99_MS_ANNOTATION: "20.000",
            sapi.PG_EPOCH_ANNOTATION: "0",
            sapi.PG_UPDATED_TS_ANNOTATION: f"{updated:.3f}"}
        return ann

    c.add_podgroup(pg_cls(name="infer", namespace="default",
                          annotations=pg_with(350.0, clock["t"])))
    ctrl = s.m("controllers.serving").ServingController(
        now=lambda: clock["t"])
    ctrl.initialize(c)
    snaps = []
    # a burst (scale up), then traffic sags under fresh signals
    for step, qps in enumerate([350.0, 350.0, 20.0, 20.0, 20.0, 20.0,
                                20.0, 20.0]):
        pg = c.podgroups["default/infer"]
        pg.annotations.update({k: v for k, v in pg_with(
            qps, clock["t"]).items() if k.startswith("serving.")})
        if step == 2:
            # the scale-up was executed: the group now runs 4 replicas
            pg.annotations[eapi.ELASTIC_SLICES_ANNOTATION] = "4"
            pg.annotations.pop(eapi.ELASTIC_DESIRED_SLICES_ANNOTATION,
                               None)
        ctrl.sync()
        clock["t"] += 20.0
        snaps.append(snapshot(c))
    return types_ns(cluster=c), snaps


def types_ns(**kw):
    import types
    return types.SimpleNamespace(**kw)


def check_serving(s, p):
    assert [m.split(" ")[:2] for _, r, m in p.cluster.events
            if r == "ServingScale"] == [["scale-up", "1->4"],
                                        ["scale-down", "4->1"]]


def jobflow(s):
    jf = s.m("api.jobflow")
    vc = s.m("api.vcjob")
    p = ControlPlane(s, ["job", "jobflow", "jobtemplate"], conf={
        "actions": "enqueue, allocate, backfill", "tiers": [
            {"plugins": [{"name": "priority"}, {"name": "gang"}]},
            {"plugins": [{"name": "predicates"}, {"name": "nodeorder"}]}]},
        domains=("sa",))

    def template(name):
        return jf.JobTemplate(name=name, job=vc.VCJob(
            name=name, min_available=1,
            tasks=[vc.TaskSpec(name="w", replicas=1,
                               template=s.pod.Pod(name="t", containers=[
                                   s.pod.Container(requests={"cpu": 1})]))]))

    c = p.cluster
    c.jobtemplates = {f"default/{n}": template(n)
                      for n in ("prep", "train", "eval")}
    flow = jf.JobFlow(name="pipeline", flows=[
        jf.Flow(name="prep"),
        jf.Flow(name="train", depends_on=jf.FlowDependsOn(targets=["prep"])),
        jf.Flow(name="eval", depends_on=jf.FlowDependsOn(targets=["train"]))])
    c.jobflows = {flow.key: flow}
    snaps = []
    for step in ("prep", "train", "eval", None):
        snaps += p.cycle(3)
        snaps[-1]["flows"] = {k: (f.phase.value, list(f.deployed_jobs))
                              for k, f in c.jobflows.items()}
        snaps[-1]["templates"] = {k: list(t.job_depends_on_list)
                                  for k, t in c.jobtemplates.items()}
        if step:
            for pod in list(c.pods.values()):
                if pod.name.startswith(f"pipeline-{step}") and \
                        not pod.is_terminated():
                    c.complete_pod(pod.key)
    return p, snaps


def check_jobflow(s, p):
    phase = p.cluster.jobflows["default/pipeline"].phase
    assert phase is s.m("api.jobflow").JobFlowPhase.SUCCEED


def colocation(s):
    c = _domains(s, ("sa",))
    agents = [s.m("agent").NodeAgent(c, f"sa-w{i}") for i in range(2)]
    ctrl = s.m("controllers.colocation").ColocationConfigController()
    ctrl.initialize(c)
    for a in agents:
        ctrl.register_agent(a)
    snaps = []
    for cfg in ({"oversub-factor": "0.9", "eviction-threshold": "0.8"},
                {"oversub-factor": "bad", "eviction-threshold": "0.5"},
                {"eviction-threshold": "0.7"}):
        c.config_maps["colocation/config"] = cfg
        ctrl.sync()
        snaps.append({"agents": [(a.oversub_factor, a.eviction_threshold)
                                 for a in agents]})
    return types_ns(cluster=c, agents=agents), snaps


def check_colocation(s, p):
    assert [(a.oversub_factor, a.eviction_threshold)
            for a in p.agents] == [(0.9, 0.7)] * 2


def garbagecollector(s):
    vc = s.m("api.vcjob")
    p = ControlPlane(s, ["job", "garbagecollector"], conf={
        "actions": "enqueue, allocate, backfill", "tiers": [
            {"plugins": [{"name": "priority"}, {"name": "gang"}]},
            {"plugins": [{"name": "predicates"}, {"name": "nodeorder"}]}]},
        domains=("sa",))
    for name, ttl in (("short", 0), ("kept", None), ("long", 10 ** 6)):
        p.cluster.add_vcjob(vc.VCJob(
            name=name, min_available=1, ttl_seconds_after_finished=ttl,
            tasks=[vc.TaskSpec(name="w", replicas=1, template=s.pod.Pod(
                name="t", containers=[s.pod.Container(
                    requests={"cpu": 1})]))]))
    snaps = p.cycle(3)
    for pod in list(p.cluster.pods.values()):
        p.cluster.complete_pod(pod.key)
    snaps += p.cycle(4)
    return p, snaps


def check_garbagecollector(s, p):
    assert sorted(p.cluster.vcjobs) == ["default/kept", "default/long"]
    assert not any(k.startswith("default/short") for k in p.cluster.pods)


SCENARIOS = {
    "failover": (failover, check_failover),
    "elastic": (elastic, check_elastic),
    "serving": (serving, check_serving),
    "jobflow": (jobflow, check_jobflow),
    "colocation": (colocation, check_colocation),
    "garbagecollector": (garbagecollector, check_garbagecollector),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_matches_reference(name):
    run, check = SCENARIOS[name]
    ref, want = run(REF)
    port, got = run(PORT)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"cycle {i} differs"
    check(REF, ref)
    check(PORT, port)


# -- failover end to end on gloo ----------------------------------------

RANK_TRAIN = r"""
import json, os, sys, time
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, checkpoint, train, worker
from volcano_tpu_torch.workloads import mesh as mesh_lib
total, save_every, block_at, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
info = bootstrap.initialize(device="cpu", timeout=60)
n = dist.get_world_size()
mesh = mesh_lib.make_mesh({"dp": n, "fsdp": 1}, "cpu")
cfg, opt = worker.worker_config(), train.make_optimizer()
params, state, _ = train.init_sharded(torch.Generator().manual_seed(0), cfg,
                                      mesh, opt)
params, state, start = checkpoint.resume_state(params, state)
batch = train.synthetic_batch(torch.Generator().manual_seed(1), cfg, n,
                              worker.SEQ_LEN, mesh)
step_fn = train.make_train_step(cfg, opt, mesh)
losses = {}
for s in range(start + 1, total + 1):
    if s == block_at:
        time.sleep(600)            # the failure lands here
    params, state, m = step_fn(params, state, batch)
    losses[s] = float(m["loss"])
    if save_every and s % save_every == 0:
        checkpoint.save(info.checkpoint_dir, step=s, params=params,
                        opt_state=state)
    if dist.get_rank() == 0:
        with open(out + ".tmp", "w") as f:
            json.dump({"start": start, "losses": losses}, f)
        os.replace(out + ".tmp", out)
bootstrap.shutdown()
"""

RTOL_RESUME = 1e-5
REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_procs(envs, argv, log):
    return [subprocess.Popen([sys.executable, "-c", RANK_TRAIN, *map(str, argv)],
                             env=env, cwd=REPO_DIR, stdout=log, stderr=log)
            for env in envs]


def _read(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pods_env(plane, key, port, **extra):
    """The job's pods' env by rank, as a worker process gets it here
    (`test_torch_worker.pod_env`: the coordinator on this host, the CPU)."""
    from test_torch_worker import pod_env
    c = plane.cluster
    uid = c.vcjobs[key].uid
    pods = sorted((p for p in c.pods.values()
                   if p.owner == uid and p.node_name),
                  key=lambda p: int(p.containers[0].env["TPU_WORKER_ID"]))
    return pods, [dict(pod_env(p, port), **extra) for p in pods]


def test_failover_resumes_a_killed_gloo_job_at_the_stamped_step(tmp_path):
    """A 2-rank job (one rank a host of a 4 x 4 NVLink domain) trains the
    worker's model on gloo and saves a DCP checkpoint every 2 steps.
    One rank is killed before step 5 and its host reported Failed; the
    failover controller drains the job with one restart, stamps the last
    checkpoint step (4) and quarantines the domain; the job rebinds in
    the other domain.  Its ranks resume from the checkpoint at step 4
    (the port's worker too, `start_step` 4), and their losses for steps
    5 and 6 equal an uninterrupted run's within 1e-5 relative."""
    from test_torch_worker import rank_env
    from torch_procs import rendezvous
    sh = PORT.m("api.slicehealth")
    sim = PORT.m("simulator")
    ckpt = str(tmp_path / "ckpt")
    p = ControlPlane(PORT, ["job", "podgroup", "queue", "failover"],
                     FAILOVER_CONF)
    p.cluster.add_vcjob(gang_job(PORT, replicas=2, annotations={
        sh.CHECKPOINT_DIR_ANNOTATION: ckpt}))
    p.cycle(4)
    assert p.cluster.vcjobs["default/train"].phase.value == "Running"
    # each group of ranks meets at a store of its own, held to the end
    stores = contextlib.ExitStack()
    pods, envs = _pods_env(p, "default/train",
                           stores.enter_context(rendezvous()))
    assert envs[0]["VTP_CHECKPOINT_DIR"] == ckpt
    log = open(tmp_path / "ranks.log", "w")
    port = stores.enter_context(rendezvous())
    straight = _rank_procs([rank_env(r, 2, port) for r in range(2)],
                           (6, 0, 0, tmp_path / "straight.json"), log)
    first = _rank_procs(envs, (6, 2, 5, tmp_path / "first.json"), log)
    procs = straight + first
    try:
        wait_for(lambda: len((_read(tmp_path / "first.json") or
                              {"losses": {}})["losses"]) == 4, 120,
                 "the first run's step 4 and its checkpoint")
        # the supervisor publishes the last durable step; rank 1 dies
        # and the node agent reports its host Failed
        pg = p.cluster.podgroups["default/train"]
        pg.annotations[sh.LAST_STEP_ANNOTATION] = "4"
        first[1].send_signal(signal.SIGKILL)
        sim.fail_host(p.cluster, pods[1].node_name)
        failed_domain = pods[1].node_name.split("-w")[0]
        p.cycle(12)
        first[0].kill()               # its pod was deleted by the drain
        job = p.cluster.vcjobs["default/train"]
        assert job.phase.value == "Running"
        assert job.annotations[sh.RESUME_STEP_ANNOTATION] == "4"
        assert job.annotations[sh.FAILOVER_GENERATION_ANNOTATION] == "1"
        reasons = [r for _, r, _ in p.cluster.events]
        assert reasons.count("FailoverDrain") == 1
        pods2, envs2 = _pods_env(p, "default/train",
                                 stores.enter_context(rendezvous()))
        assert {q.node_name.split("-w")[0] for q in pods2} == \
            {"sb" if failed_domain == "sa" else "sa"}
        assert all(e["VTP_RESUME_STEP"] == "4" for e in envs2)
        resumed = _rank_procs(envs2, (6, 0, 0, tmp_path / "resumed.json"),
                              log)
        _, envs3 = _pods_env(p, "default/train",
                             stores.enter_context(rendezvous()))
        worker = [subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.workloads.worker"],
            env=e, cwd=REPO_DIR, text=True, stdout=subprocess.PIPE,
            stderr=log) for e in envs3]
        procs += resumed + worker
        for q in straight + resumed:
            assert q.wait(timeout=150) == 0
        lines = [q.communicate(timeout=150)[0] for q in worker]
        assert [q.returncode for q in worker] == [0, 0]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        log.close()
        stores.close()
    want = _read(tmp_path / "straight.json")
    got = _read(tmp_path / "resumed.json")
    assert got["start"] == 4 and sorted(got["losses"]) == ["5", "6"]
    for s in ("5", "6"):
        assert got["losses"][s] == pytest.approx(want["losses"][s],
                                                 rel=RTOL_RESUME)
    # the trajectory resumed, not restarted: step 5 is not step 1
    assert got["losses"]["5"] != pytest.approx(want["losses"]["1"],
                                               rel=RTOL_RESUME)
    out = json.loads(lines[0].strip().splitlines()[-1])
    assert out["start_step"] == 4
    assert out["loss"] == round(want["losses"]["6"], 4)


def wait_for(cond, timeout, msg):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_bench_failover_smoke_mode():
    """`python -m volcano_tpu_torch.bench --failover-smoke` kills one
    fake host and asserts the gang re-reaches Running with a bumped
    failover generation inside the cycle budget."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--failover-smoke", 180))
    assert out["ok"] is True, out
    assert out["mttr_p50_s"] > 0
    assert out["breakdown_p50_s"]["detect"] >= 0
    assert out["cycles_to_recover"] and \
        all(c <= 40 for c in out["cycles_to_recover"])


def test_bench_elastic_smoke_mode():
    """`python -m volcano_tpu_torch.bench --elastic-smoke` runs one grow
    and one shrink through the REAL process control plane (state
    server + scheduler + controllers as OS processes)."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--elastic-smoke", 300))
    assert out["ok"] is True, out
    assert out["grow_ok"] and out["shrink_ok"]
    assert out["utilization"] > 0

"""Benchmark harness — prints ONE JSON line.

Headline metric: p50 gang-allocate latency for a 256-host vcjob onto a
simulated NVLink domain of HGX H100 hosts (target < 2s), plus GPU
utilization under 2-queue contention (target >= 0.95) in the same
line.  vs_baseline = target_latency / measured_p50 (>1 beats target).

Mirrors the reference's benchmark/ KWOK harness: fake GPU hosts,
real scheduler, wall-clock latency of the full scheduling cycle
(snapshot -> enqueue -> allocate -> bind flush).  The device rows
come from children on the card (`--probe-child`, `--flash-child`,
`--train-child`), timed with CUDA events.

    python -m volcano_tpu_torch.bench [--<mode>]
"""

from __future__ import annotations

import json
import random
import re
import statistics
import time
from typing import Optional, Tuple

from volcano_tpu_torch.api import elastic as eapi


BENCH_CONF = {
    "actions": "enqueue, allocate, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"},
                     {"name": "deviceshare"},
                     {"name": "network-topology-aware"}]},
    ],
}

TARGET_P50_S = 2.0
TRIALS = 12

# Published peaks of the card (NVIDIA data sheets, dense): (bf16 FLOP/s,
# bytes/s) -- the MFU denominator of the device children and of
# chip_smoke.py's bounds
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


def peaks(name: str):
    """(key, (bf16 FLOP/s, bytes/s)) of the card named `name`."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


# The reference's TPU slices are NVLink domains here, named
# "<generation>-<hosts>x<GPUs a host>": a slice of H hosts is a domain
# of H HGX hosts of 8 GPUs, so a pod that took a TPU host's 4 chips
# takes its 8 GPUs and every chip count doubles.  h200 stands in for
# the reference's second generation (v5p) where a scenario needs two.
PRODUCTS = {"h100": "NVIDIA-H100-80GB-HBM3", "h200": "NVIDIA-H200-141GB-HBM3e"}


def domain_for(name: str, kind: str):
    from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
    gen, shape = kind.split("-")
    hosts, gpus = (int(x) for x in shape.split("x"))
    return DomainTopology(name, PRODUCTS[gen], hosts, gpus)


def make_domain_cluster(domains, ib_fabrics=None):
    """simulator.make_gpu_cluster over `domain_for`'s kinds: one node
    pool a domain, each in its IB fabric (default "ib-0")."""
    from volcano_tpu_torch.simulator import domain_nodes, make_gpu_cluster
    nodes = [node for name, kind in domains
             for node in domain_nodes(domain_for(name, kind),
                                      ib_fabric=(ib_fabrics or {}).get(
                                          name, "ib-0"))]
    return make_gpu_cluster([], extra_nodes=nodes)


def bench_gang_allocate_latency() -> float:
    """p50 wall-clock of one full cycle placing a 256-host gang onto an
    NVLink domain of 256 HGX H100 hosts (2048 GPUs) amid competing
    domains."""
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import NetworkTopologyMode
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    latencies = []
    for trial in range(TRIALS):
        cluster = make_domain_cluster([
            ("target", "h100-256x8"),     # 256 hosts
            ("noise-a", "h100-64x8"),     # 64 hosts
            ("noise-b", "h100-16x8"),      # 16 hosts
        ])
        pg, pods = gang_job(
            f"train-{trial}", replicas=256, requests={"cpu": 8, GPU: 8},
            network_topology=NetworkTopologySpec(
                NetworkTopologyMode.HARD, 1))
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        sched = Scheduler(cluster, conf=BENCH_CONF, schedule_period=0)
        t0 = time.perf_counter()
        sched.run_once()
        dt = time.perf_counter() - t0
        assert len(cluster.binds) == 256, \
            f"gang did not fully place: {len(cluster.binds)}/256"
        latencies.append(dt)
    return statistics.median(latencies)


def bench_utilization_under_contention() -> float:
    """Fragmented-slice contention.

    Two 16-host NVLink domains (whole-host atomic) + a bank of 8
    single-host domains (sub-host packable): dev floods BOTH —
    1-host whole jobs scattered across the big domains, 2-4 GPU packs
    fragmenting the bank — then prod (weight 3) submits slice-LOCAL
    4-host gangs (hard tier-1), so reclaim must free four hosts in
    the SAME slice, not just anywhere; dev churn (random completions
    + replacement arrivals every other cycle) keeps flipping the
    picture.  Reported number = MEAN GPU utilization sampled at
    every cycle of the churn window — reclaim evictions, topology-
    blocked gangs and bank fragmentation all show up as sub-1.0
    headroom (target >= 0.95)."""
    import random as _random

    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.queue import Queue
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import NetworkTopologyMode, TaskStatus
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    rng = _random.Random(7)
    cluster = make_domain_cluster(
        [("sa", "h100-16x8"), ("sb", "h100-16x8")] +
        [(f"bank{i}", "h100-1x8") for i in range(8)])
    total_chips = 2 * 128 + 8 * 8      # 320 GPUs
    cluster.add_queue(Queue(name="prod", weight=3))
    cluster.add_queue(Queue(name="dev", weight=1, reclaimable=True))

    conf = {
        # gangreclaim owns hard-topology jobs (plain reclaim skips
        # them): freeing four hosts in ONE slice is its job
        "actions": "enqueue, allocate, preempt, reclaim, "
                   "gangreclaim, backfill",
        "tiers": BENCH_CONF["tiers"],
    }
    sched = Scheduler(cluster, conf=conf, schedule_period=0)

    dev_seq = 0

    def submit_dev(hosts_jobs, packs):
        nonlocal dev_seq
        for _ in range(hosts_jobs):    # whole-host single jobs
            pg, pods = gang_job(f"dev-{dev_seq}", queue="dev",
                                replicas=1,
                                requests={"cpu": 8, GPU: 8})
            dev_seq += 1
            cluster.add_podgroup(pg)
            for p in pods:
                cluster.add_pod(p)
        for _ in range(packs):         # sub-host packs (bank only)
            pg, pods = gang_job(f"dev-{dev_seq}", queue="dev",
                                replicas=1,
                                requests={"cpu": 2,
                                          GPU: rng.choice((2, 2, 4))})
            dev_seq += 1
            cluster.add_podgroup(pg)
            for p in pods:
                cluster.add_pod(p)

    def running_dev():
        return [p for p in cluster.pods.values()
                if p.name.startswith("dev-")
                and p.phase is TaskStatus.RUNNING]

    def utilization():
        used = sum(p.resource_requests().get(GPU)
                   for p in cluster.pods.values()
                   if p.node_name and p.phase in (TaskStatus.RUNNING,
                                                  TaskStatus.BOUND))
        return used / total_chips

    # phase 1: dev saturates — 28 whole hosts scattered over the big
    # slices + 16 sub-host packs fragmenting the bank
    submit_dev(28, 16)
    for _ in range(3):
        sched.run_once()
        cluster.tick()

    # phase 2: prod domain-local gangs demand 192 of the 256 big-domain
    # GPUs; freeing four hosts in ONE slice forces targeted reclaim
    for i in range(6):
        pg, pods = gang_job(
            f"prod-j{i}", queue="prod", replicas=4,
            requests={"cpu": 8, GPU: 8},
            network_topology=NetworkTopologySpec(
                NetworkTopologyMode.HARD, 1))
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)

    samples = []
    for cycle in range(14):
        if cycle % 2 == 1:
            # churn: ~20% of running dev work finishes; replacements
            # arrive (half whole-host, half packs)
            done = [p for p in running_dev() if rng.random() < 0.2]
            for p in done:
                cluster.complete_pod(p.key)
            submit_dev(len(done) // 2, len(done) - len(done) // 2)
        sched.run_once()
        cluster.tick()
        samples.append(utilization())
    return sum(samples) / len(samples)


# -- wire-path benchmarks ---------------------------------------------
#
# The reference derives its entire latency methodology from apiserver
# audit logs (third_party/kube-apiserver-audit-exporter/exporter/
# metrics.go:32-38); every headline number above is an in-process
# function call that never pays admission, serialization or watch
# fan-out.  These scenarios boot the REAL control plane — state-server
# process, leader-elected scheduler process, controller-manager
# process — submit work through the wire client, and report latency
# derived from the server's audit trail (server/audit_exporter.py),
# i.e. measured OUTSIDE the scheduler at the product's own wire
# boundary.

class _WirePlane:
    """Boots and reaps the control-plane OS processes (the bench-side
    analogue of tests/test_multiprocess_e2e.Plane)."""

    def __init__(self):
        import os
        import socket
        import tempfile
        self.repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.logdir = tempfile.mkdtemp(prefix="wire-bench-")
        self.procs = {}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.url = f"http://127.0.0.1:{self.port}"

    def spawn(self, name, *argv):
        import os
        import subprocess
        import sys
        logf = open(os.path.join(self.logdir, f"{name}.log"), "w")
        env = dict(os.environ, PYTHONPATH=self.repo)
        self.procs[name] = subprocess.Popen(
            [sys.executable, *argv], stdout=logf, stderr=logf,
            env=env, cwd=self.repo)

    def start(self, tick=0.05, period=0.05):
        import urllib.request
        self.spawn("server", "-m", "volcano_tpu_torch.server",
                   "--port", str(self.port),
                   "--tick-period", str(tick))

        def up():
            try:
                with urllib.request.urlopen(self.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        self.spawn("controllers", "-m", "volcano_tpu_torch",
                   "--cluster-url", self.url,
                   "--components", "controllers",
                   "--period", str(period))
        self.spawn("scheduler", "-m", "volcano_tpu_torch",
                   "--cluster-url", self.url,
                   "--components", "scheduler", "--period", str(period),
                   "--leader-elect", "--holder", "bench-sched",
                   "--lease-ttl", "2.0")

    def log_tails(self, n=1500) -> str:
        import glob
        import os
        out = []
        for f in sorted(glob.glob(os.path.join(self.logdir, "*.log"))):
            try:
                with open(f, encoding="utf-8", errors="replace") as fh:
                    out.append(f"== {os.path.basename(f)} ==\n"
                               + fh.read()[-n:])
            except OSError as e:
                out.append(f"== {os.path.basename(f)} unreadable: {e} ==")
        return "\n".join(out)

    def shutdown(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                proc.kill()


def _wire_wait(cond, timeout, msg):
    """msg may be a callable: evaluated ONLY on timeout, so log tails
    in the diagnostic are captured at failure time (not when the wait
    starts) and successful waits never pay the log read."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.03)
    raise AssertionError("wire bench: timed out waiting for "
                         + (msg() if callable(msg) else msg))


def _wire_gang_job(name, replicas, run_ticks=2):
    """Hard tier-1 (NVLink-domain-local) GPU gang, finite workload — the
    topology-gang shape the in-process headline uses, submitted as a
    vcjob so controllers materialize it over the wire."""
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import (NetworkTopologyMode,
                                       RUN_TICKS_ANNOTATION)
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    return VCJob(
        name=name, min_available=replicas,
        network_topology=NetworkTopologySpec(
            NetworkTopologyMode.HARD, highest_tier_allowed=1),
        tasks=[TaskSpec(
            name="w", replicas=replicas,
            template=make_pod(
                "t", requests={"cpu": 8, GPU: 8},
                annotations={RUN_TICKS_ANNOTATION: str(run_ticks)}))])


def _job_running(cluster, job_name, want):
    from volcano_tpu_torch.api.types import TaskStatus
    return sum(1 for p in cluster.pods.values()
               if p.labels.get("volcano-tpu.io/job-name") == job_name
               and p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING,
                               TaskStatus.SUCCEEDED)) >= want


def _job_completed(cluster, job_name):
    from volcano_tpu_torch.api.types import JobPhase
    j = cluster.vcjobs.get(f"default/{job_name}")
    return j is not None and j.phase is JobPhase.COMPLETED


def bench_wire_gang(smoke: bool = False) -> dict:
    """wire_gang_p50_s: p50 pod scheduling latency of topology gangs
    scheduled through the REAL multi-process control plane, derived
    from the server's audit trail (creation->bind timestamps, the
    reference's pods/binding methodology) — no scheduler cooperation.
    Also reports the client-observed submit->all-bound wall time."""
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.server.audit_exporter import AuditExporter
    from volcano_tpu_torch.simulator import domain_nodes

    slices = [("target", "h100-4x8")] if smoke else \
        [("target", "h100-16x8"), ("noise", "h100-4x8")]
    replicas = 4 if smoke else 16
    trials = 1 if smoke else 5

    plane = _WirePlane()
    kubectl = None
    try:
        plane.start()
        exp = AuditExporter(plane.url)
        exp.poll()                  # enable audit BEFORE the workload
        kubectl = RemoteCluster(plane.url)
        for sname, kind in slices:
            for node in domain_nodes(domain_for(sname, kind),
                                    ib_fabric="ib-0"):
                kubectl.add_node(node)

        walls = []
        for t in range(trials):
            name = f"wiregang-{t}"
            t0 = time.perf_counter()
            kubectl.add_vcjob(_wire_gang_job(name, replicas))
            _wire_wait(lambda: _job_running(kubectl, name, replicas),
                       45, lambda: f"{name} bound ({plane.log_tails()[-800:]})")
            walls.append(time.perf_counter() - t0)
            # job completes (RUN_TICKS) and frees the slice for the
            # next trial: identical capacity per trial
            _wire_wait(lambda: _job_completed(kubectl, name),
                       45, f"{name} completed")
        exp.poll()
        lats = sorted(v for k, v in exp.pod_latencies().items()
                      if "/wiregang-" in k)
        assert len(lats) >= replicas * trials, \
            f"audit saw {len(lats)} gang pods"
        return {
            "wire_gang_p50_s": round(statistics.median(lats), 4),
            "wire_gang_p95_s": round(
                lats[max(0, -(-len(lats) * 95 // 100) - 1)], 4),
            "wire_gang_submit_to_bound_p50_s": round(
                statistics.median(walls), 4),
            "gang_replicas": replicas, "trials": trials,
            "hosts": sum(len(domain_nodes(domain_for(s, k)))
                         for s, k in slices),
            "audit_pods_measured": len(lats),
        }
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def bench_wire_scale(smoke: bool = False) -> dict:
    """Wire-mode scale row: a >=1k-host cluster mirrored through the
    state server with churn riding the watch streams.  Reports mirror
    bootstrap cost, a 64-host topology gang
    through the wire at scale, churn convergence across multiple
    watch streams, and delta-vs-full resync cost — the O(churn) vs
    O(cluster) proof for the new /delta lane."""
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.server.audit_exporter import AuditExporter
    from volcano_tpu_torch.simulator import domain_nodes

    n_slices = 1 if smoke else 16           # 16 x h100-64x8 = 1024 hosts
    slice_kind = "h100-4x8" if smoke else "h100-64x8"
    gang_hosts = 4 if smoke else 64
    churn_jobs = 3 if smoke else 24

    plane = _WirePlane()
    mirrors = []
    try:
        plane.start()
        exp = AuditExporter(plane.url)
        exp.poll()
        t0 = time.perf_counter()
        kubectl = RemoteCluster(plane.url)
        mirrors.append(kubectl)
        for i in range(n_slices):
            for node in domain_nodes(domain_for(f"t{i:02d}", slice_kind),
                                    ib_fabric=f"ib-{i % 4}"):
                kubectl.add_node(node)
        provision_s = time.perf_counter() - t0
        hosts = len(kubectl.nodes)

        # cold mirror bootstrap: one full LIST of the whole cluster
        # (codec fast path + gzip are exactly what this pays for)
        t0 = time.perf_counter()
        obs1 = RemoteCluster(plane.url)
        bootstrap_s = time.perf_counter() - t0
        obs2 = RemoteCluster(plane.url)
        mirrors += [obs1, obs2]
        # frozen pre-churn mirror: the delta-resync measurand
        stale = RemoteCluster(plane.url, start_watch=False)
        mirrors.append(stale)

        # 64-host hard-topology gang through the wire at scale
        t0 = time.perf_counter()
        kubectl.add_vcjob(_wire_gang_job("scalegang", gang_hosts))
        _wire_wait(lambda: _job_running(kubectl, "scalegang",
                                        gang_hosts),
                   90, lambda: "scale gang bound (" + plane.log_tails()[-800:] + ")")
        gang_wall_s = time.perf_counter() - t0

        # churn burst: small cpu gangs completing in waves, fanning
        # out over every watch stream (5 mirrors incl. scheduler +
        # controllers)
        t0 = time.perf_counter()
        for i in range(churn_jobs):
            kubectl.add_vcjob(_wire_cpu_job(f"churn-{i}"))

        def churned(c):
            from volcano_tpu_torch.api.types import JobPhase
            return sum(1 for j in c.vcjobs.values()
                       if j.name.startswith("churn-")
                       and j.phase is JobPhase.COMPLETED) >= churn_jobs
        _wire_wait(lambda: churned(kubectl) and churned(obs1)
                   and churned(obs2),
                   120, lambda: "churn convergence (" + plane.log_tails()[-800:] + ")")
        churn_s = time.perf_counter() - t0

        # delta resync: O(churn window); full re-list: O(cluster)
        t0 = time.perf_counter()
        stale.resync()
        delta_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stale._full_resync()
        full_s = time.perf_counter() - t0
        assert len(stale.nodes) == hosts

        exp.poll()
        gang_lats = sorted(v for k, v in exp.pod_latencies().items()
                           if "/scalegang-" in k)
        return {
            "hosts": hosts,
            "provision_s": round(provision_s, 4),
            "mirror_bootstrap_s": round(bootstrap_s, 4),
            f"gang{gang_hosts}_submit_to_bound_s": round(gang_wall_s, 4),
            f"gang{gang_hosts}_audit_p50_s": round(
                statistics.median(gang_lats), 4) if gang_lats else None,
            "churn_jobs": churn_jobs,
            "churn_converge_s": round(churn_s, 4),
            "watch_streams": 5,     # kubectl, 2 observers, sched, ctrl
            "delta_resync_s": round(delta_s, 4),
            "full_resync_s": round(full_s, 4),
            "audit_lost_records": exp.lost_records,
        }
    finally:
        for m in mirrors:
            m.close()
        plane.shutdown()


def _wire_cpu_job(name, replicas=2, run_ticks=2):
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    return VCJob(name=name, min_available=replicas,
                 tasks=[TaskSpec(
                     name="w", replicas=replicas,
                     template=make_pod(
                         "t", requests={"cpu": 4},
                         annotations={RUN_TICKS_ANNOTATION:
                                      str(run_ticks)}))])


def bench_wire_usage_roundtrip() -> dict:
    """Round-trip ONE bandwidth usage report + violation event through
    the real state-server process: a node agent on its own wire mirror
    measures an over-watermark offline pod (fake cgroup counters), the
    server folds the report into node annotations, and a SECOND wire
    mirror observes the violation — accounting traffic proven on the
    wire, not just in-process (tier-1 via --wire-smoke)."""
    import os
    import shutil
    import tempfile
    import urllib.request

    from volcano_tpu_torch.agent.agent import (DCN_BANDWIDTH_ANNOTATION,
                                         FakeUsageProvider, NodeAgent)
    from volcano_tpu_torch.agent.collect import NetAccountingCollector
    from volcano_tpu_torch.agent.enforcer import CgroupV2Enforcer
    from volcano_tpu_torch.api.netusage import (NODE_SATURATED_ANNOTATION,
                                          POD_VIOLATING_ANNOTATION)
    from volcano_tpu_torch.api.node_info import Node
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.types import (QOS_BEST_EFFORT,
                                       QOS_LEVEL_ANNOTATION, TaskStatus)
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster

    plane = _WirePlane()
    mirrors = []
    tmp = tempfile.mkdtemp(prefix="wire-netacct-")
    try:
        plane.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port))

        def up():
            try:
                with urllib.request.urlopen(plane.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        kubectl = RemoteCluster(plane.url)
        mirrors.append(kubectl)
        kubectl.add_node(Node(
            name="n0", allocatable={"cpu": "64", "pods": 110},
            annotations={DCN_BANDWIDTH_ANNOTATION: "1000"}))
        hog = make_pod("hog", requests={"cpu": 1}, node_name="n0",
                       phase=TaskStatus.RUNNING,
                       annotations={QOS_LEVEL_ANNOTATION:
                                    QOS_BEST_EFFORT})
        kubectl.add_pod(hog)

        agent_view = RemoteCluster(plane.url)
        mirrors.append(agent_view)
        _wire_wait(lambda: "default/hog" in agent_view.pods, 10,
                   "agent mirror sees pod")
        provider = FakeUsageProvider()
        provider.set("n0", cpu_fraction=0.2)
        cg = CgroupV2Enforcer(os.path.join(tmp, "cg"))
        col = NetAccountingCollector(cg.root)
        agent = NodeAgent(agent_view, "n0", provider, enforcer=cg,
                          net_collector=col)
        uid = agent_view.pods["default/hog"].uid

        t0 = time.perf_counter()
        agent.sync()                   # tag the cgroup
        tx = 0
        pod_dir = os.path.join(
            cg.root, CgroupV2Enforcer.POD_DIR_PREFIX + uid)

        def advance(n_bytes):
            nonlocal tx
            tx += n_bytes
            with open(os.path.join(pod_dir, "net_stat.tx_bytes"),
                      "w") as f:
                f.write(str(tx))

        advance(0)
        time.sleep(0.06)
        agent.sync()                   # baseline reading
        for _ in range(4):             # far over the 400 mbps cap
            advance(67_500_000)
            time.sleep(0.06)
            agent.sync()

        obs = RemoteCluster(plane.url)
        mirrors.append(obs)
        _wire_wait(
            lambda: obs.bandwidthreports.get("n0") is not None
            and obs.bandwidthreports["n0"].violations == 1
            and obs.nodes["n0"].annotations.get(
                NODE_SATURATED_ANNOTATION) == "true"
            and obs.pods["default/hog"].annotations.get(
                POD_VIOLATING_ANNOTATION) == "true",
            15, "violation visible on observer mirror")
        return {"usage_report_roundtrip_ok": True,
                "violation_roundtrip_ok": True,
                "measure_to_observe_s": round(
                    time.perf_counter() - t0, 4)}
    finally:
        for m in mirrors:
            m.close()
        plane.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def run_wire_benchmarks(smoke: bool = False) -> dict:
    """The wire scenarios, each failure-isolated: a wire stall must
    report itself in the JSON, never kill the in-process numbers."""
    out = {}
    try:
        out.update(bench_wire_gang(smoke))
    except Exception as e:  # noqa: BLE001 — report, don't die
        out["wire_gang_error"] = str(e)[-600:]
    try:
        out["scale"] = bench_wire_scale(smoke)
    except Exception as e:  # noqa: BLE001
        out["scale"] = {"error": str(e)[-600:]}
    try:
        out["usage_roundtrip"] = bench_wire_usage_roundtrip()
    except Exception as e:  # noqa: BLE001
        out["usage_roundtrip"] = {"error": str(e)[-600:]}
    return out


def bench_reference_gang_shape() -> float:
    """The reference harness's default gang scenario (benchmark/README
    JOBS=10, REPLICAS=100, MIN_AVAILABLE=100 over 100 nodes): seconds
    until all 1000 pods are bound."""
    from volcano_tpu_torch.api.node_info import Node
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    cluster = FakeCluster()
    for i in range(100):
        cluster.add_node(Node(name=f"n{i}",
                              allocatable={"cpu": 112, "pods": 256}))
    for j in range(10):
        pg, pods = gang_job(f"job{j}", replicas=100, requests={"cpu": 1})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
    sched = Scheduler(cluster, conf=BENCH_CONF, schedule_period=0)
    t0 = time.perf_counter()
    for _ in range(50):  # bounded: a stall must fail, not hang the run
        sched.run_once()
        cluster.tick()
        if len(cluster.binds) >= 1000:
            break
    assert len(cluster.binds) >= 1000, \
        f"gang shape stalled at {len(cluster.binds)}/1000 binds"
    return time.perf_counter() - t0


def bench_agent_scheduler_throughput() -> float:
    """Fast-path pods/second over a 500-pod burst (the reference's
    bare-pod benchmark default, benchmark/README PODS=500)."""
    from volcano_tpu_torch.agentscheduler import AgentScheduler
    from volcano_tpu_torch.api.node_info import Node
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.shard import AGENT_SCHEDULER
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster

    def one_burst() -> float:
        """One 500-pod burst on a FRESH cluster + scheduler (identical
        conditions per trial; teardown-free — delete events would
        trigger untimed full cache refreshes)."""
        cluster = FakeCluster()
        for i in range(20):
            cluster.add_node(Node(name=f"n{i}",
                                  allocatable={"cpu": 64, "pods": 256}))
        sched = AgentScheduler(cluster)
        # throughput with the batch-parity predicate chain DISABLED is
        # not a result: prove the default chain
        assert [p.name for p in sched.plugins] == \
            ["predicates", "resources", "deviceshare", "leastalloc"], \
            f"parity chain not enabled: {[p.name for p in sched.plugins]}"
        # warmup: first-touch imports and spec-cache build are startup
        # costs, not steady-state throughput
        for i in range(50):
            pod = make_pod(f"warm{i}", requests={"cpu": "100m"})
            pod.scheduler_name = AGENT_SCHEDULER
            cluster.add_pod(pod)
        assert sched.run_until_drained() == 50
        for i in range(500):
            pod = make_pod(f"a{i}", requests={"cpu": "100m"})
            pod.scheduler_name = AGENT_SCHEDULER
            cluster.add_pod(pod)
        t0 = time.perf_counter()
        bound = sched.run_until_drained()
        dt = time.perf_counter() - t0
        assert bound == 500, f"agent bound {bound}/500"
        return bound / dt

    # median of 3 independent trials: robust to one host stall, each
    # trial a single run of the same method
    return statistics.median(one_burst() for _ in range(3))


def bench_gangpreempt_latency() -> float:
    """p50 wall-clock for a high-priority 64-host hard-topology gang to
    displace a low-priority tenant occupying a full 64-host domain: the
    two-cycle evict -> nominate -> allocate handshake, measured from
    submission to the 64th bind (scenario shape
    mirrors the reference's preempt benchmark, benchmark/README.md)."""
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import NetworkTopologyMode, PodGroupPhase
    from volcano_tpu_torch.cache.cluster import PriorityClass
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    conf = {
        "actions": "enqueue, allocate, gangpreempt, backfill",
        "tiers": [
            {"plugins": [{"name": "priority"}, {"name": "gang"},
                         {"name": "conformance"}]},
            {"plugins": [{"name": "predicates"}, {"name": "proportion"},
                         {"name": "nodeorder"}, {"name": "deviceshare"},
                         {"name": "network-topology-aware"}]},
        ],
    }
    latencies = []
    for trial in range(max(3, TRIALS // 2)):
        cluster = make_domain_cluster([("target", "h100-64x8"),   # 64 hosts
                                    ("noise", "h100-16x8")])
        cluster.add_priority_class(PriorityClass("high", 1000))
        # low-priority elastic tenant holds the whole target slice
        pg_lo, pods_lo = gang_job(
            "tenant", replicas=64, min_available=1,
            requests={"cpu": 8, GPU: 8},
            running_on=[f"target-w{i}" for i in range(64)],
            pg_phase=PodGroupPhase.RUNNING)
        cluster.add_podgroup(pg_lo)
        for p in pods_lo:
            cluster.add_pod(p)
        pg_hi, pods_hi = gang_job(
            "train-hi", replicas=64, requests={"cpu": 8, GPU: 8},
            priority_class="high",
            network_topology=NetworkTopologySpec(
                NetworkTopologyMode.HARD, 1),
            pg_phase=PodGroupPhase.INQUEUE)
        sched = Scheduler(cluster, conf=conf, schedule_period=0)
        sched.run_once()   # warm (tenant steady state)

        t0 = time.perf_counter()
        cluster.add_podgroup(pg_hi)
        for p in pods_hi:
            cluster.add_pod(p)
        for _ in range(10):
            sched.run_once()
            cluster.tick()
            hi = {k for k, _ in cluster.binds
                  if k.startswith("default/train-hi")}
            if len(hi) >= 64:
                break
        dt = time.perf_counter() - t0
        assert len(hi) >= 64, f"gangpreempt stalled: {len(hi)}/64 bound"
        latencies.append(dt)
    return statistics.median(latencies)


def bench_reclaim_convergence() -> float:
    """Seconds for a 2-queue overcommit flip to converge: queue
    'greedy' holds the whole 2-slice cluster; queue 'owed' submits
    demand for its half; reclaim must evict greedy's surplus and bind
    owed's jobs to its full deserved share."""
    from volcano_tpu_torch.api.queue import Queue
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import PodGroupPhase
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    conf = {
        "actions": "enqueue, allocate, reclaim, backfill",
        "tiers": [
            {"plugins": [{"name": "priority"}, {"name": "gang"},
                         {"name": "conformance"}]},
            {"plugins": [{"name": "predicates"}, {"name": "proportion"},
                         {"name": "nodeorder"}, {"name": "deviceshare"}]},
        ],
    }
    cluster = make_domain_cluster([("sa", "h100-16x8"), ("sb", "h100-16x8")])
    cluster.add_queue(Queue(name="greedy", weight=1))
    cluster.add_queue(Queue(name="owed", weight=1))
    # greedy: 8 elastic 4-host gangs = all 32 hosts
    hosts = sorted(cluster.nodes)
    for i in range(8):
        mine = hosts[i * 4:(i + 1) * 4]
        pg, pods = gang_job(f"greedy-{i}", queue="greedy", replicas=4,
                            min_available=1, requests={"cpu": 8, GPU: 8},
                            running_on=mine,
                            pg_phase=PodGroupPhase.RUNNING)
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
    sched = Scheduler(cluster, conf=conf, schedule_period=0)
    sched.run_once()

    # the flip: owed demands exactly its deserved half (16 hosts)
    t0 = time.perf_counter()
    for i in range(4):
        pg, pods = gang_job(f"owed-{i}", queue="owed", replicas=4,
                            requests={"cpu": 8, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
    for _ in range(20):
        sched.run_once()
        cluster.tick()
        owed = {k for k, _ in cluster.binds
                if k.startswith("default/owed-")}
        if len(owed) >= 16:
            break
    dt = time.perf_counter() - t0
    assert len(owed) >= 16, f"reclaim stalled: {len(owed)}/16 bound"
    return dt


def bench_5k_host_scale() -> dict:
    """5,000-host scale headroom: idle-cycle seconds + one-cycle
    latency for a 1024-host gang."""
    return _scale_gang_probe(78, 1024)


def _build_scale_cluster(n_slices: int, busy_fraction: float = 0.6):
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.podgroup import PodGroup
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import (GROUP_NAME_ANNOTATION,
                                       PodGroupPhase, TaskStatus)

    slices = [(f"t{i:03d}", "h100-64x8") for i in range(n_slices)]
    cluster = make_domain_cluster(slices)
    names = sorted(cluster.nodes)
    busy = names[: int(len(names) * busy_fraction)]
    for j, start in enumerate(range(0, len(busy), 64)):
        hosts = busy[start:start + 64]
        pg = PodGroup(name=f"pg{j}", min_member=len(hosts),
                      phase=PodGroupPhase.RUNNING)
        cluster.add_podgroup(pg)
        for i, node in enumerate(hosts):
            cluster.add_pod(make_pod(
                f"j{j}-{i}", requests={"cpu": 8, GPU: 8},
                annotations={GROUP_NAME_ANNOTATION: pg.key},
                node_name=node, phase=TaskStatus.RUNNING))
    return cluster


def _scale_gang_probe(n_slices: int, gang: int) -> dict:
    """Idle-cycle + one-cycle gang latency on an n_slices x h100-64x8
    cluster, 60% pre-occupied.  The steady cluster graph is
    gc.freeze()-d before the timed cycles: gen-2 collections scanning
    a 10k-host object graph added up to 0.3s of per-run variance
    (a '0.7-1.3s' spread) that says nothing about the scheduler.
    Production guidance is the same — freeze the post-LIST graph."""
    import gc

    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    cluster = _build_scale_cluster(n_slices)
    sched = Scheduler(cluster, conf=BENCH_CONF, schedule_period=0)
    sched.run_once()                   # warm-up
    gc.collect()
    gc.freeze()
    try:
        t0 = time.perf_counter()
        sched.run_once()
        idle_s = time.perf_counter() - t0
        pg, pods = gang_job(f"g{gang}", replicas=gang,
                            min_available=gang,
                            requests={"cpu": 8, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        t0 = time.perf_counter()
        sched.run_once()
        gang_s = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    bound = sum(1 for k, _ in cluster.binds
                if k.startswith(f"default/g{gang}"))
    assert bound == gang, f"scale gang bound {bound}/{gang}"
    return {"hosts": len(cluster.nodes),
            "idle_cycle_s": round(idle_s, 4),
            f"gang{gang}_cycle_s": round(gang_s, 4)}


def bench_10k_host_scale() -> dict:
    """10,000-host headroom probe: 157 64-host domains (10,048 hosts),
    60% pre-occupied; idle-cycle seconds + one-cycle latency for a
    2048-host gang."""
    return _scale_gang_probe(157, 2048)


def _scale_knee(s5k: dict, s10k: dict, s20k: dict,
                s40k: Optional[dict] = None) -> dict:
    """Per-gang-member cycle cost at each scale point.  Flat =
    linear scaling (no knee yet); a bend marks where superlinear
    costs start."""
    def per_member(d, gang):
        v = d.get(f"gang{gang}_cycle_s")
        return round(v / gang * 1000, 4) if isinstance(v, (int, float)) \
            else None
    out = {"ms_per_member_5k": per_member(s5k, 1024),
           "ms_per_member_10k": per_member(s10k, 2048),
           "ms_per_member_20k": per_member(s20k, 4096)}
    if s40k is not None:
        out["ms_per_member_40k"] = per_member(s40k, 8192)
    return out


def bench_20k_host_scale() -> dict:
    """20,000-host knee probe: 313 domains
    (20,032 hosts), 4096-host gang.  Establishes where the per-cycle
    cost curve bends — see BENCH extra.scale_knee."""
    return _scale_gang_probe(313, 4096)


def bench_40k_host_scale() -> dict:
    """40,000-host probe as a REPEATABLE bench output:
    625 domains (40,000 hosts), 8192-host gang.  Also exposed as
    `python -m volcano_tpu_torch.bench --scale-40k` so the row can be regenerated
    standalone without the full suite."""
    return _scale_gang_probe(625, 8192)


# -- process-parallel scheduler cycle -----------------

SWEEP_WORKER_STEPS = (1, 2, 4, 8)


def _sweep_entry_bench(ssn, nodes, task, backend: str, workers: int,
                       reps: int = 3):
    """Best-of-reps build_entry wall time under the given sweep
    backend ('' = the serial fallback path)."""
    from volcano_tpu_torch.actions.sweep import SpecCache
    conf = ssn.conf.configurations.setdefault("allocate", {})
    conf["parallelPredicates"] = backend if backend else False
    conf["parallelPredicates.workers"] = workers or 1
    best, entry = float("inf"), None
    for _ in range(reps):
        cache = SpecCache(ssn, nodes, record_errors=False)
        t0 = time.perf_counter()
        entry = cache.build_entry(task)
        best = min(best, time.perf_counter() - t0)
    return best, entry


def _entries_identical(a, b) -> bool:
    return (a["fits"].keys() == b["fits"].keys()
            and a["scores"] == b["scores"]
            and a["meta"] == b["meta"])


def _span_waterfall(doc: Optional[dict]) -> dict:
    """Flatten a kept session trace into {span_name: seconds} for the
    parallel-cycle attribution spans (summed over occurrences), so the
    SCALE artifact shows where a cycle's time went."""
    names = ("snapshot_build", "open_session", "delta_ship",
             "sweep_fanout", "sweep_merge", "allocate", "enqueue",
             "backfill", "close_session")
    out: dict = {}

    def walk(s):
        if s["name"] in names:
            out[s["name"]] = round(
                out.get(s["name"], 0.0) + s["dur"], 4)
        for c in s.get("children", ()):
            walk(c)

    if doc and doc.get("root"):
        walk(doc["root"])
        out["session"] = round(doc["root"]["dur"], 4)
    return out


def _sweep_entry_matrix(ssn, nodes, task, reps: int) -> Tuple[list, bool]:
    """Serial baseline + thread/process rows at every worker count;
    returns (rows, all_identical)."""
    serial_s, serial_entry = _sweep_entry_bench(ssn, nodes, task, "",
                                                0, reps)
    rows = [{"backend": "serial", "workers": 0,
             "ms": round(serial_s * 1000, 2), "speedup_vs_serial": 1.0,
             "entry_identical_to_serial": True}]
    all_ok = True
    for backend in ("thread", "process"):
        for w in SWEEP_WORKER_STEPS:
            if backend == "process":
                # the process-wide pool grows and never shrinks — a
                # fresh pool per step keeps the row at EXACTLY w
                # workers (first rep pays the bootstrap, best-of-reps
                # reports the synced steady state)
                from volcano_tpu_torch.actions import procpool
                procpool.shutdown()
            t, entry = _sweep_entry_bench(ssn, nodes, task, backend,
                                          w, reps)
            identical = _entries_identical(entry, serial_entry)
            all_ok &= identical
            rows.append({
                "backend": backend, "workers": w,
                "ms": round(t * 1000, 2),
                "speedup_vs_serial": round(serial_s / t, 2),
                "entry_identical_to_serial": identical})
            print(f"  {backend}@{w}: {t*1000:.1f} ms "
                  f"({serial_s/t:.2f}x, identical={identical})",
                  flush=True)
    return rows, all_ok


def bench_scale_100k(n_slices: int = 1563, gang: int = 8192,
                     include_40k: bool = True) -> dict:
    """The 100k-host row: a 100k-host cluster
    (1563 x h100-64x8 = 100,032 hosts, 60% pre-occupied) measured
    through the incremental-snapshot cycle with all three sweep
    backends.

    Sections:
      cycles        idle + 8192-gang cycle seconds per backend
                    (serial / thread@8 / process@8), with the
                    process cycle's flight-recorder waterfall
                    (snapshot_build / delta_ship / sweep_fanout /
                    sweep_merge / allocate) — where the time goes;
      entry_rows    per-spec build_entry sweep at every worker count
                    for both pools, bit-identity asserted against the
                    serial entry (disarmed, then ARMED under the
                    freeze auditor, mirroring volcano_tpu_torch/tools/race_bench.py);
      idle_40k      the acceptance row: incremental snapshot reuse
                    must hold the 40k idle cycle at or under 0.1s.
    """
    import copy
    import gc
    import os as _os

    from volcano_tpu_torch import trace
    from volcano_tpu_torch.actions import procpool
    from volcano_tpu_torch.analysis import freezeaudit
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import TaskStatus
    from volcano_tpu_torch.framework.framework import (close_session,
                                                 open_session)
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    t_build = time.perf_counter()
    cluster = _build_scale_cluster(n_slices)
    conf = copy.deepcopy(BENCH_CONF)
    sched = Scheduler(cluster, conf=conf, schedule_period=0)
    sched.run_once()                       # warm-up full snapshot
    build_s = time.perf_counter() - t_build
    print(f"built {len(cluster.nodes)} hosts in {build_s:.1f}s",
          flush=True)
    gc.collect()
    gc.freeze()

    backends = (("serial", False, 0), ("thread", "thread", 8),
                ("process", "process", 8))
    cycles = {}
    waterfall = {}
    try:
        for label, raw, workers in backends:
            sched.conf.configurations["allocate"] = {
                "parallelPredicates": raw,
                "parallelPredicates.workers": workers}
            sched.run_once()               # absorb prior dirty state
            if label == "process":
                # pre-warm: production runs a PERSISTENT pool — the
                # worker spawn + bootstrap full sync happens once per
                # scheduler lifetime, not inside a measured cycle;
                # the timed gang cycle below ships only the delta
                ssn = open_session(sched.cache, sched.conf)
                procpool.pool(workers).ensure_sync(ssn)
                close_session(ssn)
                gc.collect()   # bootstrap pickle garbage, not the
                gc.freeze()    # timed cycles', pays the GC bill here
            t0 = time.perf_counter()
            sched.run_once()               # steady idle cycle
            idle_s = time.perf_counter() - t0
            pg, pods = gang_job(f"g-{label}", replicas=gang,
                                min_available=gang,
                                requests={"cpu": 8, GPU: 8})
            cluster.add_podgroup(pg)
            for p in pods:
                cluster.add_pod(p)
            trace.reset()                  # first session is kept
            t0 = time.perf_counter()
            sched.run_once()
            gang_s = time.perf_counter() - t0
            bound = sum(1 for k, _ in cluster.binds
                        if k.startswith(f"default/g-{label}"))
            assert bound == gang, \
                f"{label}: gang bound {bound}/{gang}"
            cycles[label] = {"idle_cycle_s": round(idle_s, 4),
                             f"gang{gang}_cycle_s": round(gang_s, 4)}
            kept = trace.recent_traces(limit=1)
            if kept:
                waterfall[label] = _span_waterfall(kept[-1])
            print(f"  {label}: idle {idle_s:.4f}s "
                  f"gang{gang} {gang_s:.3f}s", flush=True)
            # advance the bound gang to Running so the next backend's
            # idle row measures a STEADY fleet (a Bound gang keeps
            # its job non-steady, which forces the incremental — not
            # the reuse — path every cycle, by design)
            cluster.tick()

        # -- batched gang commit row (docs/design/sharding.md) ---------
        # same gang, same fleet, but the allocator drains the whole
        # spec through one heap + fill-to-capacity statement instead
        # of the per-pod walk: the serial row above is its baseline
        sched.conf.configurations["allocate"] = {"gangCommit": "batch"}
        sched.run_once()                   # absorb prior dirty state
        pg, pods = gang_job("g-gc", replicas=gang, min_available=gang,
                            requests={"cpu": 8, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        trace.reset()
        t0 = time.perf_counter()
        sched.run_once()
        gc_s = time.perf_counter() - t0
        bound = sum(1 for k, _ in cluster.binds
                    if k.startswith("default/g-gc"))
        assert bound == gang, f"gang commit bound {bound}/{gang}"
        walk_s = cycles["serial"][f"gang{gang}_cycle_s"]
        cycles["gang_commit_batch"] = {
            f"gang{gang}_cycle_s": round(gc_s, 4),
            "speedup_vs_walk": round(walk_s / gc_s, 2)}
        kept = trace.recent_traces(limit=1)
        if kept:
            waterfall["gang_commit_batch"] = _span_waterfall(kept[-1])
        print(f"  gang_commit_batch: gang{gang} {gc_s:.3f}s "
              f"({walk_s / gc_s:.2f}x vs walk)", flush=True)
        cluster.tick()

        # -- per-spec sweep rows: disarmed then armed ------------------
        pg, pods = gang_job("probe", replicas=gang,
                            min_available=gang,
                            requests={"cpu": 8, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        ssn = open_session(sched.cache, sched.conf)
        task = next(t for j in ssn.jobs.values()
                    for t in j.tasks_in_status(TaskStatus.PENDING))
        nodes = list(ssn.nodes.values())
        print("entry sweep (disarmed):", flush=True)
        rows, ok_disarmed = _sweep_entry_matrix(ssn, nodes, task, 2)
        close_session(ssn)

        freezeaudit.install()
        freezeaudit.reset()
        ssn = open_session(sched.cache, sched.conf)
        task = next(t for j in ssn.jobs.values()
                    for t in j.tasks_in_status(TaskStatus.PENDING))
        nodes = list(ssn.nodes.values())
        print("entry sweep (ARMED):", flush=True)
        armed_rows, ok_armed = _sweep_entry_matrix(ssn, nodes, task, 1)
        close_session(ssn)
        audit = freezeaudit.report()
        freezeaudit.uninstall()

        # -- sharded plane rows (docs/design/sharding.md) --------------
        # N subtree-sharded schedulers over the SAME 100k-host fleet,
        # batched commit on, the 8192-pod load split into 8 gangs of
        # 1024 so the stable job->shard hash spreads them.  Each
        # shard's cycle is timed on its own: on a real plane the
        # shards run on separate hosts in parallel, so
        # max_shard_cycle_s is the plane's wall-clock; here they
        # serialize on one core (host_cpus recorded per row).
        from volcano_tpu_torch import shardmap

        def _drain_gang(prefix):
            # free the GPUs a finished bench gang holds: the fleet
            # only has 40% headroom, and each plane below needs the
            # full 8192x8 GPUs back
            for key in [k for k in cluster.pods
                        if k.startswith(f"default/{prefix}")]:
                cluster.delete_object("pod", key)
            for key in [k for k in cluster.podgroups
                        if k.startswith(f"default/{prefix}")]:
                cluster.delete_object("podgroup", key)

        for prefix in ("g-serial", "g-thread", "g-process", "g-gc",
                       "probe"):
            _drain_gang(prefix)
        sharded = {}
        for count in (2, 4):
            scheds = []
            for si in range(count):
                sconf = copy.deepcopy(BENCH_CONF)
                sconf["configurations"] = {"allocate": {
                    "gangCommit": "batch", "shard-spill": "soft"}}
                s = Scheduler(cluster, conf=sconf, schedule_period=0,
                              shard_index=si, shard_count=count)
                s.run_once()             # warm full snapshot
                scheds.append(s)
            njobs = 8
            names = [f"gs{count}-{i}" for i in range(njobs)]
            homes = {n: shardmap.home_shard(f"default/{n}", count)
                     for n in names}
            for n in names:
                pg, pods = gang_job(n, replicas=gang // njobs,
                                    min_available=gang // njobs,
                                    requests={"cpu": 8, GPU: 8})
                cluster.add_podgroup(pg)
                for p in pods:
                    cluster.add_pod(p)
            srows = []
            bound_total = 0
            for si, s in enumerate(scheds):
                mine = [n for n in names if homes[n] == si]
                t0 = time.perf_counter()
                s.run_once()
                dt = time.perf_counter() - t0
                bound = sum(1 for k, _ in cluster.binds
                            if any(k.startswith(f"default/{n}-")
                                   for n in mine))
                bound_total += bound
                srows.append({"shard": f"{si}/{count}",
                              "gangs_homed": len(mine),
                              "pods_bound": bound,
                              "cycle_s": round(dt, 4),
                              "host_cpus": _os.cpu_count()})
                print(f"  shard {si}/{count}: {len(mine)} gangs, "
                      f"{bound} pods, cycle {dt:.3f}s", flush=True)
            assert bound_total == gang, \
                f"sharded plane bound {bound_total}/{gang}"
            sharded[str(count)] = {
                "per_shard": srows,
                "max_shard_cycle_s": max(r["cycle_s"] for r in srows),
                "sum_shard_cycle_s": round(
                    sum(r["cycle_s"] for r in srows), 4)}
            cluster.tick()
            for s in scheds:
                cluster.unwatch(s.cache._on_cluster_event)
            del scheds
            _drain_gang(f"gs{count}-")
            gc.collect()
    finally:
        gc.unfreeze()
        procpool.shutdown()

    out = {
        "hosts": len(cluster.nodes),
        "host_cpus": _os.cpu_count(),
        "gang": gang,
        "cycles": cycles,
        "waterfall_s": waterfall,
        "sharded_plane": sharded,
        "entry_rows_disarmed": rows,
        "entry_rows_armed": armed_rows,
        "entries_identical_all_backends_all_worker_counts":
            ok_disarmed and ok_armed,
        "freeze_audit": {
            "sessions_frozen": audit["sessions_frozen"],
            "fanout_regions": audit["fanout_regions"],
            "tracked_stores": audit["tracked_stores"],
            "violations": audit["violations"],
        },
        "note": ("single-CPU host: process/thread rows measure the "
                 "batched prepared-form sweep plus the mirror "
                 "protocol's IPC overhead, serialized by one core — "
                 "host_cpus recorded so a multi-core replay separates "
                 "the batching win from hardware parallelism"),
    }
    if include_40k:
        print("40k idle-cycle acceptance row:", flush=True)
        s40 = bench_40k_host_scale()
        s40["idle_le_0.1s"] = s40["idle_cycle_s"] <= 0.1
        out["idle_40k"] = s40
    out["ok"] = bool(
        out["entries_identical_all_backends_all_worker_counts"]
        and not audit["violations"]
        and (not include_40k or out["idle_40k"]["idle_le_0.1s"]))
    return out


def bench_sweep_smoke() -> dict:
    """Tier-1 smoke for the process-pool sweep: REAL worker OS
    processes on a small cluster — entry bit-identity vs serial,
    full-cycle placement identity vs serial, mirror full->delta sync
    order, distinct worker pids."""
    import copy
    import os as _os

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.actions import procpool
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import TaskStatus
    from volcano_tpu_torch.framework.framework import (close_session,
                                                 open_session)
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.uthelper import gang_job

    def decisions(cluster):
        return sorted((k.rsplit("-", 1)[0], node)
                      for k, node in cluster.binds)

    def run(backend):
        cluster = make_domain_cluster(
            [(f"s{i}", "h100-4x8") for i in range(4)])
        conf = copy.deepcopy(BENCH_CONF)
        if backend:
            conf["configurations"] = {"allocate": {
                "parallelPredicates": backend,
                "parallelPredicates.workers": 2}}
        sched = Scheduler(cluster, conf=conf, schedule_period=0)
        for g in range(2):
            pg, pods = gang_job(f"g{g}", replicas=4, min_available=4,
                                requests={"cpu": 2, GPU: 8})
            cluster.add_podgroup(pg)
            for p in pods:
                cluster.add_pod(p)
        sched.run_once()
        cluster.tick()
        pg, pods = gang_job("late", replicas=4, min_available=4,
                            requests={"cpu": 2, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        sched.run_once()               # second cycle: delta-synced
        return cluster, sched, decisions(cluster)

    try:
        _c, _s, serial = run("")
        cluster, sched, proc = run("process")
        pool = procpool.pool(2)
        pids = {pid for _w, pid, _g, _o in pool.ping()}
        full = metrics._counters.get(
            ("sweep_snapshot_delta_bytes_total",
             (("kind", "full"),)), 0.0)
        delta = metrics._counters.get(
            ("sweep_snapshot_delta_bytes_total",
             (("kind", "delta"),)), 0.0)

        # entry-level bit identity on the live session
        pg, pods = gang_job("probe", replicas=2, min_available=2,
                            requests={"cpu": 2, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        ssn = open_session(sched.cache, sched.conf)
        task = next(t for j in ssn.jobs.values()
                    for t in j.tasks_in_status(TaskStatus.PENDING))
        nodes = list(ssn.nodes.values())
        _, serial_entry = _sweep_entry_bench(ssn, nodes, task, "", 0,
                                             reps=1)
        _, proc_entry = _sweep_entry_bench(ssn, nodes, task,
                                           "process", 2, reps=1)
        close_session(ssn)
        return {
            "placements_identical": proc == serial,
            "entry_identical": _entries_identical(proc_entry,
                                                  serial_entry),
            "real_worker_processes":
                len(pids) == 2 and _os.getpid() not in pids,
            "full_sync_bytes": int(full),
            "delta_sync_bytes": int(delta),
            "synced_full_then_delta": full > 0 and delta > 0,
            "placements": len(serial),
        }
    finally:
        procpool.shutdown()


def sweep_smoke() -> int:
    """CLI wrapper for tier-1 (tests/test_procpool.py), mirroring
    --wire-smoke: prints one JSON line, exit 0 only when every check
    holds."""
    try:
        out = bench_sweep_smoke()
    except Exception as e:  # noqa: BLE001 - smoke must report, not die
        print(json.dumps({"metric": "sweep_smoke", "ok": False,
                          "error": repr(e)}))
        return 1
    ok = (out["placements_identical"] and out["entry_identical"]
          and out["real_worker_processes"]
          and out["synced_full_then_delta"])
    print(json.dumps({"metric": "sweep_smoke", "ok": ok, **out}))
    return 0 if ok else 1


def bench_net_accounting_overhead(pods_per_host: int = 120,
                                  ticks: int = 20) -> dict:
    """Per-tick cost of the network accounting subsystem at 100+ pods on
    one host: a fake cgroup fs with *pods_per_host* BE pods whose
    tx counters advance every tick, measured two ways — the collector
    walk alone, and the full agent sync including the netaccounting
    handler (watermarks, hysteresis, report build)."""
    import os
    import shutil
    import tempfile

    from volcano_tpu_torch.agent.agent import (DCN_BANDWIDTH_ANNOTATION,
                                         FakeUsageProvider, NodeAgent)
    from volcano_tpu_torch.agent.collect import NetAccountingCollector
    from volcano_tpu_torch.agent.enforcer import CgroupV2Enforcer
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.types import (QOS_BEST_EFFORT,
                                       QOS_LEVEL_ANNOTATION, TaskStatus)

    tmp = tempfile.mkdtemp(prefix="netacct-bench-")
    try:
        cluster = make_domain_cluster([("sa", "h100-1x8")])
        node = sorted(cluster.nodes)[0]
        cluster.nodes[node].annotations[DCN_BANDWIDTH_ANNOTATION] = \
            "100000"
        pods = [make_pod(f"be-{i}", node_name=node,
                         phase=TaskStatus.RUNNING,
                         requests={"cpu": "100m"},
                         annotations={QOS_LEVEL_ANNOTATION:
                                      QOS_BEST_EFFORT})
                for i in range(pods_per_host)]
        for p in pods:
            cluster.add_pod(p)
        provider = FakeUsageProvider()
        provider.set(node, cpu_fraction=0.3)
        cg = CgroupV2Enforcer(tmp)
        col = NetAccountingCollector(cg.root)
        agent = NodeAgent(cluster, node, provider, enforcer=cg,
                          net_collector=col)
        agent.sync()                       # tag cgroups, create dirs
        tx = 0

        def advance_counters():
            nonlocal tx
            tx += 1_000_000
            for p in pods:
                path = os.path.join(
                    cg.root, CgroupV2Enforcer.POD_DIR_PREFIX + p.uid,
                    "net_stat.tx_bytes")
                with open(path, "w") as f:
                    f.write(str(tx))

        advance_counters()
        agent.sync()                       # baseline readings
        walk_s = []
        for _ in range(ticks):
            advance_counters()
            time.sleep(NetAccountingCollector.MIN_INTERVAL_S + 0.01)
            t0 = time.perf_counter()
            col.collect(node)
            walk_s.append(time.perf_counter() - t0)
        sync_s = []
        for _ in range(ticks):
            advance_counters()
            time.sleep(NetAccountingCollector.MIN_INTERVAL_S + 0.01)
            t0 = time.perf_counter()
            agent.sync()
            sync_s.append(time.perf_counter() - t0)
        # baseline: the SAME pipeline minus accounting (enforcer knob
        # writes dominate on slow filesystems; the delta is what the
        # subsystem actually costs per tick)
        base_agent = NodeAgent(cluster, node, provider, enforcer=cg)
        base_s = []
        for _ in range(ticks):
            t0 = time.perf_counter()
            base_agent.sync()
            base_s.append(time.perf_counter() - t0)
        with_ms = statistics.median(sync_s) * 1e3
        base_ms = statistics.median(base_s) * 1e3
        return {
            "pods_per_host": pods_per_host,
            "collector_walk_p50_ms": round(
                statistics.median(walk_s) * 1e3, 3),
            "agent_sync_with_accounting_p50_ms": round(with_ms, 3),
            "agent_sync_baseline_p50_ms": round(base_ms, 3),
            "accounting_overhead_p50_ms": round(with_ms - base_ms, 3),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- slice-failover chaos ----------------------------------------------

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


def bench_failover_chaos(smoke: bool = False) -> dict:
    """Chaos scenario for the failover subsystem: a hard-topology gang
    trains on one slice of a 1k-host cluster, one of its hosts dies
    (GPU telemetry flips; the agent's K-tick hysteresis detects it),
    and the detect → declare → drain → reschedule → resume loop runs
    through the REAL control path (agent handler → SliceHealthReport →
    failover controller → RestartJob → scheduler with quarantine
    filter).  Reports the wall-clock MTTR p50/p95 with the per-phase
    breakdown from the failover_* metric families, plus the control-
    cycle count to recovery."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.slicehealth import (
        CHECKPOINT_DIR_ANNOTATION, FAILOVER_GENERATION_ANNOTATION,
        LAST_STEP_ANNOTATION)
    from volcano_tpu_torch.api.types import (JobPhase, NetworkTopologyMode,
                                       GPU_CLIQUE_LABEL, TaskStatus)
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import fail_host

    slice_kind = "h100-4x8" if smoke else "h100-64x8"    # 4 / 64 hosts
    n_slices = 2 if smoke else 16                    # 8 / 1024 hosts
    gang = 4 if smoke else 64                        # one whole slice
    trials = 1 if smoke else 5
    cycle_budget = 40

    phases = {k: [] for k in ("detect", "drain", "reschedule",
                              "resume", "mttr", "step_gap")}
    cycles_to_recover = []
    hosts = None
    for trial in range(trials):
        cluster = make_domain_cluster(
            [(f"t{trial}s{i}", slice_kind) for i in range(n_slices)])
        hosts = len(cluster.nodes)
        mgr = ControllerManager(cluster, enabled=[
            "job", "podgroup", "queue", "failover"])
        sched = Scheduler(cluster, conf=FAILOVER_CONF,
                          schedule_period=0)

        def cycle(agent=None):
            if agent is not None:
                agent.sync()
            mgr.sync_all()
            sched.run_once()
            cluster.tick()

        job = VCJob(
            name="train", min_available=gang,
            annotations={CHECKPOINT_DIR_ANNOTATION: "/ckpt/train",
                         LAST_STEP_ANNOTATION: "1000"},
            network_topology=NetworkTopologySpec(
                NetworkTopologyMode.HARD, 1),
            plugins={"torch": []},
            tasks=[TaskSpec(name="worker", replicas=gang,
                            template=make_pod(
                                "t", requests={"cpu": 8, GPU: 8}))])
        cluster.add_vcjob(job)
        for _ in range(10):
            cycle()
            j = cluster.vcjobs["default/train"]
            if j.phase is JobPhase.RUNNING:
                break
        assert j.phase is JobPhase.RUNNING, \
            f"gang never started: {j.phase}"
        victim = sorted(p.node_name for p in cluster.pods.values()
                        if p.owner == j.uid)[0]
        victim_slice = cluster.nodes[victim].labels[GPU_CLIQUE_LABEL]

        counts = {k: len(metrics.get_observations(
            f"failover_{k}_seconds", slice=victim_slice))
            for k in ("detect", "drain", "reschedule", "resume",
                      "mttr")}
        provider = FakeUsageProvider()
        agent = NodeAgent(cluster, victim, provider)
        agent.sync()
        fail_host(cluster, victim, provider=provider)
        recovered_at = None
        for i in range(cycle_budget):
            cycle(agent)
            j = cluster.vcjobs["default/train"]
            done = len(metrics.get_observations(
                "failover_mttr_seconds", slice=victim_slice)) \
                > counts["mttr"]
            if done:
                recovered_at = i + 1
                break
        assert recovered_at is not None, (
            f"failover did not complete in {cycle_budget} cycles "
            f"(job {j.phase}, gen "
            f"{j.annotations.get(FAILOVER_GENERATION_ANNOTATION)})")
        assert j.phase is JobPhase.RUNNING
        assert j.annotations.get(FAILOVER_GENERATION_ANNOTATION) == "1"
        new_homes = {cluster.nodes[p.node_name].labels[GPU_CLIQUE_LABEL]
                     for p in cluster.pods.values()
                     if p.owner == j.uid and p.node_name
                     and p.phase in (TaskStatus.BOUND,
                                     TaskStatus.RUNNING)}
        assert victim_slice not in new_homes, \
            f"gang re-landed on the failed slice {victim_slice}"
        cycles_to_recover.append(recovered_at)
        for k in ("detect", "drain", "reschedule", "resume", "mttr"):
            obs = metrics.get_observations(f"failover_{k}_seconds",
                                           slice=victim_slice)
            phases[k].extend(obs[counts[k]:])
        phases["step_gap"].extend(metrics.get_observations(
            "failover_resume_step_gap", slice=victim_slice))
        mgr.stop()

    def pct(vals, q):
        vals = sorted(vals)
        return round(vals[min(len(vals) - 1,
                              int(q * len(vals)))], 4) if vals else None

    out = {
        "hosts": hosts, "gang_hosts": gang, "trials": trials,
        "mttr_p50_s": pct(phases["mttr"], 0.5),
        "mttr_p95_s": pct(phases["mttr"], 0.95),
        "breakdown_p50_s": {
            k: pct(phases[k], 0.5)
            for k in ("detect", "drain", "reschedule", "resume")},
        "breakdown_p95_s": {
            k: pct(phases[k], 0.95)
            for k in ("detect", "drain", "reschedule", "resume")},
        "resume_step_gap_max": (max(phases["step_gap"])
                                if phases["step_gap"] else None),
        "cycles_to_recover": cycles_to_recover,
        "detection_syncs": 3,     # GpuHealthHandler.FAIL_SYNCS
    }
    return out


def failover_smoke() -> int:
    """Seconds-scale failover chaos (tiny shapes) for tier-1: kills
    one fake host and asserts the gang re-reaches Running with a
    bumped failover generation inside the cycle budget — the whole
    detect→drain→reschedule→resume loop guarded on every commit,
    mirroring --wire-smoke.  Prints one JSON line."""
    try:
        out = bench_failover_chaos(smoke=True)
        ok = out["mttr_p50_s"] is not None and \
            all(c <= 40 for c in out["cycles_to_recover"])
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "failover_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- elastic gangs: shrink/grow/migrate as a scheduler decision --------

ELASTIC_CONF = {
    "actions": "enqueue, allocate, elastic, gangpreempt, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "elastic"},
                     {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"},
                     {"name": "deviceshare"},
                     {"name": "network-topology-aware"}]},
    ],
    "configurations": {"elastic": {"elastic.cooldownSeconds": 0}},
}


def _elastic_vcjob(name, slices, lo, hi, pods_per_slice,
                   run_ticks=None):
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    pod_ann = {} if run_ticks is None else \
        {RUN_TICKS_ANNOTATION: str(run_ticks)}
    return VCJob(
        name=name, min_available=slices * pods_per_slice,
        annotations={
            eapi.ELASTIC_MIN_SLICES_ANNOTATION: str(lo),
            eapi.ELASTIC_MAX_SLICES_ANNOTATION: str(hi),
            eapi.ELASTIC_SLICES_ANNOTATION: str(slices),
        },
        plugins={"torch": []},
        tasks=[TaskSpec(name="worker",
                        replicas=slices * pods_per_slice,
                        template=make_pod(
                            "t", requests={"cpu": 8, GPU: 8},
                            annotations=pod_ann))])


def _fixed_vcjob(name, replicas, run_ticks=None):
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    pod_ann = {} if run_ticks is None else \
        {RUN_TICKS_ANNOTATION: str(run_ticks)}
    return VCJob(
        name=name, min_available=replicas,
        tasks=[TaskSpec(name="worker", replicas=replicas,
                        template=make_pod(
                            "t", requests={"cpu": 8, GPU: 8},
                            annotations=pod_ann))])


def _chip_utilization(cluster) -> float:
    """Fraction of the cluster's GPUs held by BOUND/RUNNING pods."""
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.api.types import TaskStatus
    total = used = 0.0
    for node in cluster.nodes.values():
        total += float(Resource.from_resource_list(
            node.allocatable).get(GPU))
    for pod in cluster.pods.values():
        if pod.node_name and pod.phase in (TaskStatus.BOUND,
                                           TaskStatus.RUNNING):
            used += float(pod.resource_requests().get(GPU) or 0)
    return used / total if total else 0.0


def bench_elastic(smoke: bool = False) -> dict:
    """Elastic-gang chaos on a contended cluster:
    fixed gangs pin most slices, elastic jobs absorb EVERY idle slice
    (utilization >= 0.99), a burst of fixed demand forces shrinks
    (latency measured decision -> slices freed), and a live migration
    moves a gang between slices through the same drain/resume path
    (MTTR measured decision -> running on the new slices).  `--elastic`
    adds the dp-resize loss-continuity dryrun (--elastic-child)."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.types import JobPhase, GPU_CLIQUE_LABEL
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.webhooks import default_admission

    slice_kind = "h100-4x8" if smoke else "h100-64x8"   # 4 / 64 hosts
    n_slices = 4 if smoke else 16                   # 16 / 1024 hosts
    pods_per_slice = 4 if smoke else 64
    n_fixed = 1 if smoke else 10
    n_elastic = 1 if smoke else 2
    elastic_start = 1 if smoke else 2
    trials = 1 if smoke else 5
    cycle_budget = 60

    shrink_lat, grow_lat, migrate_lat = [], [], []
    utilizations, grow_cycles = [], []
    hosts = None
    for trial in range(trials):
        cluster = make_domain_cluster(
            [(f"t{trial}s{i:02d}", slice_kind)
             for i in range(n_slices)])
        cluster.admission = default_admission()
        hosts = len(cluster.nodes)
        mgr = ControllerManager(cluster, enabled=[
            "job", "podgroup", "queue", "failover", "elastic"])
        sched = Scheduler(cluster, conf=ELASTIC_CONF,
                          schedule_period=0)

        def cycle(n=1):
            for _ in range(n):
                mgr.sync_all()
                sched.run_once()
                cluster.tick()

        def job_slices(name):
            j = cluster.vcjobs[f"default/{name}"]
            return sorted({
                cluster.nodes[p.node_name].labels[GPU_CLIQUE_LABEL]
                for p in cluster.pods.values()
                if p.owner == j.uid and p.node_name})

        # fixed load pins most of the cluster; elastic jobs start
        # small — the leftover slices are the utilization gap
        grow0 = len(metrics.get_observations("elastic_resize_seconds",
                                             kind="grow"))
        for i in range(n_fixed):
            cluster.add_vcjob(_fixed_vcjob(f"fixed-{i}",
                                           pods_per_slice))
        for i in range(n_elastic):
            cluster.add_vcjob(_elastic_vcjob(
                f"elastic-{i}", elastic_start, 1, n_slices,
                pods_per_slice))

        # phase 1: place everything, grow until every GPU is busy
        util = 0.0
        for i in range(cycle_budget):
            cycle()
            util = _chip_utilization(cluster)
            if util >= 0.99:
                grow_cycles.append(i + 1)
                break
        assert util >= 0.99, \
            f"elastic growth stalled at utilization {util:.3f}"
        utilizations.append(round(util, 4))
        # the grow EPISODE resumes (pods running) a cycle or two
        # after utilization peaks (pods bound): settle before reading
        # the latency observations
        for _ in range(cycle_budget):
            if len(metrics.get_observations(
                    "elastic_resize_seconds", kind="grow")) > grow0:
                break
            cycle()
        grow_lat.extend(metrics.get_observations(
            "elastic_resize_seconds", kind="grow")[grow0:])

        # phase 2: burst fixed demand -> shrink frees the slices
        shrink0 = len(metrics.get_observations(
            "elastic_shrink_seconds"))
        burst = 1 if smoke else 2
        for i in range(burst):
            cluster.add_vcjob(_fixed_vcjob(
                f"burst-{i}", pods_per_slice, run_ticks=24))
        for i in range(cycle_budget):
            cycle()
            if all(cluster.vcjobs[f"default/burst-{i}"].phase
                   is JobPhase.RUNNING for i in range(burst)):
                break
        assert all(cluster.vcjobs[f"default/burst-{i}"].phase
                   is JobPhase.RUNNING for i in range(burst)), \
            "burst gangs never scheduled (shrink did not free slices)"
        assert not cluster.evictions, \
            f"shrink path evicted pods: {cluster.evictions[:4]}"
        shrink_lat.extend(metrics.get_observations(
            "elastic_shrink_seconds")[shrink0:])

        # phase 3: the burst completes, then live-migrate one gang
        # onto the freed slices (policy-initiated, same drain path)
        for i in range(cycle_budget):
            cycle()
            if all(cluster.vcjobs[f"default/burst-{i}"].phase
                   is JobPhase.COMPLETED for i in range(burst)):
                break
        mig0 = len(metrics.get_observations(
            "elastic_migration_mttr_seconds"))
        victim = "elastic-0"
        old_homes = job_slices(victim)
        pg = cluster.podgroups[f"default/{victim}"]
        pg.annotations[eapi.ELASTIC_DESIRED_SLICES_ANNOTATION] = \
            str(eapi.current_slices(pg))
        pg.annotations[eapi.ELASTIC_RESIZE_REASON_ANNOTATION] = \
            eapi.RESIZE_MIGRATE
        pg.annotations[eapi.ELASTIC_AVOID_SLICES_ANNOTATION] = \
            ",".join(old_homes)
        for i in range(cycle_budget):
            cycle()
            if len(metrics.get_observations(
                    "elastic_migration_mttr_seconds")) > mig0:
                break
        new_homes = job_slices(victim)
        assert not (set(new_homes) & set(old_homes)), \
            f"migration landed back on {old_homes}"
        migrate_lat.extend(metrics.get_observations(
            "elastic_migration_mttr_seconds")[mig0:])
        mgr.stop()

    def pct(vals, q):
        vals = sorted(vals)
        return round(vals[min(len(vals) - 1,
                              int(q * len(vals)))], 4) if vals else None

    return {
        "hosts": hosts, "slices": n_slices,
        "pods_per_slice": pods_per_slice, "trials": trials,
        "fixed_jobs": n_fixed, "elastic_jobs": n_elastic,
        "utilization": min(utilizations),
        "utilization_target": 0.99,
        "grow_cycles_to_full": grow_cycles,
        "grow_latency_p50_s": pct(grow_lat, 0.5),
        "grow_latency_p95_s": pct(grow_lat, 0.95),
        "shrink_latency_p50_s": pct(shrink_lat, 0.5),
        "shrink_latency_p95_s": pct(shrink_lat, 0.95),
        "migration_mttr_p50_s": pct(migrate_lat, 0.5),
        "migration_mttr_p95_s": pct(migrate_lat, 0.95),
        "shrink_samples": len(shrink_lat),
        "migration_samples": len(migrate_lat),
        "evictions": 0,
    }


# the dp-resize dryrun's shape: the tiny f32 model, global batch 4 x 64,
# 5 steps at dp 2 x fsdp 2 x tp 2, a checkpoint after step 3, steps 4-5
# again at dp 1 x fsdp 2 x tp 2
ELASTIC_AXES_BEFORE = {"dp": 2, "fsdp": 2, "tp": 2, "sp": 1}
ELASTIC_AXES_AFTER = {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1}
ELASTIC_STEPS, ELASTIC_SAVE_STEP = 5, 3
ELASTIC_BATCH, ELASTIC_SEQ = 4, 64


def _elastic_init(path, cfg, mesh):
    """(params, tokens) of the dryrun: from `path` (an .npz of the
    reference's params, flattened as `blocks.<i>.<name>`, and `tokens`)
    when given, else params from torch seed 0 and tokens from seed 1."""
    import numpy as np
    import torch

    from volcano_tpu_torch.workloads import convert
    from volcano_tpu_torch.workloads import model as model_lib
    from volcano_tpu_torch.workloads import train
    if not path:
        params = model_lib.distribute(model_lib.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), mesh)
        batch = train.synthetic_batch(torch.Generator().manual_seed(1), cfg,
                                      ELASTIC_BATCH, ELASTIC_SEQ, mesh)
        return params, batch
    data = dict(np.load(path))
    tree = {k: data[k] for k in ("embed", "final_norm", "head")}
    tree["blocks"] = [
        {k.split(".")[2]: v for k, v in data.items()
         if k.startswith(f"blocks.{i}.")} for i in range(cfg.n_layers)]
    params = convert.params_from_jax(tree, device="cpu", mesh=mesh)
    tokens = torch.from_numpy(data["tokens"]).long()
    tokens = tokens[train.batch_sharding(mesh).rows(len(tokens))]
    return params, {"tokens": tokens.contiguous()}


def _elastic_rank(rank, n, port, phase, ckpt, init, out):
    """One gloo rank of the dryrun; puts ("ok", rank, losses by step,
    start step) or ("error", rank, traceback) on `out`."""
    import os
    import traceback

    import torch

    from volcano_tpu_torch.workloads import bootstrap, checkpoint
    from volcano_tpu_torch.workloads import model as model_lib
    from volcano_tpu_torch.workloads import train
    from volcano_tpu_torch.workloads.mesh import make_mesh
    try:
        torch.set_num_threads(1)
        os.environ[bootstrap.ENV_AGENT_STORE] = "True"
        bootstrap.initialize(
            {"TPU_WORKER_ID": str(rank), "NUM_PROCESSES": str(n),
             "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "LOCAL_RANK": str(rank)}, device="cpu")
        try:
            before = phase == "before"
            mesh = make_mesh(ELASTIC_AXES_BEFORE if before
                             else ELASTIC_AXES_AFTER, "cpu")
            cfg = model_lib.tiny_config()
            opt = train.make_optimizer(lr=1e-2, warmup_steps=1)
            params, batch = _elastic_init(init, cfg, mesh)
            state = opt.init(params)
            start = 0
            if not before:
                params, state, start = checkpoint.resume_state(
                    params, state, environ={
                        bootstrap.ENV_CHECKPOINT_DIR: ckpt,
                        bootstrap.ENV_RESUME_STEP: str(ELASTIC_SAVE_STEP)})
            step_fn = train.make_train_step(cfg, opt, mesh)
            losses = {}
            for step in range(start + 1, ELASTIC_STEPS + 1):
                params, state, m = step_fn(params, state, batch)
                losses[step] = float(m["loss"])
                if before and step == ELASTIC_SAVE_STEP:
                    checkpoint.save(ckpt, step=step, params=params,
                                    opt_state=state)
        finally:
            bootstrap.shutdown()
        out.put(("ok", rank, (losses, start)))
    except BaseException:  # reported to the parent, which raises
        out.put(("error", rank, traceback.format_exc()))
        raise


def _elastic_phase(phase, n, ckpt, init, timeout_s=300.0):
    """Run one phase of the dryrun on n gloo ranks of this host, which
    meet at a store this process holds; rank 0's (losses, start)."""
    import queue

    import torch.multiprocessing as mp

    from volcano_tpu_torch.workloads import bootstrap
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = bootstrap.local_store()
    procs = [ctx.Process(target=_elastic_rank,
                         args=(r, n, store.port, phase, ckpt, init, out))
             for r in range(n)]
    for p in procs:
        p.start()
    result, errors = None, []
    try:
        for _ in range(n):
            kind, rank, payload = out.get(timeout=timeout_s)
            if kind == "error":
                errors.append(f"rank {rank}:\n{payload}")
            elif rank == 0:
                result = payload
    except queue.Empty:
        errors.append(f"not every rank reported within {timeout_s:g} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or result is None:
        raise RuntimeError(f"elastic dryrun ({phase}) failed:\n"
                           + "\n".join(errors))
    return result


def _elastic_child(init: str = ""):
    """The dp-resize loss-continuity dryrun, on the CPU as the
    reference's is (8 then 4 gloo ranks here, 8 then 4 virtual CPU
    devices there): a dryrun of the resize path, not a fallback from
    the card.  Train at dp=2 over 8 ranks with a fixed global batch,
    save a DCP checkpoint, resume at dp=1 over 4 ranks, compare the
    post-resize losses against the fixed-size trajectory.  `init`: an
    .npz of initial params and tokens (`_elastic_init`).  Prints ONE
    JSON line."""
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="elastic-ckpt-")
    try:
        losses, _ = _elastic_phase("before", 8, ckpt, init)
        after, start = _elastic_phase("after", 4, ckpt, init)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    diffs = [abs(after[step] - losses[step]) / max(abs(losses[step]), 1e-9)
             for step in range(start + 1, ELASTIC_STEPS + 1)]
    out = {
        "world_before_devices": 8, "world_after_devices": 4,
        "dp_before": 2, "dp_after": 1, "global_batch": ELASTIC_BATCH,
        "resume_step": start,
        "resume_step_never_rewinds": start == ELASTIC_SAVE_STEP,
        "max_rel_loss_diff": round(max(diffs), 8),
        "tolerance": 1e-3,
        "loss_continuous": start == ELASTIC_SAVE_STEP and max(diffs) < 1e-3,
        "losses_before": [losses[s] for s in sorted(losses)],
        "losses_after": [after[s] for s in sorted(after)],
    }
    print(json.dumps(out), flush=True)


def _run_elastic_child(timeout_s: float = 600.0) -> dict:
    """Run --elastic-child in a subprocess (8 then 4 gloo ranks)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench",
         "--elastic-child"],
        capture_output=True, text=True, timeout=timeout_s, env=env,
        cwd=repo)
    for line in reversed((proc.stdout or "").strip().splitlines()
                         or [""]):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return {"loss_continuous": False,
            "error": (proc.stderr or "no output")[-500:]}


def bench_elastic_wire_smoke() -> dict:
    """One grow + one shrink through the REAL process control plane
    (state server + scheduler + controllers as OS processes) — the
    tier-1 guard that the elastic loop works over the wire, not just
    in-process."""
    import os

    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.types import JobPhase
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    plane = _WirePlane()
    # the scheduler process needs the elastic action + zero cooldown
    conf_path = os.path.join(plane.logdir, "elastic-conf.yaml")
    with open(conf_path, "w") as f:
        json.dump(ELASTIC_CONF, f)     # JSON is valid YAML
    kubectl = None
    try:
        plane.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port), "--tick-period", "0.05")
        import urllib.request

        def up():
            try:
                with urllib.request.urlopen(plane.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        plane.spawn("controllers", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "controllers", "--period", "0.05")
        plane.spawn("scheduler", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "scheduler", "--period", "0.05",
                    "--conf", conf_path)
        kubectl = RemoteCluster(plane.url)
        for i in range(3):
            for node in domain_nodes(domain_for(f"s{i}", "h100-4x8"),
                                    ib_fabric="ib-0"):
                kubectl.add_node(node)

        kubectl.add_vcjob(_fixed_vcjob("pin", 4))
        kubectl.add_vcjob(_elastic_vcjob("egang", 1, 1, 2, 4))

        def gen_at_least(n):
            pg = kubectl.podgroups.get("default/egang")
            j = kubectl.vcjobs.get("default/egang")
            return (pg is not None and j is not None
                    and j.phase is JobPhase.RUNNING
                    and int(pg.annotations.get(
                        eapi.ELASTIC_GENERATION_ANNOTATION, 0)) >= n)

        # grow: the idle third slice is absorbed
        _wire_wait(lambda: gen_at_least(1)
                   and eapi.current_slices(
                       kubectl.podgroups["default/egang"]) == 2,
                   60, lambda: "elastic grow over the wire "
                   f"({plane.log_tails()[-900:]})")
        grow_ok = True
        util_at_grow = _chip_utilization(kubectl)

        # shrink: new fixed demand reclaims the slice
        kubectl.add_vcjob(_fixed_vcjob("burst", 4))
        _wire_wait(lambda: gen_at_least(2)
                   and eapi.current_slices(
                       kubectl.podgroups["default/egang"]) == 1
                   and (kubectl.vcjobs.get("default/burst") is not None
                        and kubectl.vcjobs["default/burst"].phase
                        is JobPhase.RUNNING),
                   60, lambda: "elastic shrink over the wire "
                   f"({plane.log_tails()[-900:]})")
        shrink_ok = True
        pg = kubectl.podgroups["default/egang"]
        hist = eapi.resize_history(pg)
        return {
            "grow_ok": grow_ok, "shrink_ok": shrink_ok,
            "utilization": round(util_at_grow, 4),
            "resize_history": hist[-2:],
            "hosts": 12,
        }
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def elastic_smoke() -> int:
    """Seconds-scale elastic drill for tier-1: one grow + one shrink
    through the real process control plane, mirroring --wire-smoke /
    --failover-smoke.  Prints one JSON line."""
    try:
        out = bench_elastic_wire_smoke()
        ok = out["grow_ok"] and out["shrink_ok"]
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "elastic_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- goodput observatory -------------------------------------


def _post_job_reports(cluster, job_name, rate, ts, ledger, dt=1.0,
                      productive_frac=1.0, step=0):
    """Simulate the agent fleet for one gang: one GoodputReport per
    hosting node, entries carrying the simulated step rate and the
    CUMULATIVE per-pod ledger (*ledger*: uid -> (alloc, prod),
    advanced by one dt window per call — the store diffs against the
    node's previous report exactly as it would for real agents)."""
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api.types import TaskStatus
    j = cluster.vcjobs[f"default/{job_name}"]
    by_node = {}
    for p in cluster.pods.values():
        if p.owner == j.uid and p.node_name and \
                p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING):
            by_node.setdefault(p.node_name, []).append(p)
    for node, pods in by_node.items():
        gen = gapi.generation_of(cluster.nodes[node].labels)
        usages = []
        for p in pods:
            alloc, prod = ledger.get(p.uid, (0.0, 0.0))
            alloc += dt
            prod += dt * productive_frac
            ledger[p.uid] = (alloc, prod)
            usages.append(gapi.PodGoodput(
                pod_key=p.key, uid=p.uid, job=f"default/{job_name}",
                generation=gen, step=step,
                steps_per_s=round(rate, 4),
                goodput=productive_frac,
                allocated_s=round(alloc, 4),
                productive_s=round(prod, 4)))
        cluster.put_object("goodputreport", gapi.GoodputReport(
            node=node, ts=ts, usages=usages))
    return len(by_node)


def bench_goodput(smoke: bool = False) -> dict:
    """Goodput observatory acceptance, three claims in
    one row:

      1. learned per-(job, generation) throughput vectors converge to
         the simulator's ground-truth step rates within 10% on a
         1k-host contended cluster with deliberately heterogeneous
         rates (h100 vs h200 generations, per-job multipliers);
      2. the goodput ledger (REAL GoodputCollector over a synthetic
         progress filesystem with an injected clock) reconciles with
         wall-clock allocated time within 5% across a stall + a
         resize-epoch restart;
      3. gating elastic grow on measured marginal throughput (the
         minimal Pollux step) lifts aggregate ground-truth steps/s
         vs greedy absorption on the same scenario.
    """
    import time as _time

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api.types import JobPhase
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.webhooks import default_admission

    # -- phase 1: vector convergence at scale --------------------------
    n_per_gen = 2 if smoke else 8
    kinds = ("h100-4x8", "h200-32x8") if smoke else ("h100-64x8", "h200-64x8")
    pods_per_job = 4 if smoke else 64
    # more jobs than one generation holds, so placement spreads the
    # fleet across BOTH generations and the learned vectors prove the
    # per-generation split (h200 ground truth is 2.2x h100)
    n_jobs = 2 if smoke else 10
    rounds = 6
    cluster = make_domain_cluster(
        [(f"e{i:02d}", kinds[0]) for i in range(n_per_gen)]
        + [(f"p{i:02d}", kinds[1]) for i in range(n_per_gen)])
    cluster.admission = default_admission()
    hosts = len(cluster.nodes)
    sched = Scheduler(cluster, schedule_period=0)
    mgr = ControllerManager(cluster, enabled=["job", "podgroup",
                                              "queue"])
    for j in range(n_jobs):
        cluster.add_vcjob(_fixed_vcjob(f"gp-{j}", pods_per_job))
    for _ in range(20):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
        if all(cluster.vcjobs[f"default/gp-{j}"].phase
               is JobPhase.RUNNING for j in range(n_jobs)):
            break
    assert all(cluster.vcjobs[f"default/gp-{j}"].phase
               is JobPhase.RUNNING for j in range(n_jobs)), \
        "goodput bench jobs never all ran"

    # deliberately heterogeneous ground truth: per-job base rate,
    # h200 2.2x faster than h100 — the vector the estimator must learn
    def gt_rate(j, gen):
        base = 5.0 + 2.0 * j
        return base * (2.2 if gen == "h200" else 1.0)

    def job_generation(j):
        jj = cluster.vcjobs[f"default/gp-{j}"]
        for p in cluster.pods.values():
            if p.owner == jj.uid and p.node_name:
                return gapi.generation_of(
                    cluster.nodes[p.node_name].labels)
        return "other"

    rng = random.Random(11)
    dt = 1.0
    ledger = {}
    for r in range(rounds):
        for j in range(n_jobs):
            gen = job_generation(j)
            noisy = gt_rate(j, gen) * rng.uniform(0.97, 1.03)
            _post_job_reports(cluster, f"gp-{j}", noisy,
                              ts=1000.0 + r, ledger=ledger, dt=dt,
                              step=10 * (r + 1))
    book = sched.cache.goodput_book
    vec_errs = []
    for j in range(n_jobs):
        gen = job_generation(j)
        learned = book.vector(f"default/gp-{j}").get(gen, 0.0)
        truth = gt_rate(j, gen)
        vec_errs.append(abs(learned - truth) / truth)
    vector_max_rel_err = round(max(vec_errs), 4)
    assert vector_max_rel_err < 0.10, \
        f"learned vectors off by {vector_max_rel_err}"

    # the scale-side ledger: every pod contributed dt per round; the
    # accumulated podgroup ledger must equal pods x rounds x dt
    ledger_errs = []
    for j in range(n_jobs):
        pg = cluster.podgroups[f"default/gp-{j}"]
        acc = gapi.ann_float(pg.annotations,
                             gapi.PG_ALLOCATED_S_ANNOTATION)
        want = pods_per_job * rounds * dt
        ledger_errs.append(abs(acc - want) / want)
    ssn = sched.run_once()          # export the session gauges
    fleet_rate = metrics.get_gauge("goodput_fleet_steps_per_second")
    mgr.stop()

    # -- phase 2: ledger vs wall clock (REAL collector, fake clock) ----
    import tempfile

    from volcano_tpu_torch.agent.collect import GoodputCollector
    from volcano_tpu_torch.workloads.progress import ProgressReporter
    root = tempfile.mkdtemp(prefix="goodput-bench-")
    t = [0.0]
    col = GoodputCollector(root, now=lambda: t[0])
    n_pods = 4

    def write(uid, step, epoch):
        ProgressReporter(gapi.progress_file_for(root, uid),
                         epoch=epoch,
                         now=lambda: t[0]).report(step=step)

    # timeline per pod: 60s stepping at 1 step/s, 20s stalled
    # (drain), epoch bump + resume from the checkpoint floor (step
    # 30), 40s stepping — sampled every 2s like an agent sync
    for uid in range(n_pods):
        write(f"u{uid}", 0, 0)
    col.collect("n0")
    while t[0] < 120.0:
        t[0] += 2.0
        for uid in range(n_pods):
            if t[0] <= 60.0:
                write(f"u{uid}", int(t[0]), 0)
            elif t[0] <= 80.0:
                pass                      # stalled: file untouched
            else:
                write(f"u{uid}", 30 + int(t[0] - 80), 1)
        col.collect("n0")
    wall_alloc = 120.0 * n_pods
    acc_alloc = sum(st.allocated_s for st in col.rates().values())
    acc_prod = sum(st.productive_s for st in col.rates().values())
    reconcile_err = abs(acc_alloc - wall_alloc) / wall_alloc
    # expected productive: 60s stepping + 40s resumed, minus the one
    # post-epoch boundary window that earns no credit
    expected_prod = (60.0 + 40.0 - 2.0) * n_pods
    goodput_err = abs(acc_prod - expected_prod) / expected_prod
    assert reconcile_err < 0.05, \
        f"ledger {acc_alloc} vs wall {wall_alloc}"
    assert goodput_err < 0.05, \
        f"productive {acc_prod} vs expected {expected_prod}"
    rate_after = max(st.steps_per_s for st in col.rates().values())
    assert rate_after <= 1.1, \
        f"post-restart rate spiked to {rate_after}"

    # -- phase 3: goodput-gated grow vs greedy absorption --------------
    def run_grow_scenario(gate_on: bool):
        slice_kind = "h100-4x8"
        conf = json.loads(json.dumps(ELASTIC_CONF))
        conf["configurations"]["elastic"][
            "elastic.goodputGateGrow"] = "true" if gate_on else "false"
        from volcano_tpu_torch.cache.cluster import PriorityClass
        c = make_domain_cluster([(f"g{i}", slice_kind) for i in range(4)])
        c.admission = default_admission()
        m = ControllerManager(c, enabled=["job", "podgroup", "queue",
                                          "failover", "elastic"])
        s = Scheduler(c, conf=conf, schedule_period=0)
        # the bad scaler outranks the good one in job order (priority
        # class), so GREEDY absorption always hands it the next idle
        # slice — only the measured-throughput gate redirects capacity
        c.add_priority_class(PriorityClass(name="hot", value=1000))
        bad = _elastic_vcjob("bad", 1, 1, 3, 4)
        bad.priority_class = "hot"
        c.add_vcjob(bad)
        c.add_vcjob(_elastic_vcjob("good", 1, 1, 3, 4))
        c.add_vcjob(_fixed_vcjob("pin-a", 4, run_ticks=8))
        c.add_vcjob(_fixed_vcjob("pin-b", 4, run_ticks=30))

        def rate_of(name, slices):
            # bad: near-flat scaling; good: linear
            return 10.0 * (slices ** 0.1) if name == "bad" \
                else 10.0 * slices

        ts = [2000.0]
        run_ledger = {}
        for cycle in range(120):
            m.sync_all()
            s.run_once()
            c.tick()
            ts[0] += 1.0
            for name in ("bad", "good"):
                pg = c.podgroups.get(f"default/{name}")
                jj = c.vcjobs.get(f"default/{name}")
                if pg is None or jj is None or \
                        jj.phase is not JobPhase.RUNNING:
                    continue
                cur = eapi.current_slices(pg)
                _post_job_reports(c, name, rate_of(name, cur),
                                  ts=ts[0], ledger=run_ledger,
                                  step=cycle)
            if c.vcjobs["default/pin-b"].phase is JobPhase.COMPLETED \
                    and cycle > 60:
                break
        sizes = {name: eapi.current_slices(
            c.podgroups[f"default/{name}"]) for name in ("bad",
                                                         "good")}
        agg = sum(rate_of(name, n) for name, n in sizes.items())
        m.stop()
        return sizes, round(agg, 3)

    gated_sizes, gated_agg = run_grow_scenario(gate_on=True)
    greedy_sizes, greedy_agg = run_grow_scenario(gate_on=False)
    lift = round(gated_agg / greedy_agg, 4) if greedy_agg else None
    assert lift and lift > 1.0, \
        f"goodput gating did not beat greedy: {gated_agg} vs " \
        f"{greedy_agg} ({gated_sizes} vs {greedy_sizes})"

    return {
        "hosts": hosts,
        "generations": sorted({job_generation(j)
                               for j in range(n_jobs)}),
        "jobs": n_jobs, "report_rounds": rounds,
        "vector_max_rel_err": vector_max_rel_err,
        "vector_err_target": 0.10,
        "ledger_scale_max_rel_err": round(max(ledger_errs), 6),
        "fleet_steps_per_second_gauge": round(fleet_rate, 3),
        "reconcile": {
            "pods": n_pods,
            "allocated_wall_s": wall_alloc,
            "allocated_accounted_s": round(acc_alloc, 3),
            "rel_err": round(reconcile_err, 6),
            "target": 0.05,
            "productive_accounted_s": round(acc_prod, 3),
            "productive_expected_s": expected_prod,
            "goodput_measured": round(acc_prod / acc_alloc, 4),
            "post_restart_rate_max": round(rate_after, 4),
        },
        "grow_gating": {
            "gated_slices": gated_sizes,
            "greedy_slices": greedy_sizes,
            "gated_agg_steps_per_s": gated_agg,
            "greedy_agg_steps_per_s": greedy_agg,
            "aggregate_lift": lift,
        },
    }


def bench_goodput_wire_smoke() -> dict:
    """Worker progress files -> REAL agent collector/handler ->
    GoodputReport over the wire -> store fold -> podgroup annotations,
    through the real process control plane (state server + scheduler +
    controllers as OS processes) — the tier-1 guard that the goodput
    stream works over the wire, not just in-process."""
    import os
    import time as _time

    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.agent.collect import GoodputCollector
    from volcano_tpu_torch.agent.handlers import GoodputHandler
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import JobPhase, TaskStatus
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    plane = _WirePlane()
    kubectl = None
    agents = []
    try:
        plane.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port), "--tick-period", "0.05")
        import urllib.request

        def up():
            try:
                with urllib.request.urlopen(plane.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        plane.spawn("controllers", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "controllers", "--period", "0.05")
        plane.spawn("scheduler", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "scheduler", "--period", "0.05")
        kubectl = RemoteCluster(plane.url)
        for node in domain_nodes(domain_for("sa", "h100-4x8"),
                                ib_fabric="ib-0"):
            kubectl.add_node(node)

        progress_dir = os.path.join(plane.logdir, "progress")
        os.makedirs(progress_dir, exist_ok=True)
        kubectl.add_vcjob(VCJob(
            name="gp", min_available=4,
            annotations={gapi.PROGRESS_DIR_ANNOTATION: progress_dir},
            plugins={"torch": []},
            tasks=[TaskSpec(name="worker", replicas=4,
                            template=make_pod(
                                "t", requests={"cpu": 4, GPU: 8}))]))

        def workers_running():
            j = kubectl.vcjobs.get("default/gp")
            if j is None or j.phase is not JobPhase.RUNNING:
                return False
            pods = [p for p in kubectl.pods.values()
                    if p.owner == j.uid
                    and p.phase is TaskStatus.RUNNING and p.node_name]
            return len(pods) == 4
        _wire_wait(workers_running, 60,
                   lambda: "goodput smoke workers never ran "
                   f"({plane.log_tails()[-900:]})")

        j = kubectl.vcjobs["default/gp"]
        pods = [p for p in kubectl.pods.values() if p.owner == j.uid]
        env_ok = all(
            gapi.ENV_PROGRESS_FILE in p.containers[0].env
            for p in pods)

        # one REAL agent per host, sharing the collector over the
        # progress root (each handler pairs only its node's pods)
        col = GoodputCollector(progress_dir)
        for p in sorted(pods, key=lambda p: p.node_name):
            agents.append(NodeAgent(
                kubectl, p.node_name, FakeUsageProvider(),
                handlers=[GoodputHandler], goodput_collector=col))

        step = 0
        for _ in range(8):
            step += 2
            for p in pods:
                ProgressReporterFor(progress_dir, p.uid, step)
            for a in agents:
                a.sync()
            _time.sleep(0.25)

        def folded():
            pg = kubectl.podgroups.get("default/gp")
            return pg is not None and \
                gapi.ann_float(pg.annotations,
                               gapi.PG_STEP_RATE_ANNOTATION) > 0
        _wire_wait(folded, 30,
                   lambda: "goodput fold never reached the podgroup "
                   f"({plane.log_tails()[-900:]})")
        pg = kubectl.podgroups["default/gp"]
        ann = pg.annotations
        return {
            "fold_ok": True,
            "env_ok": env_ok,
            "steps_per_s": gapi.ann_float(
                ann, gapi.PG_STEP_RATE_ANNOTATION),
            "step": int(gapi.ann_float(ann, gapi.PG_STEP_ANNOTATION)),
            "goodput": gapi.ann_float(ann, gapi.PG_GOODPUT_ANNOTATION),
            "allocated_pod_s": gapi.ann_float(
                ann, gapi.PG_ALLOCATED_S_ANNOTATION),
            "reports": len(getattr(kubectl, "goodputreports", {})),
            "generation": ann.get(gapi.PG_GENERATION_ANNOTATION, ""),
            "hosts": 4,
        }
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def ProgressReporterFor(root, uid, step):
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.workloads.progress import ProgressReporter
    ProgressReporter(gapi.progress_file_for(root, uid)).report(
        step=step, examples=step * 32.0)


def goodput_smoke() -> int:
    """Seconds-scale goodput drill for tier-1: progress files ->
    real agents -> wire -> fold, mirroring --wire-smoke /
    --elastic-smoke.  Prints one JSON line."""
    try:
        out = bench_goodput_wire_smoke()
        ok = (out["fold_ok"] and out["env_ok"]
              and out["steps_per_s"] > 0 and 0 < out["goodput"] <= 1
              and out["step"] > 0)
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "goodput_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- inference serving plane --------------------------------


SERVE_CONF = {
    "actions": "enqueue, allocate, elastic, gangpreempt, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "elastic"},
                     {"name": "serving"}, {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"},
                     {"name": "deviceshare"},
                     {"name": "network-topology-aware"}]},
    ],
    # unlike ELASTIC_CONF this plane wants a real cooldown: a serving
    # gang the autoscaler just grew must not be handed back by
    # shrink-pending-to-fit one session later
    "configurations": {"elastic": {"elastic.cooldownSeconds": 5}},
}


def _serving_vcjob(name, slices, lo, hi, pods_per_slice, stats_dir,
                   slo_ms=50.0, target_qps=100.0):
    """Serving replica group = elastic gang + the SLO contract
    (api/serving.py): min/max replicas ride the elastic min/max-slices
    annotations, one slice per replica."""
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import serving as sapi
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    return VCJob(
        name=name, min_available=slices * pods_per_slice,
        annotations={
            sapi.SLO_P99_MS_ANNOTATION: str(slo_ms),
            sapi.MIN_REPLICAS_ANNOTATION: str(lo),
            sapi.MAX_REPLICAS_ANNOTATION: str(hi),
            sapi.TARGET_QPS_ANNOTATION: str(target_qps),
            sapi.STATS_DIR_ANNOTATION: stats_dir,
            eapi.ELASTIC_MIN_SLICES_ANNOTATION: str(lo),
            eapi.ELASTIC_MAX_SLICES_ANNOTATION: str(hi),
            eapi.ELASTIC_SLICES_ANNOTATION: str(slices),
        },
        plugins={"torch": []},
        tasks=[TaskSpec(name="replica",
                        replicas=slices * pods_per_slice,
                        template=make_pod(
                            "s", requests={"cpu": 8, GPU: 8}))])


def _serve_pool_tiers(kubectl, pool, gang_slices):
    """min hypernode-LCA tier between a gang's slices and the serving
    pool — the bench-side replica of the scheduler's victim score
    (actions/elastic.py), computed from the SAME hypernode objects so
    the adjacency assertion audits the scheduler from outside."""
    from volcano_tpu_torch.api.hypernode import HyperNodesInfo
    hni = HyperNodesInfo(kubectl.hypernodes.values(),
                         real_nodes=list(kubectl.nodes.keys()))
    best = None
    for gs in gang_slices:
        for ps in pool:
            if gs in hni.members and ps in hni.members:
                tier = hni.lca_tier_of_leaves(gs, ps)
            else:
                tier = 99
            best = tier if best is None else min(best, tier)
    return 99 if best is None else best


def _job_slices_now(kubectl, job_key):
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL, TaskStatus
    j = kubectl.vcjobs.get(job_key)
    if j is None:
        return []
    out = set()
    for p in kubectl.pods.values():
        if p.owner == j.uid and p.node_name \
                and p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING) \
                and p.node_name in kubectl.nodes:
            s = kubectl.nodes[p.node_name].labels.get(GPU_CLIQUE_LABEL)
            if s:
                out.add(s)
    return sorted(out)


def bench_serving_wire_smoke() -> dict:
    """Traffic step -> replica stats -> REAL agents -> wire -> store
    fold -> autoscaler scale-up -> topology-aware burst preemption
    (the training gang shrinks, steered off the freed block) through
    the REAL process control plane — the tier-1 guard that the
    serving loop works over the wire, not just in-process."""
    import os
    import time as _time

    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.agent.collect import ServingCollector
    from volcano_tpu_torch.agent.handlers import ServingHandler
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import serving as sapi
    from volcano_tpu_torch.api.types import JobPhase, TaskStatus
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes
    from volcano_tpu_torch.workloads.serve import ServingStatsReporter

    plane = _WirePlane()
    conf_path = os.path.join(plane.logdir, "serve-conf.yaml")
    with open(conf_path, "w") as f:
        json.dump(SERVE_CONF, f)     # JSON is valid YAML
    kubectl = None
    agents = {}
    try:
        plane.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port), "--tick-period", "0.05")
        import urllib.request

        def up():
            try:
                with urllib.request.urlopen(plane.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        plane.spawn("controllers", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "controllers", "--period", "0.05")
        plane.spawn("scheduler", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "scheduler", "--period", "0.05",
                    "--conf", conf_path)
        kubectl = RemoteCluster(plane.url)
        # sa/sb share the serving IB fabric, sc sits across the IB tier —
        # the distance differential the victim score ranks on
        for sname, fabric in (("sa", "ib-0"), ("sb", "ib-0"),
                           ("sc", "ib-1")):
            for node in domain_nodes(domain_for(sname, "h100-4x8"),
                                    ib_fabric=fabric):
                kubectl.add_node(node)

        stats_dir = os.path.join(plane.logdir, "serving")
        os.makedirs(stats_dir, exist_ok=True)
        kubectl.add_vcjob(_serving_vcjob(
            "infer", 1, 1, 2, 4, stats_dir, slo_ms=50.0,
            target_qps=100.0))
        kubectl.add_vcjob(_elastic_vcjob("train", 2, 1, 2, 4))

        def running(jname, want):
            j = kubectl.vcjobs.get(f"default/{jname}")
            if j is None or j.phase is not JobPhase.RUNNING:
                return False
            return sum(1 for p in kubectl.pods.values()
                       if p.owner == j.uid and p.node_name
                       and p.phase is TaskStatus.RUNNING) >= want
        _wire_wait(lambda: running("infer", 4) and running("train", 8),
                   60, lambda: "serve smoke gangs never ran "
                   f"({plane.log_tails()[-900:]})")

        j = kubectl.vcjobs["default/infer"]
        env_ok = all(
            sapi.ENV_STATS_FILE in p.containers[0].env
            for p in kubectl.pods.values() if p.owner == j.uid)

        col = ServingCollector(stats_dir)
        served = {"n": 0.0}
        pod_req = {}                 # uid -> cumulative requests
        flags = {"victim_marker": False, "victim_avoid": []}

        def feed(qps, dt):
            """One replica beat: the offered rate split across the
            group's pods (each replica serves its share, as a load
            balancer would spread it), cumulative stats -> REAL
            per-host agents -> ServingReport over the wire.  The
            store folds the group QPS back as the SUM of the shares."""
            served["n"] += qps * dt
            pg = kubectl.podgroups.get("default/infer")
            sj = kubectl.vcjobs.get("default/infer")
            if pg is None or sj is None:
                return
            epoch = int(pg.annotations.get(
                eapi.ELASTIC_GENERATION_ANNOTATION, 0) or 0)
            pods = [p for p in kubectl.pods.values()
                    if p.owner == sj.uid and p.node_name
                    and p.phase is TaskStatus.RUNNING]
            for p in pods:
                pod_req[p.uid] = pod_req.get(p.uid, 0.0) + \
                    qps * dt / max(1, len(pods))
                n = int(pod_req[p.uid])
                ServingStatsReporter(
                    sapi.stats_file_for(stats_dir, p.uid),
                    epoch=epoch).report(
                        requests=n, slo_ok=n,
                        p50_ms=4.0, p99_ms=30.0)
                if p.node_name not in agents:
                    agents[p.node_name] = NodeAgent(
                        kubectl, p.node_name, FakeUsageProvider(),
                        handlers=[ServingHandler],
                        serving_collector=col)
            for a in agents.values():
                a.sync()
            tpg = kubectl.podgroups.get("default/train")
            if tpg is not None and \
                    tpg.annotations.get(sapi.VICTIM_ANNOTATION):
                flags["victim_marker"] = True
                flags["victim_avoid"] = list(
                    eapi.avoid_slices(tpg))

        def wait_feed(cond, timeout, msg, qps):
            deadline = _time.monotonic() + timeout
            while _time.monotonic() < deadline:
                feed(qps, 0.25)
                if cond():
                    return
                _time.sleep(0.25)
            raise AssertionError(
                "serve smoke: timed out waiting for "
                + (msg() if callable(msg) else msg))

        # phase 1: cruise below the scale-up threshold — the
        # hysteresis must HOLD (no decision on quiet traffic)
        for _ in range(8):
            feed(60.0, 0.25)
            _time.sleep(0.25)
        pg = kubectl.podgroups["default/infer"]
        no_premature = sapi.PG_LAST_DECISION_ANNOTATION \
            not in pg.annotations
        qps_low = sapi.ann_float(pg.annotations,
                                 sapi.PG_QPS_ANNOTATION)

        # phase 2: the traffic step — ONE decision sized for the
        # burst, then the funded preemption frees the GPUs
        t_step = _time.monotonic()
        state = {}

        def decision_seen():
            g = kubectl.podgroups.get("default/infer")
            d = "" if g is None else g.annotations.get(
                sapi.PG_LAST_DECISION_ANNOTATION, "")
            if d.startswith("scale-up") and "t" not in state:
                state["t"] = _time.monotonic()
                state["decision"] = d
            return "t" in state
        wait_feed(decision_seen, 30,
                  lambda: "autoscaler decision after the step "
                  f"({plane.log_tails()[-900:]})", 180.0)

        def train_shrunk():
            g = kubectl.podgroups.get("default/train")
            if g is None or eapi.current_slices(g) != 1:
                return False
            if "t_free" not in state:
                state["t_free"] = _time.monotonic()
            return True
        wait_feed(train_shrunk, 60,
                  lambda: "victim shrink to free the burst GPUs "
                  f"({plane.log_tails()[-900:]})", 180.0)

        def serving_at_2():
            g = kubectl.podgroups.get("default/infer")
            return (g is not None and eapi.current_slices(g) == 2
                    and running("infer", 8))
        wait_feed(serving_at_2, 60,
                  lambda: "serving gang running at 2 replicas "
                  f"({plane.log_tails()[-900:]})", 180.0)
        t_serving = _time.monotonic()

        pg = kubectl.podgroups["default/infer"]
        tpg = kubectl.podgroups["default/train"]
        pool = sapi.pool_slices(pg)
        train_slices = _job_slices_now(kubectl, "default/train")
        hist = eapi.resize_history(tpg)
        shrink_rec = [r for r in hist if r.get("kind") == "shrink"]
        return {
            "scale_up_ok": True,
            "preempt_ok": bool(shrink_rec)
            and all(int(r.get("to", 0)) >= 1 for r in hist),
            "env_ok": env_ok,
            "no_premature_decision": no_premature,
            "victim_marker_seen": flags["victim_marker"],
            "victim_avoid_slices": flags["victim_avoid"],
            "qps_low": round(qps_low, 1),
            "qps_high": round(sapi.ann_float(
                pg.annotations, sapi.PG_QPS_ANNOTATION), 1),
            "decision": state.get("decision", ""),
            "step_to_decision_s": round(state["t"] - t_step, 3),
            "decision_to_gpus_free_s": round(
                state["t_free"] - state["t"], 3),
            "decision_to_serving_s": round(t_serving - state["t"], 3),
            "replicas_final": eapi.current_slices(pg),
            "pool_slices": pool,
            "train_slices_final": train_slices,
            "pool_disjoint_from_victim": not (
                set(pool) & set(train_slices)),
            "hosts": 12,
        }
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def serve_smoke() -> int:
    """Seconds-scale serving drill for tier-1: one scale-up on a
    traffic step + one topology-aware burst preemption through the
    real process control plane, mirroring --elastic-smoke /
    --goodput-smoke.  Prints one JSON line."""
    try:
        out = bench_serving_wire_smoke()
        ok = (out["scale_up_ok"] and out["preempt_ok"]
              and out["env_ok"] and out["no_premature_decision"]
              and out["victim_marker_seen"]
              and out["pool_disjoint_from_victim"]
              and out["replicas_final"] == 2)
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "serve_smoke", "ok": ok, **out}))
    return 0 if ok else 1


def bench_serving() -> dict:
    """One compressed diurnal day against the REAL process plane:
    REAL batched-forward serving replicas (workloads/serve.py
    subprocesses) behind a bench-side load balancer, the SLO-driven
    autoscaler riding the folded QPS/p99, topology-aware burst
    preemption funding the scale-ups out of the nearest training
    gang, and the elastic reabsorption on the descent, with the serving/training Pareto row."""
    import os
    import subprocess
    import sys as _sys
    import time as _time

    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.agent.collect import (GoodputCollector,
                                           ServingCollector)
    from volcano_tpu_torch.agent.handlers import (GoodputHandler,
                                            ServingHandler)
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api import serving as sapi
    from volcano_tpu_torch.api.slicehealth import (
        FAILOVER_GENERATION_ANNOTATION, LAST_STEP_ANNOTATION,
        RESUME_STEP_ANNOTATION)
    from volcano_tpu_torch.api.types import JobPhase, TaskStatus
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes
    from volcano_tpu_torch.workloads.progress import ProgressReporter
    from volcano_tpu_torch.workloads.serve import (DiurnalTraffic,
                                             WeightedLoadBalancer)

    DAY_S = 45.0
    BASE_QPS, PEAK_QPS = 400.0, 3000.0
    TARGET_QPS, SLO_MS = 800.0, 50.0
    CANARY_QPS = 150.0      # flat offered load on the second group
    FLOOR_STEP = 500
    BEAT_S = 0.25

    plane = _WirePlane()
    conf_path = os.path.join(plane.logdir, "serve-conf.yaml")
    with open(conf_path, "w") as f:
        json.dump(SERVE_CONF, f)
    kubectl = None
    agents = {}
    workers = {}        # serving pod uid -> (Popen, logf)
    try:
        plane.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port), "--tick-period", "0.05")
        import urllib.request

        def up():
            try:
                with urllib.request.urlopen(plane.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, 20, "state server /healthz")
        plane.spawn("controllers", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "controllers", "--period", "0.05")
        plane.spawn("scheduler", "-m", "volcano_tpu_torch",
                    "--cluster-url", plane.url,
                    "--components", "scheduler", "--period", "0.05",
                    "--conf", conf_path)
        kubectl = RemoteCluster(plane.url)
        for sname, fabric in (("sa", "ib-0"), ("sb", "ib-0"),
                           ("sc", "ib-0"), ("sd", "ib-1"),
                           ("se", "ib-1"), ("sf", "ib-1")):
            for node in domain_nodes(domain_for(sname, "h100-4x8"),
                                    ib_fabric=fabric):
                kubectl.add_node(node)

        stats_dir = os.path.join(plane.logdir, "serving")
        progress_dir = os.path.join(plane.logdir, "progress")
        traffic_dir = os.path.join(plane.logdir, "traffic")
        for d in (stats_dir, progress_dir, traffic_dir):
            os.makedirs(d, exist_ok=True)

        kubectl.add_vcjob(_serving_vcjob(
            "infer", 1, 1, 3, 4, stats_dir, slo_ms=SLO_MS,
            target_qps=TARGET_QPS))
        # the contending group: a fixed-size (lo == hi == 1) canary
        # replica group behind the SAME front-end LB — multi-group
        # serving contention: it shares the fleet and the balancer
        # with `infer` but its traffic must never bleed across, and
        # the burst preemption funding infer's scale-up must come out
        # of the training gangs, not the other serving group
        kubectl.add_vcjob(_serving_vcjob(
            "canary", 1, 1, 1, 4, stats_dir, slo_ms=SLO_MS,
            target_qps=TARGET_QPS))
        for tname in ("ta", "tb"):
            tj = _elastic_vcjob(tname, 2, 1, 3, 4)
            tj.annotations[LAST_STEP_ANNOTATION] = str(FLOOR_STEP)
            tj.annotations[gapi.PROGRESS_DIR_ANNOTATION] = progress_dir
            kubectl.add_vcjob(tj)

        def running(jname, want):
            j = kubectl.vcjobs.get(f"default/{jname}")
            if j is None or j.phase is not JobPhase.RUNNING:
                return False
            return sum(1 for p in kubectl.pods.values()
                       if p.owner == j.uid and p.node_name
                       and p.phase is TaskStatus.RUNNING) >= want
        # both serving groups up + training absorbed every idle slice
        _wire_wait(lambda: running("infer", 4) and running("canary", 4)
                   and _chip_utilization(kubectl) >= 0.99, 90,
                   lambda: "serve bench gangs never filled the fleet "
                   f"({plane.log_tails()[-900:]})")

        scol = ServingCollector(stats_dir)
        gcol = GoodputCollector(progress_dir)
        for node in kubectl.nodes:
            agents[node] = NodeAgent(
                kubectl, node, FakeUsageProvider(),
                handlers=[GoodputHandler, ServingHandler],
                goodput_collector=gcol, serving_collector=scol)

        traffic = DiurnalTraffic(base_qps=BASE_QPS,
                                 peak_qps=PEAK_QPS, day_s=DAY_S,
                                 seed=7)
        fed = {g: {"step": FLOOR_STEP, "epoch": 0, "max_resume": 0}
               for g in ("ta", "tb")}
        floor_violations = 0
        step_regressions = 0

        def serving_pods(jname):
            sj = kubectl.vcjobs.get(f"default/{jname}")
            if sj is None:
                return []
            return [p for p in kubectl.pods.values()
                    if p.owner == sj.uid and p.node_name
                    and p.phase is TaskStatus.RUNNING]

        lb = WeightedLoadBalancer()

        def lb_beat(t_rel):
            """The front end: evaluate the diurnal curve and
            route BOTH groups' offered load across their RUNNING
            replicas weighted by each replica's OBSERVED p99 (read
            back from the stats file it publishes — the same feedback
            the autoscaler folds), reconciling one REAL serve.py
            subprocess per replica (env straight off the pod's
            injected container env — the torch-plugin contract)."""
            total = traffic.qps_at(t_rel)
            by_group = {"infer": serving_pods("infer"),
                        "canary": serving_pods("canary")}
            pods = [p for ps in by_group.values() for p in ps]
            live = {p.uid for p in pods}
            for uid in [u for u in workers if u not in live]:
                proc, logf = workers.pop(uid)
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    proc.kill()
                logf.close()
                lb.forget(uid)
            for p in pods:
                try:
                    with open(sapi.stats_file_for(stats_dir, p.uid),
                              encoding="utf-8") as f:
                        lb.observe(p.uid,
                                   float(json.load(f).get("p99_ms", 0)))
                except (OSError, ValueError, TypeError):
                    # vtplint: disable=except-pass (cold replica: priced at the group mean)
                    pass
            shares = lb.route(
                {"infer": total, "canary": CANARY_QPS},
                {g: [p.uid for p in ps]
                 for g, ps in by_group.items()})
            for p in pods:
                tf = os.path.join(traffic_dir, f"lb-{p.uid}.json")
                tmp = tf + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"qps": shares.get(p.uid, 0.0)}, f)
                os.replace(tmp, tf)
                if p.uid not in workers:
                    env = dict(os.environ, PYTHONPATH=plane.repo)
                    env.update(p.containers[0].env)
                    env.update(SERVE_DURATION_S="600",
                               SERVE_BEAT_S="0.2",
                               SERVE_SLO_MS=str(SLO_MS),
                               SERVE_TRAFFIC_FILE=tf,
                               SERVE_MODE="synthetic")
                    logf = open(os.path.join(
                        plane.logdir, f"serve-{p.uid[:8]}.log"), "w")
                    workers[p.uid] = (subprocess.Popen(
                        [_sys.executable, "-m",
                         "volcano_tpu_torch.workloads.serve"],
                        env=env, stdout=logf, stderr=logf,
                        cwd=plane.repo), logf)
            infer_shares = [shares[p.uid] for p in by_group["infer"]]
            skew = (max(infer_shares) / max(min(infer_shares), 1e-9)) \
                if len(infer_shares) > 1 else 1.0
            return total, len(by_group["infer"]), skew

        def feed_training():
            """Epoch-aware training progress (the chaos-conductor
            contract): a resize drain resumes from the stamped floor,
            never below it, and the fed step never rewinds."""
            nonlocal floor_violations, step_regressions
            for g in ("ta", "tb"):
                pg = kubectl.podgroups.get(f"default/{g}")
                tj = kubectl.vcjobs.get(f"default/{g}")
                if pg is None or tj is None:
                    continue

                def _i(key):
                    try:
                        return int(pg.annotations.get(key, 0) or 0)
                    except (TypeError, ValueError):
                        return 0
                epoch = _i(FAILOVER_GENERATION_ANNOTATION) + \
                    _i(eapi.ELASTIC_GENERATION_ANNOTATION)
                st = fed[g]
                if epoch != st["epoch"]:
                    st["epoch"] = epoch
                    resume = _i(RESUME_STEP_ANNOTATION)
                    if resume and resume < FLOOR_STEP:
                        floor_violations += 1
                    if resume and resume < st["max_resume"]:
                        step_regressions += 1
                    st["max_resume"] = max(st["max_resume"], resume)
                    st["step"] = max(FLOOR_STEP, resume, st["step"])
                st["step"] += 1
                for p in kubectl.pods.values():
                    if p.owner == tj.uid and p.node_name and \
                            p.phase is TaskStatus.RUNNING:
                        ProgressReporter(
                            gapi.progress_file_for(progress_dir,
                                                   p.uid),
                            epoch=epoch).report(
                                step=st["step"],
                                examples=st["step"] * 8.0)

        timeline = []
        decisions = []
        episodes = []           # completed scale-up episodes
        pending_up = None
        victims = {}      # (gang, freed slices) -> adjacency audit
        # multi-group guard: the burst preemption funding infer must
        # never take the OTHER serving group as its victim
        canary_victimized = False
        decision_snap = None      # holdings + pool at decision time
        t0 = _time.monotonic()
        horizon = DAY_S + 30.0      # one day + the descent tail
        while _time.monotonic() - t0 < horizon:
            t_rel = _time.monotonic() - t0
            total, nrep, lb_skew = lb_beat(min(t_rel, DAY_S + 29.0))
            feed_training()
            for a in agents.values():
                try:
                    a.sync()
                except Exception:  # noqa: BLE001 — resize churn
                    pass
            pg = kubectl.podgroups.get("default/infer")
            if pg is None:
                _time.sleep(BEAT_S)
                continue
            cpg = kubectl.podgroups.get("default/canary")
            if cpg is not None and \
                    cpg.annotations.get(sapi.VICTIM_ANNOTATION):
                canary_victimized = True
            cur = eapi.current_slices(pg)
            ta_s = _job_slices_now(kubectl, "default/ta")
            tb_s = _job_slices_now(kubectl, "default/tb")
            timeline.append({
                "t": round(t_rel, 2), "qps_offered": round(total, 1),
                "replicas": cur, "replicas_running": nrep,
                "lb_skew": round(lb_skew, 3),
                "ta_slices": len(ta_s), "tb_slices": len(tb_s),
                "qps_folded": round(sapi.ann_float(
                    pg.annotations, sapi.PG_QPS_ANNOTATION), 1),
                "p99_folded_ms": round(sapi.ann_float(
                    pg.annotations, sapi.PG_P99_MS_ANNOTATION), 2),
            })
            d = pg.annotations.get(sapi.PG_LAST_DECISION_ANNOTATION)
            if d and (not decisions or decisions[-1]["text"] != d):
                decisions.append({"t": round(t_rel, 2), "text": d})
                if d.startswith("scale-up"):
                    pending_up = {"t": _time.monotonic(),
                                  "text": d,
                                  "ta": len(ta_s), "tb": len(tb_s),
                                  "t_free": None}
                    # decision-time snapshot: the candidate holdings
                    # and pool the scheduler's victim ranking will
                    # see — the audit must score THESE, not whatever
                    # placements exist after the post-episode churn
                    decision_snap = {
                        "ta": ta_s, "tb": tb_s,
                        "pool": sapi.pool_slices(pg)}
            if pending_up is not None:
                if pending_up["t_free"] is None and (
                        len(ta_s) < pending_up["ta"]
                        or len(tb_s) < pending_up["tb"]):
                    pending_up["t_free"] = _time.monotonic()
                want = int(pending_up["text"].split("->")[1]
                           .split(" ")[0].rstrip(")"))
                if cur == want and running("infer", want * 4):
                    now = _time.monotonic()
                    episodes.append({
                        "decision": pending_up["text"],
                        "decision_to_gpus_free_s": round(
                            pending_up["t_free"] - pending_up["t"], 3)
                        if pending_up["t_free"] else None,
                        "decision_to_serving_s": round(
                            now - pending_up["t"], 3),
                    })
                    pending_up = None
            # the victim audit: catch the marker mid-episode and
            # score the FREED block (the stamped avoid-slices — the
            # victim's own placements are already draining) against
            # the pool, vs the slices the OTHER candidate holds, from
            # the same hypernode objects the scheduler used.  The
            # assertion: the eviction freed a block at least as close
            # to the serving pool as anything the alternative victim
            # could have offered.
            snap = decision_snap or {"ta": ta_s, "tb": tb_s,
                                     "pool": sapi.pool_slices(pg)}
            pool = snap["pool"] or sapi.pool_slices(pg)
            for g in ("ta", "tb"):
                tpg = kubectl.podgroups.get(f"default/{g}")
                if tpg is None or not pool:
                    continue
                freed = list(eapi.avoid_slices(tpg))
                if not tpg.annotations.get(sapi.VICTIM_ANNOTATION) \
                        or not freed:
                    continue
                episode_key = (g, tuple(freed))
                if episode_key in victims:
                    continue
                other = "tb" if g == "ta" else "ta"
                ft = _serve_pool_tiers(kubectl, pool, freed)
                ot = _serve_pool_tiers(kubectl, pool, snap[other])
                victims[episode_key] = {
                    "victim": g, "t": round(t_rel, 2),
                    "freed_slices": freed,
                    "freed_pool_tier": ft,
                    "other": other, "other_pool_tier": ot,
                    "nvlink_adjacent_ok": ft <= ot,
                    "pool": pool,
                }
            _time.sleep(max(0.0, BEAT_S - 0.05))

        pg = kubectl.podgroups["default/infer"]
        reqs = sapi.ann_float(pg.annotations,
                              sapi.PG_REQUESTS_ANNOTATION)
        ok_n = sapi.ann_float(pg.annotations,
                              sapi.PG_SLO_OK_ANNOTATION)
        attainment = (ok_n / reqs) if reqs > 0 else 0.0
        cpg = kubectl.podgroups.get("default/canary")
        c_reqs = sapi.ann_float(cpg.annotations,
                                sapi.PG_REQUESTS_ANNOTATION) \
            if cpg is not None else 0.0
        c_ok = sapi.ann_float(cpg.annotations,
                              sapi.PG_SLO_OK_ANNOTATION) \
            if cpg is not None else 0.0
        max_rep = max(r["replicas"] for r in timeline)
        min_rep_after_peak = min(
            r["replicas"] for r in timeline
            if r["t"] > DAY_S)
        train_rows = {}
        floors_held = True
        for g in ("ta", "tb"):
            tpg = kubectl.podgroups.get(f"default/{g}")
            hist = eapi.resize_history(tpg) if tpg is not None else []
            if any(int(r.get("to", 9)) < 1 for r in hist):
                floors_held = False
            avg_slices = sum(
                r[f"{g}_slices"] for r in timeline) / len(timeline)
            train_rows[g] = {
                "goodput": gapi.ann_float(
                    tpg.annotations, gapi.PG_GOODPUT_ANNOTATION)
                if tpg is not None else 0.0,
                "final_step": int(gapi.ann_float(
                    tpg.annotations, gapi.PG_STEP_ANNOTATION))
                if tpg is not None else 0,
                "avg_slices": round(avg_slices, 2),
                "resize_history": hist,
            }
        return {
            "hosts": 24,
            "day_s": DAY_S,
            "slo_ms": SLO_MS,
            "target_qps_per_replica": TARGET_QPS,
            "requests_served": int(reqs),
            "slo_attainment": round(attainment, 4),
            "slo_attainment_ok": attainment >= 0.99,
            "replicas_max": max_rep,
            "replicas_after_descent": min_rep_after_peak,
            "scaled_down_after_peak": min_rep_after_peak < max_rep,
            "decisions": decisions,
            "burst_preemption_episodes": episodes,
            "victim_audit": sorted(victims.values(),
                                   key=lambda v: v["t"]),
            "victim_nvlink_adjacent_all": bool(victims) and all(
                v["nvlink_adjacent_ok"] for v in victims.values()),
            "training_floors_held": floors_held
            and floor_violations == 0,
            "training_step_regressions": step_regressions,
            "lb": {
                "policy": "p99-weighted",
                "skew_max": round(max(
                    r["lb_skew"] for r in timeline), 3),
                "replica_p99_ewma_ms": {
                    u[:8]: round(v, 2)
                    for u, v in lb.latencies().items()},
            },
            "contention": {
                "canary_qps_offered": CANARY_QPS,
                "canary_requests": int(c_reqs),
                "canary_slo_attainment": round(
                    (c_ok / c_reqs) if c_reqs > 0 else 0.0, 4),
                "canary_slices_final": eapi.current_slices(cpg)
                if cpg is not None else 0,
                "canary_never_victimized": not canary_victimized,
            },
            "pareto": {
                "serving_slo_attainment": round(attainment, 4),
                "serving_replicas_avg": round(sum(
                    r["replicas"] for r in timeline)
                    / len(timeline), 2),
                "training": train_rows,
            },
            "timeline_tail": timeline[-8:],
        }
    finally:
        for proc, logf in workers.values():
            proc.terminate()
        for proc, logf in workers.values():
            try:
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                proc.kill()
            logf.close()
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


# -- federation: multi-region fleet behind one global queue ------------


# the fleet and its helpers are tools/fedfleet's (NVLink domains of 4
# hosts x 4 GPUs in each region's IB fabric, gangs in nvidia.com/gpu
# with the torch plugin)
from volcano_tpu_torch.tools.fedfleet import (  # noqa: E402
    FederationFleet as _FederationFleet, fed_copy_regions as _fed_copy_regions,
    fed_dual_sampler as _fed_dual_sampler, fed_folded_step as _fed_folded_step,
    fed_job as _fed_job, fed_regions_ready as _fed_regions_ready,
    fed_running as _fed_running, fed_stamp_and_fold as _fed_stamp_and_fold,
    fed_view as _fed_view)


def _fed_finish(fleet, region, jname, timeout=30):
    """Retire a gang (the submitter cancels it): the global record
    plus the regional copy with its podgroup and pods — the GPUs
    return to the region's idle pool.  Deletes retry until the
    objects STAY gone: a deleted RUNNING job has no finished-TTL (no
    gc cascade), and a concurrent controller status flush is an
    upsert that can resurrect a just-deleted record."""
    from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION
    key = f"default/{jname}"
    client = fleet.clients[region]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gone = True
        try:
            for pod in list(client.pods.values()):
                if pod.annotations.get(
                        GROUP_NAME_ANNOTATION) == jname:
                    client.delete_pod(pod.key)
                    gone = False
            for cl in (client, fleet.g):
                if cl.vcjobs.get(key) is not None:
                    cl.delete_vcjob(key)
                    gone = False
            if client.podgroups.get(key) is not None:
                client.delete_podgroup(key)
                gone = False
        except OSError:
            gone = False            # transient wire hiccup: retry
        if gone:
            return
        time.sleep(0.2)
    raise AssertionError(f"gang {jname} would not stay deleted in "
                         f"{region} ({fleet.log_tails()})")


def bench_federation() -> dict:
    """The three federation headlines against a REAL 3-region process
    fleet (each region: state server + controllers + elastic
    scheduler; one global store; the router reconciling over the
    wire):

      placement      one global queue, goodput/locality/price-routed
                     admission — every gang placed while the silo
                     baseline (jobs pinned to their home region)
                     strands most of them in one queue;
      follow-the-sun `vtpctl federate --drain`-style region drain: the
                     RUNNING gangs checkpoint-drain (elastic evacuate),
                     park under the evacuated hold, and cut over to
                     another region carrying their resume step;
      region loss    SIGKILL a whole regional plane: its gangs requeue
                     GLOBALLY with the folded checkpoint metadata —
                     zero acked state lost — and re-run elsewhere
                     (MTTR measured), plus burst arbitrage: a gang
                     stuck PENDING behind a full regional queue
                     migrates to idle capacity instead of waiting."""
    import time as _time

    from volcano_tpu_torch import metrics as _metrics
    from volcano_tpu_torch.api import federation as fedapi

    STAMP_DRAIN = 7000       # acked step before the drain
    STAMP_KILL = 9000        # acked step before the region kill
    fleet = _FederationFleet(
        (("ra", 2, 1.0), ("rb", 2, 0.7), ("rc", 2, 0.9)))
    g = fleet.g
    try:
        # -- phase A: spread admission + utilization vs silos ----------
        jobs = [f"j{i}" for i in range(1, 7)]
        admission_s = {}
        for jname in jobs:       # staggered: registry refresh between
            g.add_vcjob(_fed_job(jname, 1, locality="ra"))
            t0 = _time.monotonic()
            _wire_wait(lambda j=jname: _fed_running(g, j), 60,
                       lambda j=jname: f"federated admission of {j} "
                       f"({fleet.log_tails()})")
            admission_s[jname] = round(_time.monotonic() - t0, 3)
        placed = {j: _fed_view(g, j)[0] for j in jobs}
        by_region = {}
        for jname, region in placed.items():
            by_region.setdefault(region, []).append(jname)
        # silo baseline: every job pinned to its home (locality)
        # region, no cross-region queue — ra fits 2 of the 6
        silo_placed = min(len(jobs), 2)
        placement = {
            "jobs": len(jobs),
            "by_region": {r: sorted(v)
                          for r, v in sorted(by_region.items())},
            "placed_federated": len([r for r in placed.values() if r]),
            "placed_silo_homed": silo_placed,
            "placed_fraction_federated": 1.0,
            "placed_fraction_silo": round(silo_placed / len(jobs), 3),
            "admission_s": admission_s,
        }
        assert all(placed.values()), f"unplaced: {placed}"
        assert len(by_region) == 3, \
            f"no spread (one queue collapsed): {by_region}"

        # -- phase B: follow-the-sun drain out of ra -------------------
        # free rc first so the drain has somewhere to land: finish
        # (cancel) the two gangs it took
        for jname in list(by_region.get("rc", [])):
            _fed_finish(fleet, "rc", jname)
            jobs.remove(jname)
        ra_jobs = sorted(by_region.get("ra", []))
        for jname in ra_jobs:
            # two ascending stamps teach the router a steps/sec/GPU
            # rate for ra (the learned-goodput input), then the final
            # stamp is the drain's resume floor
            _fed_stamp_and_fold(fleet, "ra", jname, STAMP_DRAIN - 500)
            _fed_stamp_and_fold(fleet, "ra", jname, STAMP_DRAIN)
        fleet.set_region_state("ra", fedapi.REGION_STATE_DRAINING)
        t_drain = _time.monotonic()
        _wire_wait(lambda: all(_fed_running(g, j) and
                               _fed_view(g, j)[0] != "ra"
                               for j in ra_jobs), 120,
                   lambda: "follow-the-sun migration out of ra "
                   f"({[_fed_view(g, j) for j in ra_jobs]}) "
                   f"({fleet.log_tails()})")
        sun_s = round(_time.monotonic() - t_drain, 3)
        from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION
        resume_ok = []
        for jname in ra_jobs:
            region = _fed_view(g, jname)[0]
            copy = fleet.clients[region].vcjobs[f"default/{jname}"]
            resume_ok.append(int(copy.annotations.get(
                RESUME_STEP_ANNOTATION, 0)) >= STAMP_DRAIN)
        cutovers = _metrics.get_observations(
            "federation_cutover_seconds")
        follow_the_sun = {
            "drained_region": "ra",
            "jobs_migrated": len(ra_jobs),
            "dest_regions": sorted({_fed_view(g, j)[0]
                                    for j in ra_jobs}),
            "drain_to_running_s": sun_s,
            "cutover_s": [round(c, 3) for c in cutovers],
            "resume_continuity_ok": all(resume_ok),
            "cutover_refusals": int(sum(
                _metrics.get_counter(
                    "federation_cutover_refusals_total", region=r)
                for r in ("ra", "rb", "rc"))),
        }

        # -- phase C: whole-region loss (SIGKILL rb's plane) -----------
        rb_jobs = sorted(by_region.get("rb", []))
        for jname in rb_jobs:
            _fed_stamp_and_fold(fleet, "rb", jname, STAMP_KILL - 500)
            _fed_stamp_and_fold(fleet, "rb", jname, STAMP_KILL)
        # ra drained empty above: reopen it as the failover target
        fleet.set_region_state("ra", fedapi.REGION_STATE_READY)
        fleet.kill_region("rb")
        t_kill = _time.monotonic()
        mttr = {}

        def _replaced(jname):
            if not _fed_running(g, jname):
                return False
            if _fed_view(g, jname)[0] == "rb":
                return False
            mttr.setdefault(jname,
                            round(_time.monotonic() - t_kill, 3))
            return True
        _wire_wait(lambda: all(_replaced(j) for j in rb_jobs), 120,
                   lambda: "global requeue out of the dead region "
                   f"({[_fed_view(g, j) for j in rb_jobs]}) "
                   f"({fleet.log_tails()})")
        lost_folds = [j for j in rb_jobs
                      if _fed_folded_step(g, j) != STAMP_KILL]
        region_loss = {
            "killed_region": "rb",
            "detected_lost": g.regions["rb"]["state"] == "lost",
            "jobs_requeued": len(rb_jobs),
            "mttr_s": mttr,
            "acked_steps_lost": len(lost_folds),
            "requeue_attempt_bumped": all(
                int(g.vcjobs[f"default/{j}"].annotations.get(
                    fedapi.FED_ATTEMPT_ANNOTATION, 0)) >= 1
                for j in rb_jobs),
        }

        # -- phase D: burst arbitrage ----------------------------------
        # leave exactly one idle slice (in the region hosting the
        # ex-ra gangs), then race TWO one-slice gangs into one router
        # pass: both admit there, one runs, one sits PENDING — and
        # must migrate as soon as a freed region scores better
        sun_dest = follow_the_sun["dest_regions"][0]
        victim = sorted(j for j in jobs
                        if _fed_view(g, j)[0] == sun_dest)[0]
        _fed_finish(fleet, sun_dest, victim)
        jobs.remove(victim)
        _wire_wait(lambda: float(g.regions[sun_dest].get(
            "idle_chips", 0)) >= 16.0, 30,
            f"freed slice visible in {sun_dest}'s registry record")
        fleet.paused.set()       # stage both into ONE admit pass
        g.add_vcjob(_fed_job("jx", 1))
        g.add_vcjob(_fed_job("jy", 1))
        _time.sleep(0.5)
        fleet.paused.clear()
        _wire_wait(lambda: all(_fed_view(g, j)[0] is not None
                               for j in ("jx", "jy")), 60,
                   lambda: "race pair admission "
                   f"({fleet.log_tails()})")
        _wire_wait(lambda: sum(1 for j in ("jx", "jy")
                               if _fed_running(g, j)) >= 1, 60,
                   "one of the race pair running")
        # free a slice in ANOTHER region: the pending gang must beat
        # its local queue by migrating, not by waiting
        other = sorted(j for j in jobs
                       if _fed_view(g, j)[0] not in (None, sun_dest))
        freed_from = _fed_view(g, other[0])[0]
        _fed_finish(fleet, freed_from, other[0])
        jobs.remove(other[0])
        t_arb = _time.monotonic()
        _wire_wait(lambda: all(_fed_running(g, j)
                               for j in ("jx", "jy")), 90,
                   lambda: "arbitrage migration of the pending gang "
                   f"({[_fed_view(g, j) for j in ('jx', 'jy')]}) "
                   f"({fleet.log_tails()})")
        arbitrage = {
            "race_pair_regions": {j: _fed_view(g, j)[0]
                                  for j in ("jx", "jy")},
            "pending_migrations": int(_metrics.get_counter(
                "federation_migrations_total", kind="pending")),
            "pending_to_running_s": round(
                _time.monotonic() - t_arb, 3),
        }

        util = {name: round(_chip_utilization(
            fleet.clients[name]), 4)
            for name in ("ra", "rc")}
        return {
            "hosts": fleet.hosts,
            "regions": {n: {"price": p, "slices": s}
                        for n, s, p in (("ra", 2, 1.0), ("rb", 2, 0.7),
                                        ("rc", 2, 0.9))},
            "placement": placement,
            "follow_the_sun": follow_the_sun,
            "region_loss": region_loss,
            "arbitrage": arbitrage,
            "surviving_region_utilization": util,
            "learned_goodput": {f"{r}/{gen}": round(v, 4)
                                for (r, gen), v in
                                fleet.router._goodput.items()},
            "router_sync_errors": fleet.sync_errors[-5:],
        }
    finally:
        fleet.shutdown()


def bench_federation_wire_smoke() -> dict:
    """Seconds-scale federation drill for tier-1: locality-routed
    admission across two REAL regional planes, then whole-region loss
    — the dead region's gang requeues globally, lands in the survivor
    and resumes from the folded step (zero acked state lost)."""
    import time as _time

    from volcano_tpu_torch.api import federation as fedapi

    STAMP = 4200
    fleet = _FederationFleet(
        (("ra", 2, 1.0), ("rb", 1, 0.7)), ttl=2.0)
    g = fleet.g
    try:
        g.add_vcjob(_fed_job("anchor", 1, locality="ra"))
        g.add_vcjob(_fed_job("roamer", 1, locality="rb"))
        _wire_wait(lambda: _fed_running(g, "anchor", "ra")
                   and _fed_running(g, "roamer", "rb"), 60,
                   lambda: "locality-routed admission "
                   f"({_fed_view(g, 'anchor')} "
                   f"{_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        locality_ok = True
        _fed_stamp_and_fold(fleet, "rb", "roamer", STAMP)
        fleet.kill_region("rb")
        t_kill = _time.monotonic()
        _wire_wait(lambda: _fed_running(g, "roamer", "ra"), 90,
                   lambda: "requeue into the surviving region "
                   f"({_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        mttr = round(_time.monotonic() - t_kill, 3)
        from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION
        copy = fleet.clients["ra"].vcjobs["default/roamer"]
        gjob = g.vcjobs["default/roamer"]
        return {
            "regions": 2, "hosts": fleet.hosts,
            "locality_routed_ok": locality_ok,
            "region_detected_lost":
                g.regions["rb"]["state"] == "lost",
            "requeue_mttr_s": mttr,
            "folded_step_survived":
                _fed_folded_step(g, "roamer") == STAMP,
            "resume_step_in_survivor": int(copy.annotations.get(
                RESUME_STEP_ANNOTATION, 0)),
            "attempt": int(gjob.annotations.get(
                fedapi.FED_ATTEMPT_ANNOTATION, 0)),
            "migrated_from": gjob.annotations.get(
                fedapi.FED_MIGRATED_FROM_ANNOTATION, ""),
            "router_sync_errors": fleet.sync_errors[-3:],
        }
    finally:
        fleet.shutdown()


def federation_smoke() -> int:
    """Tier-1 federation drill, mirroring --elastic-smoke /
    --serve-smoke.  Prints one JSON line."""
    try:
        out = bench_federation_wire_smoke()
        ok = (out["locality_routed_ok"]
              and out["region_detected_lost"]
              and out["folded_step_survived"]
              and out["resume_step_in_survivor"] >= 4200
              and out["migrated_from"] == "rb"
              and not out["router_sync_errors"])
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "federation_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- fleet-wide causal timeline: one episode ID end to end -------------


def _timeline_drill(regions, dwell_s=8.0, jname="tj") -> dict:
    """Follow-the-sun migration reconstructed from ONE episode ID:
    submit a gang with source locality, let it train through the sun
    window, drain the source region, wait for the cross-region
    cutover to land it Running elsewhere — then assert the
    leaseholder's stitched fleet trace tells the WHOLE story from a
    single `GET /fleet_trace?episode=`: every fragment a complete
    span (trace.is_complete_span), router decision + source drain +
    destination placement + resume all covered, >= 2 hops, and a
    stitched segment sum that reconciles with the measured
    submit->running wall within 5%."""
    import time as _time

    from volcano_tpu_torch import trace as trace_mod
    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION

    STAMP = 6000
    src = regions[0][0]
    fleet = _FederationFleet(regions, ttl=2.0, sync_s=0.2)
    g = fleet.g
    key = f"default/{jname}"
    try:
        t_submit = _time.time()
        g.add_vcjob(_fed_job(jname, 1, locality=src))
        _wire_wait(lambda: _fed_running(g, jname, src), 60,
                   lambda: f"admission of {jname} into {src} "
                   f"({_fed_view(g, jname)}) ({fleet.log_tails()})")
        episode = fedapi.episode_of(g.vcjobs[key]) or ""
        assert episode.startswith("ep-"), \
            f"no episode minted at admission: " \
            f"{g.vcjobs[key].annotations}"

        # the sun window: the gang trains in the source region,
        # stamping acked steps (the goodput input AND the resume
        # floor) — long enough that mint/fold lag is noise against
        # the 5% reconciliation budget
        t_end = _time.monotonic() + dwell_s
        step = STAMP
        while True:
            _fed_stamp_and_fold(fleet, src, jname, step)
            left = t_end - _time.monotonic()
            if left <= 0:
                break
            _time.sleep(min(1.0, left))
            step += 100

        fleet.set_region_state(src, fedapi.REGION_STATE_DRAINING)
        _wire_wait(lambda: _fed_running(g, jname)
                   and _fed_view(g, jname)[0] != src, 120,
                   lambda: f"follow-the-sun migration of {jname} out "
                   f"of {src} ({_fed_view(g, jname)}) "
                   f"({fleet.log_tails()})")
        dest = _fed_view(g, jname)[0]

        # ground truth for the reconciliation: the destination copy's
        # own `running` phase stamp (wall clock, written by the
        # destination controller the moment the gang ran) — NOT our
        # detection time, which trails it by a fold + a poll
        run_ts = []

        def _dest_running_stamp():
            c = fleet.clients[dest]
            stamps = []
            pg = c.podgroups.get(key)
            if pg is not None:
                ts = trace_mod.phase_ts(pg.annotations, "running")
                if ts is not None:
                    stamps.append(ts)
            for pod in list(c.pods.values()):
                if pod.annotations.get(
                        GROUP_NAME_ANNOTATION) != jname:
                    continue
                ts = trace_mod.phase_ts(pod.annotations, "running")
                if ts is not None:
                    stamps.append(ts)
            if not stamps:
                return False
            run_ts[:] = [min(stamps)]
            return True
        _wire_wait(_dest_running_stamp, 30,
                   lambda: f"running stamp on {dest}'s copy "
                   f"({fleet.log_tails()})")
        measured_s = run_ts[0] - t_submit
        assert measured_s > 0, (run_ts, t_submit)

        # ONE episode ID reconstructs the whole story: poll the wire
        # endpoint until the stitcher folded the final fragments (it
        # stitches once per leaseholder pass, so the stitched wall
        # GROWS toward the measured wall and then stops)
        state = {}

        def _coverage(doc):
            frags = list((doc.get("root") or {}).get("children", ()))
            names = [f.get("name", "") for f in frags]
            dest_lc = [f for f in frags
                       if f.get("name", "").startswith("lifecycle")
                       and (f.get("labels") or {}).get("plane")
                       == f"region-{dest}"]
            return {
                "router_decision": any(
                    n.startswith(("router-cutover", "router-requeue"))
                    for n in names),
                "source_drain": any(
                    n.startswith("elastic-evacuate-drain")
                    for n in names),
                "destination_placement": bool(dest_lc),
                "resume": any(
                    c.get("name") == "running"
                    for f in dest_lc
                    for c in f.get("children", ())),
            }

        def _stitched():
            try:
                doc = g._request(
                    "GET",
                    f"/fleet_trace?episode={episode}").get("trace")
            except OSError:
                return False
            if not isinstance(doc, dict):
                return False
            root = doc.get("root") or {}
            frags = list(root.get("children") or ())
            if not frags or not all(
                    trace_mod.is_complete_span(s)
                    for s in [root] + frags):
                return False
            wall = float(doc.get("wall_s") or 0.0)
            if not (all(_coverage(doc).values())
                    and len(doc.get("hops") or ()) >= 2
                    and abs(wall - measured_s)
                    <= 0.05 * measured_s):
                return False
            state["doc"] = doc
            return True
        _wire_wait(
            _stitched, 60,
            lambda: "stitched episode reconciliation (measured="
            f"{measured_s:.3f}s stitched="
            f"{(g.fleet_traces.get(episode) or {}).get('wall_s')} "
            f"coverage={_coverage(g.fleet_traces.get(episode) or {})}"
            f" hops="
            f"{(g.fleet_traces.get(episode) or {}).get('hops')})"
            f" ({fleet.log_tails()})")
        doc = state["doc"]
        wall = float(doc["wall_s"])
        skew_clamps = [
            {"fragment": f.get("name"),
             "clamp_s": float(f["labels"]["skew_clamp_s"])}
            for f in doc["root"]["children"]
            if (f.get("labels") or {}).get("skew_clamp_s")]
        return {
            "regions": len(regions), "hosts": fleet.hosts,
            "episode": episode,
            "source": src, "destination": dest,
            "measured_submit_to_running_s": round(measured_s, 3),
            "stitched_wall_s": round(wall, 3),
            "reconcile_pct": round(
                100.0 * abs(wall - measured_s) / measured_s, 2),
            "reconciled_within_5pct": True,
            "all_fragments_complete": True,
            "coverage": _coverage(doc),
            "planes": doc["planes"], "hops": doc["hops"],
            "fragments": len(doc["root"]["children"]),
            "segments": doc["segments"],
            "skew_clamps": skew_clamps,
            "resume_floor_step": step,
            "router_sync_errors": fleet.sync_errors[-5:],
        }
    finally:
        fleet.shutdown()


def bench_timeline() -> dict:
    """The timeline row: a 3-region fleet, one gang
    following the sun out of its home region, the whole causal story
    reconstructed from its single episode ID."""
    return _timeline_drill(
        (("ra", 1, 1.0), ("rb", 1, 0.7), ("rc", 1, 0.9)),
        dwell_s=15.0)


def timeline_smoke() -> int:
    """Tier-1 causal-timeline drill, mirroring --federation-smoke:
    2 regions, seconds-scale sun window.  Prints one JSON line."""
    try:
        out = _timeline_drill((("ra", 1, 1.0), ("rb", 1, 0.7)),
                              dwell_s=6.0)
        ok = (out["reconciled_within_5pct"]
              and out["all_fragments_complete"]
              and all(out["coverage"].values())
              and len(out["hops"]) >= 2
              and not out["router_sync_errors"])
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "timeline_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- federation HA: leased router replica set --------------------------


def bench_federation_ha() -> dict:
    """The router-HA headlines against a REAL fleet: 2 regional
    control planes, one global store, and a 2-process router replica
    set contending for the term-fenced lease.  Four episodes:

      kill_admission   SIGKILL the leaseholder right after a gang
                       enters the global queue — the standby promotes
                       (new term), fences the regions, adopts, and
                       the gang lands in EXACTLY one region
      kill_cutover     SIGKILL the leaseholder mid-migration (source
                       drained, evacuating-to stamped, cutover not
                       driven) — the promoted router resumes the
                       create-then-delete cutover idempotently with
                       the folded checkpoint step intact
      partition        SIGSTOP the leaseholder (the GC-pause / router
                       <->fleet partition model): the standby takes
                       over, and a write stamped with the deposed
                       term is REFUSED 409 by the regional plane
                       (counted on /fences)
      vacancy          kill every router: regions run autonomously,
                       the global queue accumulates (admission
                       delayed, never lost), and one fresh router
                       drains the backlog

    The no-dual-placement invariant is sampled at 10Hz through every
    region's live mirror for the whole run."""
    import threading
    import time as _time

    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION

    STAMP = 7000
    fleet = _FederationFleet(
        (("ra", 2, 1.0), ("rb", 2, 0.7)), ttl=4.0,
        arbitrage_after=60.0, router_procs=2, lease_ttl=2.0)
    g = fleet.g
    dual, stop = [], threading.Event()
    sampler = _fed_dual_sampler(
        fleet, ("anchor", "j-adm", "roamer", "j-queue"), dual, stop)
    try:
        # -- baseline: a leaseholder emerges and routes by locality --
        _wire_wait(lambda: fleet.leaseholder() is not None, 30,
                   lambda: f"router lease acquisition "
                   f"({fleet.log_tails()})")
        h0, term0 = fleet.leaseholder(), fleet.router_term()
        _wire_wait(lambda: _fed_regions_ready(g, ("ra", "rb")), 30,
                   lambda: f"region capacity folded "
                   f"({dict(getattr(g, 'regions', {}))})")
        g.add_vcjob(_fed_job("anchor", 1, locality="ra"))
        _wire_wait(lambda: _fed_running(g, "anchor", "ra"), 60,
                   lambda: f"anchor admission "
                   f"({_fed_view(g, 'anchor')}) ({fleet.log_tails()})")

        # -- episode 1: SIGKILL the leaseholder mid-admission --------
        g.add_vcjob(_fed_job("j-adm", 1, locality="rb"))
        fleet.kill_router(h0)
        t_kill = _time.monotonic()
        _wire_wait(lambda: fleet.leaseholder() not in (None, h0), 30,
                   lambda: f"standby promotion after SIGKILL "
                   f"({fleet.log_tails()})")
        promo_adm = round(_time.monotonic() - t_kill, 3)
        term1 = fleet.router_term()
        _wire_wait(lambda: _fed_running(g, "j-adm", "rb"), 60,
                   lambda: "adopted admission "
                   f"({_fed_view(g, 'j-adm')}) ({fleet.log_tails()})")
        mttr_adm = round(_time.monotonic() - t_kill, 3)
        adm_copies = _fed_copy_regions(fleet, "j-adm")

        # -- episode 2: SIGKILL the leaseholder mid-cutover ----------
        fleet.spawn_router()            # keep the replica set at 2
        g.add_vcjob(_fed_job("roamer", 1, locality="rb"))
        _wire_wait(lambda: _fed_running(g, "roamer", "rb"), 60,
                   lambda: "roamer admission "
                   f"({_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        _fed_stamp_and_fold(fleet, "rb", "roamer", STAMP)
        gj = g.vcjobs["default/roamer"]
        gj.annotations[fedapi.FED_EVACUATE_ANNOTATION] = "ra"
        g.update_vcjob(gj)
        _wire_wait(lambda: (g.vcjobs["default/roamer"].annotations.get(
                       fedapi.FED_EVACUATING_TO_ANNOTATION)) == "ra",
                   60, lambda: f"evacuation start "
                   f"({fleet.log_tails()})")
        h_cut = fleet.leaseholder()
        fleet.kill_router(h_cut)
        t_kill2 = _time.monotonic()
        _wire_wait(lambda: _fed_running(g, "roamer", "ra"), 90,
                   lambda: "adopted cutover "
                   f"({_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        mttr_cut = round(_time.monotonic() - t_kill2, 3)
        _wire_wait(lambda: _fed_copy_regions(fleet, "roamer") ==
                   ["ra"], 60,
                   lambda: "source residual reap "
                   f"({_fed_copy_regions(fleet, 'roamer')}) "
                   f"({fleet.log_tails()})")
        gj = g.vcjobs["default/roamer"]
        cut_migrations = fedapi.migration_count(gj)
        cut_folded = _fed_folded_step(g, "roamer")
        racopy = fleet.clients["ra"].vcjobs["default/roamer"]
        cut_resume = int(racopy.annotations.get(
            RESUME_STEP_ANNOTATION, 0) or 0)

        # -- episode 3: partition (SIGSTOP) + fenced stale write -----
        fleet.spawn_router()
        _wire_wait(lambda: fleet.leaseholder() is not None, 30,
                   "leaseholder before partition")
        h2, term2 = fleet.leaseholder(), fleet.router_term()
        fleet.sigstop_router(h2)
        t_stop = _time.monotonic()
        _wire_wait(lambda: fleet.leaseholder() not in (None, h2), 30,
                   lambda: f"takeover from partitioned holder "
                   f"({fleet.log_tails()})")
        mttr_part = round(_time.monotonic() - t_stop, 3)
        term3 = fleet.router_term()
        rbc = fleet.clients["rb"]
        _wire_wait(lambda: int(rbc.fences().get(
                       fedapi.ROUTER_LEASE_NAME, {}).get("term", 0)
                   ) >= term3, 30,
                   lambda: f"fence advance to term {term3} "
                   f"({rbc.fences()})")
        fleet.sigcont_router(h2)
        # the deposed holder's write, replayed deterministically from
        # the conductor: stamped with the old term, it must be 409'd
        stale_refused = False
        rbc.set_fence(fedapi.ROUTER_LEASE_NAME, term2)
        try:
            rbc.add_vcjob(_fed_job("stale-probe", 1))
        except ValueError as e:
            stale_refused = str(e).startswith("fenced")
        finally:
            rbc.set_fence("", 0)
        fenced_count = int(rbc.fences().get(
            fedapi.ROUTER_LEASE_NAME, {}).get("refused", 0) or 0)

        # -- episode 4: total router vacancy -------------------------
        for holder in list(fleet.router_holders):
            fleet.kill_router(holder)
        _wire_wait(lambda: fleet.leaseholder() is None, 30,
                   "lease vacancy after killing every router")
        g.add_vcjob(_fed_job("j-queue", 1))
        _time.sleep(2.0)
        queued_while_vacant = fedapi.admitted_region(
            g.vcjobs["default/j-queue"]) is None
        anchor_through_vacancy = _fed_running(g, "anchor", "ra")
        fleet.spawn_router()
        t_fresh = _time.monotonic()
        _wire_wait(lambda: _fed_running(g, "j-queue"), 90,
                   lambda: "backlog drain by the fresh router "
                   f"({_fed_view(g, 'j-queue')}) "
                   f"({fleet.log_tails()})")
        mttr_vacancy = round(_time.monotonic() - t_fresh, 3)
        term_final = fleet.router_term()
        result = {
            "hosts": fleet.hosts, "regions": 2,
            "routers_spawned": fleet._routers_spawned,
            "lease_ttl_s": fleet._lease_ttl,
            "terms": {"initial": term0, "after_kill": term1,
                      "before_partition": term2,
                      "after_partition": term3, "final": term_final},
            "terms_strictly_monotonic":
                term0 < term1 <= term2 < term3 <= term_final,
            "kill_admission": {
                "promotion_s": promo_adm, "mttr_s": mttr_adm,
                "copy_regions": adm_copies,
                "exactly_once": adm_copies == ["rb"]},
            "kill_cutover": {
                "mttr_s": mttr_cut,
                "migrations": cut_migrations,
                "folded_step": cut_folded,
                "resume_step": cut_resume,
                "exactly_once": cut_migrations == 1 and
                    _fed_copy_regions(fleet, "roamer") == ["ra"],
                "acked_step_survived": cut_folded == STAMP and
                    cut_resume >= STAMP},
            "partition": {
                "takeover_s": mttr_part,
                "stale_fence_refused": stale_refused,
                "fenced_writes_counted": fenced_count},
            "vacancy": {
                "queued_while_vacant": queued_while_vacant,
                "anchor_ran_through": anchor_through_vacancy,
                "backlog_drain_s": mttr_vacancy},
            "no_dual_placement": not dual,
            "dual_placement_violations": dual[:5],
            "router_sync_errors": fleet.sync_errors[-3:],
        }
    finally:
        stop.set()
        sampler.join(timeout=2)
        fleet.shutdown()
    # the seeded router fault matrix (same scenario engine the chaos
    # conductor exposes as --classes router) rides in the artifact so
    # the row proves the invariants across DIFFERENT seeded
    # kill/partition timings, not one lucky schedule
    from volcano_tpu_torch.tools import chaos_conductor
    matrix = []
    for seed in (1, 2):
        row = chaos_conductor.run_router_failover(seed, 30.0,
                                                  {"router"})
        matrix.append({"seed": seed, "ok": row["ok"],
                       "windows": row["windows"],
                       "failover_mttr_s": row["failover_mttr_s"],
                       "violations": row["violations"]})
    result["mttr_bound_s"] = chaos_conductor.ROUTER_MTTR_BOUND_S
    result["mttr_within_bound"] = all(
        m <= chaos_conductor.ROUTER_MTTR_BOUND_S for m in (
            result["kill_admission"]["mttr_s"],
            result["kill_cutover"]["mttr_s"],
            result["partition"]["takeover_s"],
            result["vacancy"]["backlog_drain_s"]))
    result["chaos_matrix"] = matrix
    result["chaos_matrix_green"] = all(r["ok"] for r in matrix)
    return result


def bench_federation_ha_wire_smoke() -> dict:
    """Seconds-scale router-HA drill for tier-1: two router
    processes, SIGKILL the leaseholder mid-cutover — the standby
    promotes under a higher term, adopts the half-done migration and
    completes it exactly once; a write stamped with the dead router's
    term is refused by the regional plane."""
    import time as _time

    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION

    STAMP = 4200
    fleet = _FederationFleet(
        (("ra", 2, 1.0), ("rb", 1, 0.7)), ttl=4.0,
        arbitrage_after=60.0, router_procs=2, lease_ttl=2.0)
    g = fleet.g
    try:
        _wire_wait(lambda: fleet.leaseholder() is not None, 30,
                   lambda: f"router lease acquisition "
                   f"({fleet.log_tails()})")
        h0, term0 = fleet.leaseholder(), fleet.router_term()
        _wire_wait(lambda: _fed_regions_ready(g, ("ra", "rb")), 30,
                   lambda: f"region capacity folded "
                   f"({dict(getattr(g, 'regions', {}))})")
        g.add_vcjob(_fed_job("anchor", 1, locality="ra"))
        g.add_vcjob(_fed_job("roamer", 1, locality="rb"))
        _wire_wait(lambda: _fed_running(g, "anchor", "ra")
                   and _fed_running(g, "roamer", "rb"), 60,
                   lambda: "locality-routed admission "
                   f"({_fed_view(g, 'anchor')} "
                   f"{_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        _fed_stamp_and_fold(fleet, "rb", "roamer", STAMP)
        gj = g.vcjobs["default/roamer"]
        gj.annotations[fedapi.FED_EVACUATE_ANNOTATION] = "ra"
        g.update_vcjob(gj)
        _wire_wait(lambda: (g.vcjobs["default/roamer"].annotations.get(
                       fedapi.FED_EVACUATING_TO_ANNOTATION)) == "ra",
                   60, lambda: f"evacuation start "
                   f"({fleet.log_tails()})")
        holder_kill = fleet.leaseholder()
        fleet.kill_router(holder_kill)
        t_kill = _time.monotonic()
        _wire_wait(lambda: fleet.leaseholder()
                   not in (None, holder_kill), 30,
                   lambda: f"standby promotion ({fleet.log_tails()})")
        term1 = fleet.router_term()
        _wire_wait(lambda: _fed_running(g, "roamer", "ra"), 90,
                   lambda: "adopted cutover "
                   f"({_fed_view(g, 'roamer')}) ({fleet.log_tails()})")
        mttr = round(_time.monotonic() - t_kill, 3)
        _wire_wait(lambda: _fed_copy_regions(fleet, "roamer") ==
                   ["ra"], 60,
                   lambda: "source residual reap "
                   f"({_fed_copy_regions(fleet, 'roamer')})")
        # the dead leaseholder's late write, stamped with its term
        rbc = fleet.clients["rb"]
        stale_refused = False
        rbc.set_fence(fedapi.ROUTER_LEASE_NAME, term0)
        try:
            rbc.add_vcjob(_fed_job("stale-probe", 1))
        except ValueError as e:
            stale_refused = str(e).startswith("fenced")
        finally:
            rbc.set_fence("", 0)
        gj = g.vcjobs["default/roamer"]
        racopy = fleet.clients["ra"].vcjobs["default/roamer"]
        return {
            "regions": 2, "hosts": fleet.hosts,
            "routers": 2, "killed_holder": holder_kill,
            "term_before": term0, "term_after": term1,
            "term_bumped": term1 > term0,
            "failover_mttr_s": mttr,
            "migrations": fedapi.migration_count(gj),
            "cutover_exactly_once":
                fedapi.migration_count(gj) == 1 and
                _fed_copy_regions(fleet, "roamer") == ["ra"],
            "folded_step_survived":
                _fed_folded_step(g, "roamer") == STAMP,
            "resume_step_in_dest": int(racopy.annotations.get(
                RESUME_STEP_ANNOTATION, 0) or 0),
            "stale_fence_refused": stale_refused,
            "fenced_writes_counted": int(rbc.fences().get(
                fedapi.ROUTER_LEASE_NAME, {}).get("refused", 0) or 0),
            "anchor_untouched": _fed_running(g, "anchor", "ra"),
        }
    finally:
        fleet.shutdown()


def federation_ha_smoke() -> int:
    """Tier-1 router-HA drill, mirroring --federation-smoke.  Prints
    one JSON line."""
    try:
        out = bench_federation_ha_wire_smoke()
        ok = (out["term_bumped"]
              and out["cutover_exactly_once"]
              and out["folded_step_survived"]
              and out["resume_step_in_dest"] >= 4200
              and out["stale_fence_refused"]
              and out["fenced_writes_counted"] >= 1
              and out["anchor_untouched"])
    except AssertionError as e:
        out, ok = {"error": str(e)[-900:]}, False
    print(json.dumps({"metric": "federation_ha_smoke", "ok": ok,
                      **out}))
    return 0 if ok else 1


# -- control-plane crash chaos (kill -9 + WAL recovery) ----------------


class _CrashServer:
    """One state-server OS process over a durable --data-dir that the
    scenario can SIGKILL and respawn in place (same port, same dir) —
    the supervisor's restart loop, minus the supervisor."""

    def __init__(self, data_dir: str, port: int, logdir: str):
        self.data_dir = data_dir
        self.port = port
        self.url = f"http://127.0.0.1:{port}"
        self.logdir = logdir
        self.proc = None
        self.boots = 0

    def spawn(self):
        import os
        import subprocess
        import sys
        self.boots += 1
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo)
        logf = open(os.path.join(self.logdir,
                                 f"server-boot{self.boots}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.server",
             "--port", str(self.port), "--data-dir", self.data_dir],
            stdout=logf, stderr=logf, env=env, cwd=repo)

    def wait_ready(self, timeout: float = 30.0):
        import urllib.request

        def up():
            try:
                with urllib.request.urlopen(self.url + "/healthz",
                                            timeout=1):
                    return True
            except OSError:
                return False
        _wire_wait(up, timeout, "state server /healthz after (re)boot")

    def durability(self) -> dict:
        import urllib.request
        with urllib.request.urlopen(self.url + "/durability",
                                    timeout=5) as r:
            return json.loads(r.read())

    def kill9(self):
        import os
        import signal
        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def shutdown(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                self.proc.kill()


def _snapshot_stores(url: str) -> dict:
    """Ground truth decoded straight off GET /snapshot (no mirror in
    the middle): {kind: {key: obj}}."""
    import urllib.request

    from volcano_tpu_torch.api import codec
    from volcano_tpu_torch.cache.kinds import KINDS
    req = urllib.request.Request(url + "/snapshot",
                                 headers={"Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=30) as r:
        from volcano_tpu_torch.server.httputil import read_json_body
        payload = read_json_body(r)
    out = {}
    for kind, spec in KINDS.items():
        out[kind] = {k: codec.decode(v)
                     for k, v in payload["stores"].get(kind, {}).items()}
    return out


def _mirror_divergence(mirror, truth: dict) -> int:
    """Entries where a live mirror disagrees with the server's own
    snapshot: missing/extra keys per kind, or a pod whose binding
    (node, phase) differs.  Zero is the no-silent-divergence
    contract."""
    from volcano_tpu_torch.cache.kinds import KINDS
    diverged = 0
    for kind, spec in KINDS.items():
        mine = getattr(mirror, spec.attr, {})
        theirs = truth[kind]
        diverged += len(set(mine) ^ set(theirs))
        if kind == "pod":
            for k in set(mine) & set(theirs):
                if mine[k].node_name != theirs[k].node_name or \
                        mine[k].phase is not theirs[k].phase:
                    diverged += 1
    return diverged


def bench_crash_recovery(smoke: bool = False) -> dict:
    """Chaos scenario for the durable control plane: a 1k-host
    cluster's state server takes a bind burst, gets SIGKILLed (not
    SIGTERMed — no goodbye pickle) mid-flight, restarts from
    snapshot+WAL, and the scenario measures the recovery time (RTO)
    and proves the two safety invariants: zero ACKED writes lost
    across the kill, and zero divergence between live watch mirrors
    and the recovered server (delta resync across the restart — the
    epoch BASE survives a durable boot)."""
    import shutil
    import tempfile
    import threading
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    n_slices = 1 if smoke else 16            # 16 x h100-64x8 = 1024 hosts
    slice_kind = "h100-4x8" if smoke else "h100-64x8"
    trials = 1 if smoke else 5
    kills_per_trial = 1 if smoke else 3
    kill_after_s = 0.2 if smoke else 0.5
    total_acked = 0

    rtos, client_gaps, replays = [], [], []
    acked_lost = 0
    divergence = 0
    rv_regressions = 0
    hosts = None
    logroot = tempfile.mkdtemp(prefix="crash-bench-")
    for trial in range(trials):
        data_dir = tempfile.mkdtemp(prefix="crash-wal-")
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        server = _CrashServer(data_dir, port, logroot)
        kubectl = mirror = stale = None
        try:
            server.spawn()
            server.wait_ready()
            kubectl = RemoteCluster(server.url, start_watch=False)
            node_names = []
            for i in range(n_slices):
                for node in domain_nodes(
                        domain_for(f"c{trial}s{i:02d}", slice_kind),
                        ib_fabric=f"ib-{i % 4}"):
                    kubectl.add_node(node)
                    node_names.append(node.name)
            hosts = len(node_names)
            # live mirror watching THROUGH the crash (delta path) and
            # a frozen one resynced only after recovery
            mirror = RemoteCluster(server.url)
            stale = RemoteCluster(server.url, start_watch=False)

            for round_ in range(kills_per_trial):
                # a CONTINUOUS create+bind burst that the kill lands
                # inside: chunks of pods created and gang-bound until
                # the stop mark (set a couple of seconds past the
                # kill, so acks must resume THROUGH the recovered
                # server for the tail of the burst)
                acked: dict = {}     # pod key -> node acked ok
                ack_times: list = []
                stop_mark = [float("inf")]

                def burst():
                    chunk = 16 if smoke else 64
                    i = 0
                    while time.monotonic() < stop_mark[0]:
                        names = [f"burst-t{trial}r{round_}-{i + j}"
                                 for j in range(chunk)]
                        i += chunk
                        try:
                            for j, name in enumerate(names):
                                pod = make_pod("t", requests={"cpu": 1})
                                pod.name = name
                                pod.namespace = "default"
                                kubectl.put_object("pod", pod)
                            binds = [("default", n,
                                      node_names[(i + j)
                                                 % len(node_names)])
                                     for j, n in enumerate(names)]
                            errs = kubectl.bind_pods(binds)
                        except Exception:  # noqa: BLE001 — outage ate
                            continue       # the whole retry budget
                        now = time.monotonic()
                        for (ns, n, node), err in zip(binds, errs):
                            if err is None:
                                acked[f"{ns}/{n}"] = node
                                ack_times.append(now)

                burster = threading.Thread(target=burst)
                burster.start()
                time.sleep(kill_after_s)
                # durable-rv checkpoint just before the kill: recovery
                # must come back at or past it (monotonic across boots)
                rv_before = server.durability()["visible_rv"]
                t_kill = time.monotonic()
                server.kill9()
                stop_mark[0] = t_kill + (1.0 if smoke else 2.0)
                server.spawn()
                server.wait_ready()
                rtos.append(time.monotonic() - t_kill)
                dur = server.durability()
                replays.append({"wal_records": dur["replay_records"],
                                "replay_s": dur["replay_seconds"]})
                if dur["rv"] < rv_before:
                    rv_regressions += 1
                burster.join(timeout=90)
                total_acked += len(acked)
                # ground truth vs every acked bind
                truth = _snapshot_stores(server.url)
                for key, node in acked.items():
                    pod = truth["pod"].get(key)
                    if pod is None or pod.node_name != node:
                        acked_lost += 1
                if ack_times:
                    before = [t for t in ack_times if t <= t_kill]
                    after = [t for t in ack_times if t > t_kill]
                    if before and after:
                        client_gaps.append(min(after) - max(before))
                # the watching mirror must converge with zero
                # divergence (its watch loop delta-resyncs across the
                # restart: same epoch BASE, bumped boot).  Writes are
                # quiet now (burster joined), so: catch the revision
                # first (cheap), then ONE deep compare.
                settle_rv = server.durability()["visible_rv"]
                _wire_wait(lambda: mirror._rv >= settle_rv, 30,
                           "mirror caught up to the recovered rv")
                divergence += _mirror_divergence(
                    mirror, _snapshot_stores(server.url))
                # frozen mirror: explicit resync after recovery must
                # also land exactly (delta when the WAL tail covers
                # its revision, full re-list otherwise — never stale)
                stale.resync()
                divergence += _mirror_divergence(
                    stale, _snapshot_stores(server.url))
        finally:
            for c in (kubectl, mirror, stale):
                if c is not None:
                    c.close()
            server.shutdown()
            shutil.rmtree(data_dir, ignore_errors=True)
    shutil.rmtree(logroot, ignore_errors=True)

    def pct(vals, q):
        vals = sorted(vals)
        return round(vals[min(len(vals) - 1,
                              int(q * len(vals)))], 4) if vals else None

    return {
        "hosts": hosts, "trials": trials,
        "kills_per_trial": kills_per_trial,
        "binds_acked_total": total_acked,
        "rto_p50_s": pct(rtos, 0.5),
        "rto_p95_s": pct(rtos, 0.95),
        "client_ack_gap_p50_s": pct(client_gaps, 0.5),
        "replay": replays,
        "replay_p50_s": pct([r["replay_s"] for r in replays], 0.5),
        "wal_records_p50": pct(
            [float(r["wal_records"]) for r in replays], 0.5),
        "acked_writes_lost": acked_lost,
        "mirror_divergence": divergence,
        "rv_regressions": rv_regressions,
    }


def crash_smoke() -> int:
    """Seconds-scale kill -9 + WAL-replay cycle for tier-1 (small
    cluster, one kill), mirroring --wire-smoke/--failover-smoke: the
    crash-safety contract — acked writes survive, mirrors converge,
    rv monotonic — guarded on every commit.  Prints one JSON line."""
    try:
        out = bench_crash_recovery(smoke=True)
        ok = (out["acked_writes_lost"] == 0
              and out["mirror_divergence"] == 0
              and out["rv_regressions"] == 0
              and out["rto_p50_s"] is not None)
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "crash_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- gray-failure chaos smoke (wire + disk faults, real processes) -----


def bench_chaos_smoke() -> dict:
    """The gray-failure contract on every commit, seconds-scale,
    through real OS processes (docs/design/chaos.md):

      1. ACK-LOST BIND: the server commits a /bind and DROPS the
         response (seeded fault plan, exactly one injection); the
         client's retry must converge by state-compare — bound once,
         no double effects.
      2. ENOSPC DEGRADE-AND-RECOVER: an injected ENOSPC window poisons
         the WAL; writes must 503 with Retry-After (read-only
         degrade), reads and leases must keep serving, and once the
         window passes the heal loop must make the server writable
         again with the rv monotonic across the whole episode.
      3. CRC-CORRUPT REPLAY: kill -9, flip one bit mid-WAL, reboot —
         the server must REFUSE to start (exit 3, CRC detection);
         rebooting with --wal-force-truncate must come up with every
         record before the corruption intact.
    """
    import os
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    from volcano_tpu_torch.tools import chaoslib
    from volcano_tpu_torch import faults as faults_mod
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    logdir = tempfile.mkdtemp(prefix="chaos-smoke-")
    data_dir = os.path.join(logdir, "state")
    port = chaoslib.free_port()
    url = f"http://127.0.0.1:{port}"
    # the seeded plan: exactly one dropped /bind ack + one ENOSPC
    # window a few seconds after boot
    plan_doc = {"seed": 12, "rules": [
        {"site": "server", "kind": "drop_response", "route": "/bind",
         "max_injections": 1},
        {"site": "disk", "kind": "enospc_append",
         "after_s": 3.0, "until_s": 5.0},
    ]}
    plan_path = os.path.join(logdir, "plan.json")
    with open(plan_path, "w", encoding="utf-8") as f:
        json.dump(plan_doc, f)
    zoo = chaoslib.ProcessZoo(logdir)
    out = {"seed": plan_doc["seed"]}
    kubectl = None
    try:
        t_boot = time.monotonic()
        zoo.spawn_server(port, "--data-dir", data_dir,
                         "--fault-plan", f"@{plan_path}")
        chaoslib.wait_server(url)
        kubectl = RemoteCluster(url, start_watch=False)
        node = next(iter(domain_nodes(domain_for("sa", "h100-1x8"),
                                     ib_fabric="d0")))
        kubectl.add_node(node)

        # (1) the ack-lost bind: commit lands, response dropped, the
        # client retry must converge (state-compare rebind)
        pod = make_pod("t", requests={"cpu": 1})
        pod.name, pod.namespace = "p0", "default"
        kubectl.put_object("pod", pod)
        retries_before = metrics.get_counter("client_retries_total",
                                             route="/bind")
        kubectl.bind_pod("default", "p0", node.name)
        faults_fired = {r["kind"]: r["injected"]
                        for r in (chaoslib.http_json(url + "/faults")
                                  or {}).get("rules", [])}
        truth = chaoslib.snapshot_stores(url)
        out["ack_lost_bind"] = {
            "fault_injected": faults_fired.get("drop_response", 0),
            "client_retried": metrics.get_counter(
                "client_retries_total", route="/bind")
            > retries_before,
            "bound_once": truth["pod"]["default/p0"].node_name
            == node.name,
        }

        # (2) ENOSPC degrade-and-recover: inside the window writes
        # must 503 (readonly) while reads + leases still serve; after
        # it the heal loop must restore writability, rv monotonic
        rv_before = int(kubectl._request(
            "GET", "/durability")["visible_rv"])
        degrade = {"writes_503": False, "reads_served": False,
                   "leases_served": False, "retry_after": None}
        while time.monotonic() - t_boot < 10.0:
            body = json.dumps({"namespace": "default", "name": "p0",
                               "node_name": node.name}).encode()
            req = urllib.request.Request(
                url + "/bind", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=5).read()
            except urllib.error.HTTPError as e:
                if e.code == 503 and json.loads(
                        e.read()).get("readonly"):
                    degrade["writes_503"] = True
                    degrade["retry_after"] = e.headers.get(
                        "Retry-After")
                    break
            time.sleep(0.15)
        # mid-degrade: reads and leases must still answer
        ro = kubectl._request("GET", "/durability")
        degrade["readonly_reason"] = ro.get("readonly") or ""
        degrade["reads_served"] = bool(ro)
        degrade["leases_served"] = bool(kubectl.lease(
            "chaos-smoke", "smoker", ttl=5.0).get("acquired"))
        # a write WITH the retry policy must wait out the heal
        # (Retry-After honoured) and land once writable again
        pod2 = make_pod("t", requests={"cpu": 1})
        pod2.name, pod2.namespace = "p1", "default"
        kubectl.put_object("pod", pod2)
        chaoslib.wait_for(
            lambda: not (kubectl._request("GET", "/durability")
                         .get("readonly") or ""),
            20, "server healed back to writable")
        dur = kubectl._request("GET", "/durability")
        degrade["healed_writable"] = not (dur.get("readonly") or "")
        degrade["rv_monotonic"] = int(dur["visible_rv"]) >= rv_before
        truth = chaoslib.snapshot_stores(url)
        degrade["post_heal_write_durable"] = "default/p1" in truth["pod"]
        out["enospc_degrade"] = degrade

        # a little more WAL tail so the bit flip below is mid-segment
        for i in range(4):
            p = make_pod("t", requests={"cpu": 1})
            p.name, p.namespace = f"tail{i}", "default"
            kubectl.put_object("pod", p)

        # (3) CRC-corrupt replay: bit-rot one mid-WAL record; boot
        # must refuse; --wal-force-truncate must keep the prefix
        zoo.kill9("server")
        seg = idx = None
        for name in sorted(os.listdir(data_dir)):
            if name.startswith("wal-") and name.endswith(".log"):
                path = os.path.join(data_dir, name)
                with open(path, "rb") as f:
                    n = sum(1 for ln in f if ln.strip())
                if n >= 3:
                    seg, idx = path, n // 2
                    break
        assert seg is not None, "no WAL segment thick enough to flip"
        faults_mod.flip_record_bit(seg, idx)
        zoo.spawn("server2", "-m", "volcano_tpu_torch.server",
                  "--port", str(port), "--data-dir", data_dir)
        code = zoo.wait_exit("server2", timeout=30)
        crc = {"refused": code == 3 and bool(
            zoo.scrape("server2", "refusing to boot"))}
        zoo.spawn("server3", "-m", "volcano_tpu_torch.server",
                  "--port", str(port), "--data-dir", data_dir,
                  "--wal-force-truncate")
        chaoslib.wait_server(url)
        crc["force_truncate_boots"] = True
        truth = chaoslib.snapshot_stores(url)
        # everything acked BEFORE the flipped record must be intact
        # (p0's bind + p1 landed well before the tail writes)
        crc["prefix_intact"] = (
            truth["pod"].get("default/p0") is not None
            and truth["pod"]["default/p0"].node_name == node.name
            and "default/p1" in truth["pod"])
        out["crc_corrupt_replay"] = crc
        out["ok"] = (
            out["ack_lost_bind"]["fault_injected"] == 1
            and out["ack_lost_bind"]["bound_once"]
            and degrade["writes_503"]
            and degrade["reads_served"] and degrade["leases_served"]
            and degrade["healed_writable"] and degrade["rv_monotonic"]
            and degrade["post_heal_write_durable"]
            and crc["refused"] and crc["prefix_intact"])
        return out
    finally:
        if kubectl is not None:
            kubectl.close()
        zoo.terminate_all()
        shutil.rmtree(logdir, ignore_errors=True)


def chaos_smoke() -> int:
    """Seconds-scale gray-failure drill for tier-1 (one ack-lost
    bind, one ENOSPC degrade-and-recover, one CRC-corrupt replay
    refusal through real processes), mirroring --crash-smoke.  Prints
    one JSON line."""
    try:
        out = bench_chaos_smoke()
        ok = out.get("ok", False)
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "chaos_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# ---------------------------------------------------------------------
# Sharded both planes (docs/design/sharding.md): 2 subtree-partitioned
# scheduler processes over 2 keyspace-partitioned leader groups, all
# real OS processes.  One gang per home shard, then one cross-shard
# gang (homed to the full shard, soft-spilled onto the other shard's
# subtree).  The same workload replays on a single-shard plane and
# the per-job node placements must be IDENTICAL — sharding buys
# parallelism, never a different answer.

def _shard_smoke_conf(logdir: str) -> str:
    import copy
    import os

    conf = copy.deepcopy(BENCH_CONF)
    conf["configurations"] = {"allocate": {"gangCommit": "batch",
                                           "shard-spill": "soft"}}
    path = os.path.join(logdir, "conf.json")   # JSON is valid YAML
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def _shard_smoke_topology(kubectl) -> int:
    from volcano_tpu_torch.controllers.hypernode import LabelDiscoverer
    from volcano_tpu_torch.simulator import domain_nodes

    nodes = []
    for name in ("sa", "sb", "sc"):
        nodes.extend(domain_nodes(domain_for(name, "h100-4x8")))
    for n in nodes:
        kubectl.add_node(n)
    # hypernodes via the label-discovery derivation the controller
    # itself would run
    for hn in LabelDiscoverer().discover(nodes):
        kubectl.add_hypernode(hn)
    return len(nodes)


def _shard_smoke_submit(kubectl, name: str, replicas: int) -> None:
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import PodGroupPhase
    from volcano_tpu_torch.uthelper import gang_job

    pg, pods = gang_job(name, replicas=replicas,
                        requests={"cpu": 1, GPU: 8},
                        pg_phase=PodGroupPhase.INQUEUE)
    kubectl.add_podgroup(pg)
    for p in pods:
        kubectl.add_pod(p)


def _shard_smoke_wait_bound(kubectl, name: str, replicas: int,
                            plane, timeout: float = 40.0) -> dict:
    from volcano_tpu_torch.api.types import TaskStatus

    want = {f"default/{name}-{i}" for i in range(replicas)}

    def bound():
        pods = kubectl.pods
        return all(
            k in pods and pods[k].node_name
            and pods[k].phase in (TaskStatus.BOUND, TaskStatus.RUNNING)
            for k in want)
    _wire_wait(bound, timeout,
               lambda: f"{name} bound ({plane.log_tails()[-1200:]})")
    pods = kubectl.pods
    return {k: pods[k].node_name for k in want}


def _healthz(url: str) -> bool:
    import urllib.request
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=1):
            return True
    except OSError:
        return False


def _shard_smoke_run_plane(sharded: bool) -> dict:
    """Boot one plane (2 leader groups + 2 sharded schedulers, or
    1 server + 1 scheduler), run the 3-gang workload, return per-job
    sorted placements plus plane observables."""
    import socket

    from volcano_tpu_torch import shardmap
    from volcano_tpu_torch.cache.partitioned import PartitionedCluster
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster

    plane = _WirePlane()
    kubectl = None
    try:
        conf_path = _shard_smoke_conf(plane.logdir)
        urls = [plane.url]
        plane.spawn("server-g0", "-m", "volcano_tpu_torch.server",
                    "--port", str(plane.port), "--tick-period", "0.05")
        if sharded:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port2 = s.getsockname()[1]
            urls.append(f"http://127.0.0.1:{port2}")
            plane.spawn("server-g1", "-m", "volcano_tpu_torch.server",
                        "--port", str(port2), "--tick-period", "0.05")
        for u in urls:
            _wire_wait(lambda u=u: _healthz(u), 20,
                       f"state server {u}")
        endpoints = ";".join(urls)
        if sharded:
            for idx in (0, 1):
                plane.spawn(f"sched-{idx}", "-m", "volcano_tpu_torch",
                            "--cluster-url", endpoints,
                            "--components", "scheduler",
                            "--period", "0.05", "--conf", conf_path,
                            "--shard-index", str(idx),
                            "--shard-count", "2")
            kubectl = PartitionedCluster(endpoints)
        else:
            plane.spawn("sched", "-m", "volcano_tpu_torch",
                        "--cluster-url", endpoints,
                        "--components", "scheduler",
                        "--period", "0.05", "--conf", conf_path)
            kubectl = RemoteCluster(endpoints)

        hosts = _shard_smoke_topology(kubectl)
        out = {"hosts": hosts, "sharded": sharded, "jobs": {}}
        # ga is homed to shard 0 (owns sa+sc), gb to shard 1 (owns
        # sb) — stable-hash facts asserted, not assumed; gx is the
        # cross-shard gang: its home subtree is full by the time it
        # arrives, so the home shard soft-spills it wholly onto the
        # other shard's free subtree
        assert shardmap.home_shard("default/ga", 2) == 0
        assert shardmap.home_shard("default/gb", 2) == 1
        plan = shardmap.plan_partition(
            shardmap.subtree_map(kubectl.nodes.values()), 2)
        assert plan[0]["subtrees"] == ["sa", "sc"], plan
        assert plan[1]["subtrees"] == ["sb"], plan

        rv0 = None
        if sharded:
            rv0 = [g._request("GET", "/durability").get("rv", 0)
                   for g in kubectl.groups]
        for name, replicas in (("ga", 4), ("gb", 4), ("gx", 4)):
            _shard_smoke_submit(kubectl, name, replicas)
            placed = _shard_smoke_wait_bound(kubectl, name, replicas,
                                             plane)
            out["jobs"][name] = sorted(placed.values())
        # the workload's shape proves the contract: ga fills its home
        # subtree, gb fills its OWN home subtree (not spillover), gx
        # lands wholly on the foreign free subtree
        assert all(n.startswith("sa-") for n in out["jobs"]["ga"]), out
        assert all(n.startswith("sb-") for n in out["jobs"]["gb"]), out
        assert all(n.startswith("sc-") for n in out["jobs"]["gx"]), out

        if sharded:
            # both shards scheduled (their stamped cycle traces made
            # it to the meta ring) ...
            traces = kubectl._request(
                "GET", "/traces?limit=64").get("traces", [])
            shards_seen = {(t.get("root", {}).get("labels") or {})
                           .get("shard") for t in traces}
            out["sched_shards_traced"] = sorted(
                s for s in shards_seen if s)
            assert {"0/2", "1/2"} <= shards_seen, shards_seen
            # ... and BOTH leader groups absorbed writes: gb's binds
            # relocated its pods onto group 1's keyspace
            rv1 = [g._request("GET", "/durability").get("rv", 0)
                   for g in kubectl.groups]
            out["leader_group_rv_delta"] = [
                b - a for a, b in zip(rv0, rv1)]
            assert all(d > 0 for d in out["leader_group_rv_delta"]), \
                out["leader_group_rv_delta"]
            out["endpoints_shape"] = "g0;g1"
        return out
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def bench_shard_smoke() -> dict:
    sharded = _shard_smoke_run_plane(sharded=True)
    single = _shard_smoke_run_plane(sharded=False)
    identical = sharded["jobs"] == single["jobs"]
    return {
        "ok": identical,
        "placements_identical": identical,
        "sharded": sharded,
        "single": single,
    }


_QPS_WRITE_WORKER = r'''
import sys, time
spec, subtree, dur = sys.argv[1], sys.argv[2], float(sys.argv[3])
from volcano_tpu_torch.api.pod import make_pod
from volcano_tpu_torch.api.types import TaskStatus
if ";" in spec:
    from volcano_tpu_torch.cache.partitioned import PartitionedCluster
    c = PartitionedCluster(spec)
else:
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    c = RemoteCluster(spec)
t_end = time.monotonic() + 10
nodes = []
while time.monotonic() < t_end:
    nodes = sorted(n for n in c.nodes if n.startswith(subtree + "-"))
    if len(nodes) >= 4:
        break
    time.sleep(0.05)
assert nodes, f"no {subtree} nodes visible"
n = 0
t_end = time.monotonic() + dur
while time.monotonic() < t_end:
    p = make_pod("t", requests={"cpu": 1})
    p.name = f"qw-{subtree}-{n % 64}"
    p.namespace = "default"
    p.node_name = nodes[n % len(nodes)]
    p.phase = TaskStatus.BOUND
    try:
        c.put_object("pod", p)
        n += 1
    except Exception:
        pass
c.close()
print(n)
'''


def bench_leader_write_qps(groups: int = 3, writers: int = 3,
                           measure_s: float = 5.0) -> dict:
    """The write-capacity row (docs/design/sharding.md): the same
    keyed pod-status churn — the dominant production write — pushed
    by N writer OS processes against ONE write leader, then against
    the keyspace split across `groups` single-leader groups.  Each
    writer churns one subtree, so under the partitioned config its
    writes route to that subtree's owner group; aggregate QPS is
    measured server-side as sum(rv delta)/window, never from client
    counters.  host_cpus recorded per row: on a single core the
    groups serialize, so this row measures protocol capacity split,
    not hardware parallelism."""
    import json as _json
    import os as _os
    import socket
    import subprocess
    import sys as _sys
    import urllib.request
    from volcano_tpu_torch.cache.partitioned import PartitionedCluster
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    subtrees = [f"q{chr(ord('a') + i)}" for i in range(writers)]

    def rv_of(url):
        with urllib.request.urlopen(url + "/durability",
                                    timeout=5) as r:
            return int(_json.loads(r.read()).get("rv") or 0)

    def run_config(n_groups):
        plane = _WirePlane()
        kubectl = None
        procs = []
        try:
            urls = []
            for gi in range(n_groups):
                if gi == 0:
                    port = plane.port
                else:
                    with socket.socket() as s:
                        s.bind(("127.0.0.1", 0))
                        port = s.getsockname()[1]
                plane.spawn(f"server-g{gi}", "-m",
                            "volcano_tpu_torch.server", "--port", str(port),
                            "--tick-period", "0.2")
                urls.append(f"http://127.0.0.1:{port}")
            for u in urls:
                _wire_wait(lambda u=u: _healthz(u), 20,
                           f"state server {u}")
            spec = ";".join(urls)
            kubectl = PartitionedCluster(spec) if n_groups > 1 \
                else RemoteCluster(spec)
            for sname in subtrees:
                for node in domain_nodes(domain_for(sname, "h100-4x8"),
                                        ib_fabric="d0"):
                    kubectl.put_object("node", node)
            env = dict(_os.environ, PYTHONPATH=plane.repo)
            procs = [subprocess.Popen(
                [_sys.executable, "-c", _QPS_WRITE_WORKER, spec,
                 subtrees[w % len(subtrees)], str(measure_s + 3.0)],
                stdout=subprocess.PIPE, text=True, env=env,
                cwd=plane.repo) for w in range(writers)]
            time.sleep(2.0)        # workers connect + mirrors sync
            rv0 = [rv_of(u) for u in urls]
            t0 = time.monotonic()
            time.sleep(measure_s)
            dt = time.monotonic() - t0
            rv1 = [rv_of(u) for u in urls]
            ops = sum(int(p.communicate()[0].strip() or 0)
                      for p in procs)
            deltas = [b - a for a, b in zip(rv0, rv1)]
            row = {"groups": n_groups, "writers": writers,
                   "host_cpus": _os.cpu_count(),
                   "per_group_rv_delta": deltas,
                   "write_qps": round(sum(deltas) / dt, 1),
                   "writer_ops_total": ops}
            if n_groups > 1:
                row["layout"] = kubectl.shard_layout()
            return row
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            if kubectl is not None:
                kubectl.close()
            plane.shutdown()

    one = run_config(1)
    split = run_config(groups)
    return {
        "write_load": f"{writers} writer processes, keyed bound-pod "
                      "status churn, one subtree each",
        "measure_s": measure_s,
        "single_leader": one,
        "partitioned_leaders": split,
        "scaling": round(split["write_qps"] / one["write_qps"], 2)
        if one["write_qps"] else None,
        "note": ("single-CPU host: all leader groups share one core, "
                 "so this row proves the keyspace split carries the "
                 "full write stream with per-group leaders — the "
                 "hardware-parallel win needs a multi-core replay"),
    }


def shard_smoke() -> int:
    """Seconds-scale sharded-plane drill for tier-1: 2 scheduler
    shards + 2 leader groups as real OS processes, one cross-shard
    gang, placements identical to the single-shard plane.  Prints one
    JSON line."""
    try:
        out = bench_shard_smoke()
        ok = out.get("ok", False)
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "shard_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# ---------------------------------------------------------------------
# Replicated control plane (server/replication.py): WAL-shipped
# follower reads, quorum commit, kill-promote.  The tier-1 smoke runs
# leader + 1 follower as real OS processes (~20s): continuous keyed
# writes and follower reads, SIGKILL the leader mid-burst, the
# follower promotes, the multi-endpoint client re-routes, the deposed
# leader rejoins as a follower — zero acked writes lost, follower
# reads continuous throughout.  The full matrix + read-QPS scaling
# lives in volcano_tpu_torch/tools/chaos_conductor.py --classes replication.

def bench_replication_smoke() -> dict:
    import os
    import shutil
    import tempfile
    import threading
    import urllib.request

    from volcano_tpu_torch.tools import chaoslib
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    logdir = tempfile.mkdtemp(prefix="repl-smoke-")
    ports = [chaoslib.free_port(), chaoslib.free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    dirs = [os.path.join(logdir, f"state-{i}") for i in range(2)]
    zoo = chaoslib.ProcessZoo(logdir)
    out = {}
    kubectl = None
    reader_stop = threading.Event()
    try:
        # 2-node lab group: commit quorum 2 (every ack durable on BOTH
        # replicas — which is what makes the lone survivor's promotion
        # lossless), election quorum 1 (a 2-node group cannot form an
        # election majority; see docs/design/replication.md on the
        # split-brain tradeoff this accepts)
        chaoslib.spawn_replica(zoo, "leader", ports[0], dirs[0], "r1",
                               [urls[1]], commit_quorum=2,
                               election_quorum=1)
        chaoslib.wait_server(urls[0])
        chaoslib.spawn_replica(zoo, "follower", ports[1], dirs[1],
                               "r2", [urls[0]], replicate_from=urls[0],
                               commit_quorum=2, election_quorum=1)
        chaoslib.wait_server(urls[1])
        chaoslib.wait_role(urls[0], "leader")
        chaoslib.wait_role(urls[1], "follower")

        kubectl = RemoteCluster(",".join(urls), start_watch=False)
        node_names = []
        for node in domain_nodes(domain_for("sa", "h100-4x8"),
                                ib_fabric="d0"):
            kubectl.add_node(node)
            node_names.append(node.name)
        chaoslib.wait_follower_caught_up(urls[1], urls[0])

        # follower reads, continuously, on a dedicated thread: the
        # max gap between successful reads is the availability number
        # the whole exercise is about
        read_ok = [0]
        read_fail = [0]
        read_gaps = []
        last_ok = [time.monotonic()]

        def reader():
            while not reader_stop.is_set():
                try:
                    with urllib.request.urlopen(
                            urls[1] + "/durability", timeout=2) as r:
                        json.loads(r.read())
                    now = time.monotonic()
                    read_gaps.append(now - last_ok[0])
                    last_ok[0] = now
                    read_ok[0] += 1
                except OSError:
                    read_fail[0] += 1
                time.sleep(0.05)

        threading.Thread(target=reader, daemon=True).start()

        # keyed write burst: pods created + gang-bound through the
        # multi-endpoint client, acks recorded; the SIGKILL lands
        # mid-burst and the client must re-route to the promoted
        # follower without double-applying (idempotency keys ship in
        # the WAL, so the new leader replays recorded verdicts)
        acked = {}
        stop_mark = [float("inf")]
        t_kill_holder = [None]
        acks_after_kill = [0]

        def burst():
            i = 0
            while time.monotonic() < stop_mark[0]:
                names = [f"rp{i + j}" for j in range(8)]
                i += 8
                try:
                    for name in names:
                        pod = make_pod("t", requests={"cpu": 1})
                        pod.name, pod.namespace = name, "default"
                        kubectl.put_object("pod", pod)
                    binds = [("default", n,
                              node_names[(i + j) % len(node_names)])
                             for j, n in enumerate(names)]
                    errs = kubectl.bind_pods(binds)
                except Exception:  # noqa: BLE001 — failover window
                    continue
                for (ns, n, node), err in zip(binds, errs):
                    if err is None:
                        acked[f"{ns}/{n}"] = node
                        if t_kill_holder[0] is not None:
                            acks_after_kill[0] += 1

        burster = threading.Thread(target=burst)
        burster.start()
        time.sleep(3.0)
        acked_before_kill = len(acked)
        t_kill = time.monotonic()
        t_kill_holder[0] = t_kill
        zoo.kill9("leader")
        chaoslib.wait_role(urls[1], "leader", timeout=30)
        promote_s = time.monotonic() - t_kill
        # the deposed leader rejoins as a follower over its old dir:
        # its term is stale, so the tail forces the full re-sync
        chaoslib.spawn_replica(zoo, "leader-rejoin", ports[0],
                               dirs[0], "r1", [urls[1]],
                               replicate_from="auto", commit_quorum=2,
                               election_quorum=1)
        chaoslib.wait_server(urls[0])
        chaoslib.wait_role(urls[0], "follower", timeout=30)
        stop_mark[0] = time.monotonic() + 3.0
        burster.join(timeout=60)
        reader_stop.set()

        # ground truth off the promoted leader: every acked bind
        # exactly as acked — nothing lost, nothing moved
        truth = _snapshot_stores(urls[1])
        lost = [k for k, node in acked.items()
                if k not in truth["pod"]
                or truth["pod"][k].node_name != node]
        chaoslib.wait_follower_caught_up(urls[0], urls[1])
        rejoin = chaoslib.replication_status(urls[0]) or {}
        out = {
            "acked_binds": len(acked),
            "acked_before_kill": acked_before_kill,
            "acked_after_promote": acks_after_kill[0],
            "acked_lost": len(lost),
            "lost_sample": lost[:5],
            "promote_s": round(promote_s, 3),
            "follower_reads_ok": read_ok[0],
            "follower_reads_failed": read_fail[0],
            "follower_read_gap_max_s": round(max(read_gaps), 3)
            if read_gaps else None,
            "rejoin_role": rejoin.get("role"),
            "rejoin_bootstraps": rejoin.get("bootstraps"),
            "new_leader_term": (chaoslib.replication_status(urls[1])
                                or {}).get("term"),
        }
        out["ok"] = (
            out["acked_lost"] == 0
            and out["acked_before_kill"] > 0
            and out["acked_after_promote"] > 0
            and out["promote_s"] < 20
            and out["follower_reads_ok"] > 0
            and out["follower_reads_failed"] == 0
            and out["rejoin_role"] == "follower")
        return out
    finally:
        reader_stop.set()
        if kubectl is not None:
            kubectl.close()
        zoo.terminate_all()
        shutil.rmtree(logdir, ignore_errors=True)


def replication_smoke() -> int:
    """Leader + 1 follower + kill-promote through real OS processes
    for tier-1 (~20s), mirroring --crash-smoke: zero acked writes
    lost across the promotion, continuous follower reads, the deposed
    leader re-syncs back in.  Prints one JSON line."""
    try:
        out = bench_replication_smoke()
        ok = out.get("ok", False)
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "replication_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# ---------------------------------------------------------------------
# Scheduling flight recorder: per-phase latency attribution through
# the REAL process control plane (volcano_tpu_torch/trace.py).  Gang jobs
# run create->running over the wire; every lifecycle stamp is read
# back from the stamped pod/podgroup annotations, decomposed into
# phase segments, and reconciled against the measured end-to-end
# latency (the telescoping invariant: segments must sum to the total
# within 5%).  The server's /traces ring proves session span trees
# flow through the same wire.

def bench_trace(smoke: bool = False) -> dict:
    from volcano_tpu_torch import trace as trace_mod
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    n_slices = 1 if smoke else 16           # 16 x h100-64x8 = 1024 hosts
    slice_kind = "h100-4x8" if smoke else "h100-64x8"
    gang = 4 if smoke else 64
    trials = 1 if smoke else 5

    plane = _WirePlane()
    kubectl = None
    try:
        plane.start()
        kubectl = RemoteCluster(plane.url)
        for i in range(n_slices):
            for node in domain_nodes(domain_for(f"t{i:02d}", slice_kind),
                                    ib_fabric=f"ib-{i % 4}"):
                kubectl.add_node(node)
        hosts = len(kubectl.nodes)

        gangs = []
        for t in range(trials):
            name = f"tracegang-{t}"
            kubectl.add_vcjob(_wire_gang_job(name, gang, run_ticks=2))
            _wire_wait(lambda: _job_running(kubectl, name, gang), 90,
                       lambda: f"{name} bound "
                               f"({plane.log_tails()[-800:]})")
            # completion frees the slice: identical capacity per trial
            _wire_wait(lambda: _job_completed(kubectl, name), 90,
                       f"{name} completed")
            gangs.append(name)
        # let the final watch events land, then read stamps from a
        # fresh resync of the mirror
        time.sleep(0.3)
        kubectl.resync()

        seg_samples = {seg: [] for seg, _f, _t in trace_mod.SEGMENTS}
        pod_e2es, reconcile_errs = [], []
        gang_rows = []
        for name in gangs:
            pg = kubectl.podgroups.get(f"default/{name}")
            pg_ann = pg.annotations if pg is not None else None
            pods = [p for p in kubectl.pods.values()
                    if p.labels.get("volcano-tpu.io/job-name") == name]
            assert len(pods) >= gang, \
                f"{name}: {len(pods)} pods visible"
            stamps = {ph: [] for ph in trace_mod.PHASES}
            for p in pods:
                segs = trace_mod.phase_segments(p.annotations, pg_ann)
                created = trace_mod.phase_ts(p.annotations, "created")
                running = trace_mod.phase_ts(p.annotations, "running")
                assert created is not None and running is not None, \
                    f"{p.key} missing lifecycle stamps"
                e2e = running - created
                pod_e2es.append(e2e)
                if e2e > 1e-9:
                    # the reconciliation invariant, per pod: clamped
                    # segments must telescope back to the total
                    reconcile_errs.append(
                        abs(sum(segs.values()) - e2e) / e2e * 100.0)
                for seg, dur in segs.items():
                    seg_samples[seg].append(dur)
                for ph in trace_mod.PHASES:
                    ts = trace_mod.phase_ts(p.annotations, ph)
                    if ts is None and pg_ann is not None:
                        ts = trace_mod.phase_ts(pg_ann, ph)
                    if ts is not None:
                        stamps[ph].append(ts)
            # gang-level breakdown from edge stamps: created = first
            # pod created, every later phase = LAST pod through it, so
            # the segments telescope to the measured gang e2e
            edges = {}
            for ph in trace_mod.PHASES:
                if not stamps[ph]:
                    continue
                edges[ph] = (min(stamps[ph]) if ph == "created"
                             else max(stamps[ph]))
            gang_e2e = edges["running"] - edges["created"]
            gsegs, prev = {}, edges["created"]
            for seg, _f, to in trace_mod.SEGMENTS:
                if to not in edges:
                    continue
                gsegs[seg] = round(max(0.0, edges[to] - prev), 4)
                prev = max(prev, edges[to])
            gang_rows.append({"job": name,
                              "gang_e2e_s": round(gang_e2e, 4),
                              "segments_s": gsegs,
                              "reconcile_err_pct": round(
                                  abs(sum(gsegs.values()) - gang_e2e)
                                  / max(gang_e2e, 1e-9) * 100.0, 3)})

        # the flight recorder's query surface, through the same wire
        traces = kubectl._request(
            "GET", "/traces?limit=64").get("traces", [])
        span_actions = {}
        for t in traces:
            for child in (t.get("root") or {}).get("children", ()):
                if child.get("kind") == "action":
                    span_actions.setdefault(child["name"], []).append(
                        child.get("dur", 0.0))

        def pct(vals, q):
            vals = sorted(vals)
            return round(vals[min(len(vals) - 1,
                                  int(q * len(vals)))], 4) \
                if vals else None

        return {
            "hosts": hosts, "gang_replicas": gang, "trials": trials,
            "pods_measured": len(pod_e2es),
            "pod_e2e_p50_s": pct(pod_e2es, 0.5),
            "pod_e2e_p95_s": pct(pod_e2es, 0.95),
            "phase_p50_s": {seg: pct(vals, 0.5)
                            for seg, vals in seg_samples.items()},
            "phase_p95_s": {seg: pct(vals, 0.95)
                            for seg, vals in seg_samples.items()},
            "gangs": gang_rows,
            "gang_e2e_p50_s": pct(
                [g["gang_e2e_s"] for g in gang_rows], 0.5),
            "reconcile_err_max_pct": round(max(
                [g["reconcile_err_pct"] for g in gang_rows]
                + reconcile_errs), 3),
            "traces_captured": len(traces),
            "trace_span_p50_s": {name: pct(vals, 0.5)
                                 for name, vals in
                                 sorted(span_actions.items())},
        }
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def trace_smoke() -> int:
    """Seconds-scale flight-recorder drill for tier-1 (small cluster,
    one gang), mirroring --wire-smoke/--crash-smoke: lifecycle stamps
    present on every gang pod, phase segments reconcile with the
    measured e2e within 5%, and session span trees reach the server's
    /traces ring.  Prints one JSON line."""
    try:
        out = bench_trace(smoke=True)
        ok = (out["pods_measured"] >= out["gang_replicas"]
              and out["reconcile_err_max_pct"] is not None
              and out["reconcile_err_max_pct"] < 5.0
              and out["traces_captured"] > 0
              and out["pod_e2e_p50_s"] is not None
              and out["pod_e2e_p50_s"] > 0)
    except AssertionError as e:
        out, ok = {"error": str(e)[-600:]}, False
    print(json.dumps({"metric": "trace_smoke", "ok": ok, **out}))
    return 0 if ok else 1


# -- the device children: the card, timed with CUDA events -------------
#
# Each child runs in a SUBPROCESS (`python -m volcano_tpu_torch.bench
# --<x>-child`) with a hard timeout and prints its JSON line last.  A
# child with no card raises: it never times the CPU in the card's place.

FLASH_SHAPE = (4, 2048, 8, 128)     # b, t, h, d of the flash child
FLASH_ITERS, FLASH_REPS = 20, 5     # calls a timed window, windows
# a spin on the stream before each window (~0.1 s at the H100's clocks),
# so the host queues the whole window before the device reaches it
SPIN_CYCLES = 200_000_000
TRAIN_STEPS = 6                     # a sweep point's steps; 2-6 timed
TRAIN_PARAM_SEED, TRAIN_BATCH_SEED = 5, 6


def _flash_module():
    """The port's flash-attention module (the ops package exports its
    function under the module's name)."""
    import importlib
    return importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")


def _require_gpu(child: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{child}: no CUDA device "
                           "(torch.cuda.is_available() is false)")


def device_identity() -> dict:
    """The card's name as torch gives it, and its name and power limit
    as nvidia-smi gives them."""
    import subprocess

    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"device_kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def cuda_ms(fn, iters: int, reps: int, warmup: int = 2):
    """(median over `reps` windows of one window's CUDA-event ms / iters,
    whether the host was still queueing when the device reached a
    window's end).  fn() is called `iters` times back to back in a
    window, queued behind a spin of SPIN_CYCLES so that the window times
    the device's work and not the host's launch rate; a window whose
    queueing outlasted the spin is host-bound."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    windows, host_bound = [], False
    for _ in range(reps):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        host_bound |= queued_ms >= spin.elapsed_time(start)
        windows.append(start.elapsed_time(end) / iters)
    return statistics.median(windows), host_bound


def flash_paths(q, k, v, do):
    """name -> callable of the flash child's timed paths: the port's
    kernels forward, and forward + backward at the reference's three
    backward block pairs (the default, 256, 256 x 512); beside them the
    yardsticks (the plain version and `scaled_dot_product_attention`),
    which are never the path timed as the kernel's."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            return fa.flash_attention(q, k, v)

    def fwd_bwd(**blocks):
        def run():
            out = fa.flash_attention(qg, kg, vg, **blocks)
            return torch.autograd.grad(out, (qg, kg, vg), do)
        return run

    def plain_fwd():
        with torch.no_grad():
            return fa._reference(q, k, v, True)

    def plain_fwd_bwd():
        out = fa._reference(qg, kg, vg, True)
        return torch.autograd.grad(out, (qg, kg, vg), do)

    def sdpa(x):
        return x.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(sdpa(q), sdpa(k), sdpa(v),
                                                  is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(sdpa(qg), sdpa(kg), sdpa(vg),
                                             is_causal=True)
        return torch.autograd.grad(out, (qg, kg, vg), sdpa(do))

    return {"kernel_fwd": fwd,
            "kernel_fwd_bwd_bwd512": fwd_bwd(),
            "kernel_fwd_bwd_bwd256": fwd_bwd(block_q_bwd=256,
                                             block_k_bwd=256),
            "kernel_fwd_bwd_bwd256x512": fwd_bwd(block_q_bwd=256,
                                                 block_k_bwd=512),
            "plain_fwd": plain_fwd, "plain_fwd_bwd": plain_fwd_bwd,
            "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd}


# the port's flash kernels by name, as a profiler shows them
PORT_KERNEL = re.compile(r"\bflash_(fwd|bwd_dq|bwd_dkv)_(bf16|simt)_kernel\b")
ATTENTION_WORDS = ("fmha", "flash", "attention", "cudnn")


def profile_paths(paths, names, iters: int) -> dict:
    """Each named path, called `iters` times under torch.profiler after a
    warm-up call: the port's kernel events by kernel, the names of any
    other attention kernel (SDPA's flash, memory-efficient or cuDNN
    kernels), and the forward kernel's mean device ms an event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name in names:
        fn = paths[name]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours, others, fwd_ms = {}, set(), []
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            m = PORT_KERNEL.search(evt.name)
            if m:
                key = f"flash_{m.group(1)}"
                ours[key] = ours.get(key, 0) + 1
                if key == "flash_fwd":
                    fwd_ms.append(evt.time_range.elapsed_us() / 1e3)
            elif any(w in evt.name.lower() for w in ATTENTION_WORDS):
                others.add(evt.name)
        out[name] = {"kernel_events": ours,
                     "other_attention_kernels": sorted(others),
                     "fwd_kernel_ms": (round(statistics.mean(fwd_ms), 5)
                                       if fwd_ms else None)}
    return out


def _flash_child():
    """Runs in a SUBPROCESS on the card: time the port's flash-attention
    kernels (`ops/flash_attention.flash_attention`: the forward, dQ and
    dK/dV kernels) forward and forward + backward at the reference's
    shape [4, 2048, 8, 128] bf16 causal, beside the plain version and
    SDPA, and report MFU against the card's bf16 dense peak.  Each time
    is the median of FLASH_REPS CUDA-event windows of FLASH_ITERS calls
    after a warm-up."""
    import torch
    _require_gpu("--flash-child")
    fa = _flash_module()
    ident = device_identity()
    _, (peak, _) = peaks(ident["device_kind"])
    b, t, h, d = FLASH_SHAPE
    # q, k, v [b, t, h, d] bf16 and a fixed upstream gradient
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(FLASH_SHAPE, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    paths = flash_paths(q, k, v, do)
    launches, ms, host_bound = {}, {}, []
    for name, fn in paths.items():
        fa.flash_fwd.launches = 0
        fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
        iters = FLASH_ITERS if not name.startswith("plain") else 2
        ms[name], bound = cuda_ms(fn, iters, FLASH_REPS if iters > 2 else 2)
        if bound:
            host_bound.append(name)
        launches[name] = {"flash_fwd": fa.flash_fwd.launches,
                          "flash_bwd_dq": fa.flash_bwd.launches_dq,
                          "flash_bwd_dkv": fa.flash_bwd.launches_dkv}
    t_p = ms["kernel_fwd"] / 1e3
    best_pb = min(ms[k] for k in ms if k.startswith("kernel_fwd_bwd")) / 1e3
    fwd_flops = 4.0 * b * h * t * t * d / 2    # causal: half the pairs
    print(json.dumps({
        "gpu_available": True, **ident,
        "shape_bthd": [b, t, h, d],
        "kernel_fwd_ms": round(ms["kernel_fwd"], 4),
        "plain_fwd_ms": round(ms["plain_fwd"], 4),
        "sdpa_fwd_ms": round(ms["sdpa_fwd"], 4),
        "kernel_fwd_bwd_ms": round(best_pb * 1e3, 4),
        "kernel_fwd_bwd_ms_bwd512": round(ms["kernel_fwd_bwd_bwd512"], 4),
        "kernel_fwd_bwd_ms_bwd256": round(ms["kernel_fwd_bwd_bwd256"], 4),
        "kernel_fwd_bwd_ms_bwd256x512": round(
            ms["kernel_fwd_bwd_bwd256x512"], 4),
        "plain_fwd_bwd_ms": round(ms["plain_fwd_bwd"], 4),
        "sdpa_fwd_bwd_ms": round(ms["sdpa_fwd_bwd"], 4),
        "fwd_speedup": round(ms["plain_fwd"] / ms["kernel_fwd"], 2),
        "fwd_bwd_speedup": round(ms["plain_fwd_bwd"] / (best_pb * 1e3), 2),
        "kernel_fwd_tflops": round(fwd_flops / t_p / 1e12, 1),
        "kernel_fwd_mfu": round(fwd_flops / t_p / peak, 3),
        "launches": launches,
        # paths whose windows the host could not queue ahead of the card
        "host_bound": host_bound,
        # the kernel paths again under torch.profiler
        "profile": profile_paths(paths, [n for n in paths
                                         if n.startswith("kernel")],
                                 FLASH_ITERS),
    }), flush=True)


def sweep_points(t: int):
    """(tag, config, batch, mu dtype, env overrides) of the train child's
    sweep: the reference's six points (`wide` d2048-L8 at batch 8, with
    the backward blocks at 256, with a bf16 first moment, at batch 16
    with remat and both; d1024-L8 at batch 8), or one point at
    BENCH_TRAIN_BATCH."""
    import os

    import torch

    from volcano_tpu_torch.workloads import model as model_lib

    def cfg_of(d_model, d_ff, n_heads, remat):
        return model_lib.flagship_config(
            d_model=d_model, d_ff=d_ff, n_heads=n_heads, max_seq=t,
            remat=remat)

    wide = cfg_of(2048, 8192, 16, False)
    sweep = [
        ("d2048-L8-b8", wide, 8, None, {}),
        ("d2048-L8-b8-bwd256", wide, 8, None, {"FLASH_BLOCK_BWD": "256"}),
        ("d2048-L8-b8-mu16", wide, 8, torch.bfloat16, {}),
        ("d2048-L8-b16-remat", cfg_of(2048, 8192, 16, True), 16, None, {}),
        ("d2048-L8-b16-remat-bwd256", cfg_of(2048, 8192, 16, True), 16,
         None, {"FLASH_BLOCK_BWD": "256"}),
        ("d1024-L8-b8", cfg_of(1024, 4096, 8, False), 8, None, {}),
    ]
    if os.environ.get("BENCH_TRAIN_BATCH"):
        b = int(os.environ["BENCH_TRAIN_BATCH"])
        sweep = [(f"d2048-L8-b{b}", wide, b, None, {})]
    return sweep


def train_flops(cfg, n_params: int, b: int, t: int) -> float:
    """Model FLOP of one step by the reference's accounting (PaLM
    appendix): 6 x matmul params x tokens, the input embedding (a
    lookup) excluded and the output head (a matmul) included, plus 3x
    the causal attention forward (fwd 4bht^2*hd/2, bwd ~2x)."""
    matmul_params = n_params - cfg.vocab_size * cfg.d_model
    attn_fwd = cfg.n_layers * 4.0 * b * cfg.n_heads * t * t * \
        cfg.head_dim / 2
    return 6.0 * matmul_params * b * t + 3.0 * attn_fwd


def _train_one_config(cfg, b, t, mu_dtype):
    """Measure one (model, batch) combo on the card; returns (step_s,
    loss, flops, params_m, step ms of every step).  TRAIN_STEPS steps
    of `make_train_step`, each between two CUDA events and a
    synchronize; the step time is the median of steps 2-6."""
    import torch

    from volcano_tpu_torch.workloads import model as model_lib
    from volcano_tpu_torch.workloads import train

    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(TRAIN_PARAM_SEED),
        "cuda")
    opt = train.make_optimizer(mu_dtype=mu_dtype)
    state = opt.init(params)
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(TRAIN_BATCH_SEED), cfg,
        b, t)
    step = train.make_train_step(cfg, opt)
    n_params = sum(x.numel() for x in train.leaves(params))
    torch.cuda.synchronize()
    step_ms, loss = [], float("nan")
    try:
        for _ in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, m = step(params, state, batch)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            loss = float(m["loss"])
    finally:
        del params, state, batch
        torch.cuda.empty_cache()
    steady = sorted(step_ms[1:])
    step_s = steady[len(steady) // 2] / 1e3
    return step_s, loss, train_flops(cfg, n_params, b, t), \
        n_params / 1e6, step_ms


def _train_child():
    """Full training-step throughput on ONE card (bf16, the port's flash
    kernels): the reference's sweep of model/batch shapes in one
    process, each point's line cumulative, the best-MFU point on top."""
    import os

    import torch
    _require_gpu("--train-child")
    fa = _flash_module()
    ident = device_identity()
    _, (peak, _) = peaks(ident["device_kind"])
    t = int(os.environ.get("BENCH_TRAIN_SEQ", "2048"))

    def emit(results):
        """Cumulative line after EVERY config: a parent-side timeout
        mid-sweep salvages the best-so-far instead of losing all."""
        ok = [r for r in results if "error" not in r]
        if not ok:
            return
        best = max(ok, key=lambda r: r["mfu"] or 0)
        out = {"gpu_available": True, **ident, "sweep": results}
        out.update(best)
        print(json.dumps(out), flush=True)

    results = []
    for tag, cfg, b, mu_dtype, env_over in sweep_points(t):
        saved = {k: os.environ.get(k) for k in env_over}
        os.environ.update(env_over)
        fa.flash_fwd.launches = 0
        fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
        try:
            step_s, loss, flops, params_m, step_ms = _train_one_config(
                cfg, b, t, mu_dtype)
        except Exception as e:  # noqa: BLE001 — e.g. OOM on one shape
            results.append({"config": tag, "error": str(e)[-200:]})
            emit(results)
            torch.cuda.empty_cache()
            continue
        finally:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
        results.append({
            "config": tag, "params_m": round(params_m, 1),
            "batch_tokens": b * t,
            "step_ms": round(step_s * 1e3, 3),
            "step_ms_all": [round(x, 3) for x in step_ms],
            "tokens_per_s": round(b * t / step_s),
            "loss": round(loss, 3),
            "model_tflops": round(flops / step_s / 1e12, 1),
            "mfu": round(flops / step_s / peak, 4),
            "launches": {"flash_fwd": fa.flash_fwd.launches,
                         "flash_bwd_dq": fa.flash_bwd.launches_dq,
                         "flash_bwd_dkv": fa.flash_bwd.launches_dkv},
        })
        emit(results)
    if not [r for r in results if "error" not in r]:
        raise RuntimeError(f"every sweep point failed: {results}")


def _probe_child():
    """Cheapest real-card liveness check: one bf16 256x256 product on
    cuda:0 (a library product: a probe, not a kernel of the port)."""
    import torch
    _require_gpu("--probe-child")
    x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda:0")
    float((x @ x).float().sum())
    print(json.dumps({"gpu_available": True, **device_identity()}))


def bench_train_step_gpu(timeout_s: float = 780.0) -> dict:
    """Card train-step throughput in a subprocess with a hard timeout."""
    return _gpu_subprocess("--train-child", timeout_s)


def bench_flash_attention_gpu(timeout_s: float = 240.0) -> dict:
    """The flash kernels' timing on the card in a subprocess with a hard
    timeout; the attempt is recorded either way."""
    return _gpu_subprocess("--flash-child", timeout_s)


def _with_retry(fn, *args) -> dict:
    """Run a device benchmark, retrying ONCE on any failure (a transient
    failure must not wipe a benchmark)."""
    out = fn(*args)
    if out.get("gpu_available"):
        return out
    retry = fn(*args)
    if retry.get("gpu_available"):
        retry["retried"] = True
        return retry
    out["retried"] = True
    return out


def run_gpu_benchmarks() -> Tuple[dict, dict, dict]:
    """(probe, flash, train) — each independently bounded + retried.

    The probe (one product, 150 s) decides reachability ONCE; when it
    fails twice both benchmarks carry its error, and no earlier capture
    stands in for the live run.  When it succeeds, flash and train each
    run in their OWN subprocess with their OWN retry."""
    probe = _with_retry(_gpu_subprocess, "--probe-child", 150.0)
    if not probe.get("gpu_available"):
        down = {"gpu_available": False, "attempted": True,
                "error": "liveness probe failed twice: "
                         + str(probe.get("error", "timeout"))}
        return probe, dict(down), dict(down)
    flash = _with_retry(bench_flash_attention_gpu)
    train = _with_retry(bench_train_step_gpu)
    return probe, flash, train


def _gpu_subprocess(flag: str, timeout_s: float) -> dict:
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    child = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.bench", flag],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=repo)
    try:
        out, err = child.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # a long sweep may time out mid-run: kill, DRAIN the pipes
        # (subprocess.run discards them on POSIX timeouts), and
        # salvage the child's last COMPLETE cumulative JSON line —
        # the kill can truncate the final line mid-write, so keep
        # scanning upward past a fragment
        child.kill()
        try:
            partial, _ = child.communicate(timeout=10)
        except Exception:  # noqa: BLE001
            partial = ""
        for line in reversed((partial or "").strip().splitlines()
                             or [""]):
            if line.startswith("{"):
                try:
                    salvaged = json.loads(line)
                    salvaged["timed_out_after_s"] = timeout_s
                    return salvaged
                except json.JSONDecodeError:
                    continue
        return {"gpu_available": False, "attempted": True,
                "error": f"{flag} exceeded {timeout_s:g}s"}
    if child.returncode == 0:
        for line in reversed((out or "").strip().splitlines() or [""]):
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue
    return {"gpu_available": False, "attempted": True,
            "returncode": child.returncode,
            "error": (err or out or "no output").strip()[-400:]}


def main():
    import gc

    def isolated(fn):
        """Collect garbage from the previous scenario before timing
        the next: a 5k-host object graph awaiting collection taxes an
        unrelated benchmark's allocations."""
        gc.collect()
        return fn()

    p50 = isolated(bench_gang_allocate_latency)
    utilization = isolated(bench_utilization_under_contention)
    gang_shape_s = isolated(bench_reference_gang_shape)
    agent_pps = isolated(bench_agent_scheduler_throughput)
    gangpreempt_p50 = isolated(bench_gangpreempt_latency)
    reclaim_s = isolated(bench_reclaim_convergence)
    scale = isolated(bench_5k_host_scale)
    scale10k = isolated(bench_10k_host_scale)
    scale20k = isolated(bench_20k_host_scale)
    scale40k = isolated(bench_40k_host_scale)
    net_acct = isolated(bench_net_accounting_overhead)
    failover = isolated(bench_failover_chaos)
    elastic = isolated(bench_elastic)
    goodput = isolated(bench_goodput)
    crash = isolated(bench_crash_recovery)
    wire = isolated(run_wire_benchmarks)
    probe, flash, train_gpu = run_gpu_benchmarks()
    print(json.dumps({
        "metric": "p50_gang_allocate_latency_256host_h100_256x8",
        "value": round(p50, 4),
        "unit": "s",
        "vs_baseline": round(TARGET_P50_S / p50, 2),
        "extra": {
            "gpu_utilization_under_contention": round(utilization, 4),
            "utilization_target": 0.95,
            "reference_gang_shape_1000pods_s": round(gang_shape_s, 4),
            "agent_scheduler_pods_per_s": round(agent_pps),
            "gangpreempt_p50_64host_displace_s": round(gangpreempt_p50, 4),
            "reclaim_convergence_2queue_flip_s": round(reclaim_s, 4),
            "scale_5k_hosts": scale,
            "scale_10k_hosts": scale10k,
            "scale_20k_hosts": scale20k,
            # the 40k row: `--scale-40k` regenerates it standalone
            "scale_40k_hosts": scale40k,
            # network accounting subsystem overhead: per-tick cost at
            # 100+ pods/host (collector walk + full agent sync)
            "net_accounting": net_acct,
            # domain-failure chaos: kill a host in a 1k-host cluster,
            # MTTR p50/p95 with detect/drain/reschedule/resume
            # breakdown (`--failover` regenerates standalone)
            "failover": failover,
            # elastic gangs on a contended cluster: idle capacity
            # absorbed (utilization >= 0.99), shrink-latency +
            # migration-MTTR percentiles (`--elastic` regenerates
            # standalone)
            "elastic": elastic,
            # goodput observatory: learned throughput vectors, ledger
            # reconciliation, grow gating (`--goodput` regenerates
            # standalone)
            "goodput": goodput,
            # state-server kill -9 chaos: RTO + WAL replay + the
            # zero-acked-writes-lost / zero-mirror-divergence
            # invariants (`--crash` regenerates standalone)
            "crash_recovery": crash,
            # audit-trail-derived latency through the REAL multi-
            # process control plane (state server + leader-elected
            # scheduler + controllers), next to the in-process
            # headline above — the reference's apiserver-audit
            # methodology at this repo's own wire boundary
            "wire_gang_p50_s": wire.get("wire_gang_p50_s"),
            "wire_control_plane": {
                k: v for k, v in wire.items() if k != "scale"},
            "wire_scale_1k_hosts": wire.get("scale"),
            "inprocess_gang_p50_s": round(p50, 4),
            # where the cost curve bends: per-gang-member cycle cost
            # at each scale point (ms/member), from this run
            "scale_knee": _scale_knee(scale, scale10k, scale20k,
                                      scale40k),
            "gpu_probe": probe,
            "flash_attention_gpu": flash,
            "train_step_gpu": train_gpu,
            "trials": TRIALS,
            "cluster_hosts": 256 + 64 + 16,
        },
    }))
    # the device rows carry the error of a failed live run: no stand-in
    return 0 if probe.get("gpu_available") else 1


def wire_smoke():
    """Seconds-scale wire scenario (real processes, tiny shapes) so a
    tier-1 test can run the wire path on every commit and the wire
    benchmark can never silently rot.  It also
    round-trips one bandwidth usage report + violation event through
    the state server (the accounting subsystem's wire traffic is
    tier-1 guarded too).  Prints one JSON line with the same key
    names the full scenario reports."""
    out = run_wire_benchmarks(smoke=True)
    ok = "wire_gang_error" not in out and \
        "error" not in (out.get("scale") or {}) and \
        (out.get("usage_roundtrip") or {}).get(
            "violation_roundtrip_ok") is True
    print(json.dumps({"metric": "wire_smoke", "ok": ok, **out}))
    return 0 if ok and out.get("wire_gang_p50_s") is not None else 1


if __name__ == "__main__":
    import sys
    if "--flash-child" in sys.argv:
        _flash_child()
    elif "--train-child" in sys.argv:
        _train_child()
    elif "--probe-child" in sys.argv:
        _probe_child()
    elif "--wire-smoke" in sys.argv:
        sys.exit(wire_smoke())
    elif "--failover-smoke" in sys.argv:
        sys.exit(failover_smoke())
    elif "--elastic-smoke" in sys.argv:
        sys.exit(elastic_smoke())
    elif "--goodput-smoke" in sys.argv:
        sys.exit(goodput_smoke())
    elif "--serve-smoke" in sys.argv:
        sys.exit(serve_smoke())
    elif "--federation-smoke" in sys.argv:
        sys.exit(federation_smoke())
    elif "--timeline-smoke" in sys.argv:
        sys.exit(timeline_smoke())
    elif "--timeline" in sys.argv:
        # the fleet-wide causal-tracing row:
        # a follow-the-sun migration on a 3-region
        # fleet reconstructed from ONE episode ID — stitched span tree
        # complete, router decision + source drain + destination
        # placement + resume covered, segment sum reconciling with the
        # measured submit->running wall within 5%
        print(json.dumps({"metric": "fleet_causal_timeline",
                          **bench_timeline()}))
    elif "--federation-ha-smoke" in sys.argv:
        sys.exit(federation_ha_smoke())
    elif "--federation-ha" in sys.argv:
        # the router-HA row: a 2-process
        # router replica set over 2 REAL regional planes — SIGKILL
        # the leaseholder mid-admission and mid-cutover, SIGSTOP
        # partition with a fenced stale-term write, and total router
        # vacancy, with the no-dual-placement invariant sampled at
        # 10Hz the whole run
        print(json.dumps({"metric": "federation_router_ha",
                          **bench_federation_ha()}))
    elif "--federation" in sys.argv:
        # the standalone federation-tier row:
        # 3 REAL regional control planes behind one
        # global queue — goodput/locality/price-routed placement vs
        # the silo baseline, follow-the-sun drain with checkpoint
        # resume continuity, whole-region SIGKILL with zero acked
        # state lost + global-requeue MTTR, and burst arbitrage of a
        # pending gang onto freed capacity
        print(json.dumps({"metric": "federation_3region_fleet",
                          **bench_federation()}))
    elif "--serve" in sys.argv:
        # the standalone serving-plane row:
        # diurnal day against the real process
        # plane, p99 SLO attainment >= 99%, topology-aware burst
        # preemption latencies, training floors held, victim NVLink
        # adjacency audited from the scheduler's own hypernodes
        print(json.dumps({"metric": "serving_diurnal_day",
                          **bench_serving()}))
    elif "--goodput" in sys.argv:
        # the standalone goodput-observatory row:
        # learned throughput vectors within 10% of
        # simulator ground truth, ledger reconciles with wall-clock
        # allocated time within 5%, goodput-gated grow beats greedy
        print(json.dumps({"metric": "goodput_observatory_1k_hosts",
                          **bench_goodput()}))
    elif "--elastic-child" in sys.argv:
        _elastic_child(sys.argv[sys.argv.index("--init") + 1]
                       if "--init" in sys.argv else "")
    elif "--elastic" in sys.argv:
        # the standalone elastic chaos row:
        # contended 1k-host cluster, elastic jobs
        # absorb all idle capacity (utilization >= 0.99), shrink
        # latency + migration MTTR percentiles, and the dp-resize
        # loss-continuity dryrun
        out = bench_elastic()
        out["loss_continuity"] = _run_elastic_child()
        print(json.dumps({"metric": "elastic_gangs_1k_hosts", **out}))
    elif "--crash-smoke" in sys.argv:
        sys.exit(crash_smoke())
    elif "--chaos-smoke" in sys.argv:
        sys.exit(chaos_smoke())
    elif "--shard-smoke" in sys.argv:
        sys.exit(shard_smoke())
    elif "--replication-smoke" in sys.argv:
        sys.exit(replication_smoke())
    elif "--trace-smoke" in sys.argv:
        sys.exit(trace_smoke())
    elif "--trace" in sys.argv:
        # the standalone flight-recorder row:
        # 1k-host wire run, per-phase p50/p95 whose
        # segment sums reconcile with the measured gang e2e latency
        print(json.dumps({"metric": "trace_phase_breakdown_1k_hosts",
                          **bench_trace()}))
    elif "--crash" in sys.argv:
        # the standalone kill -9 durability row:
        # bind burst in flight, SIGKILL the state
        # server, restart from WAL — RTO p50/p95 + zero-acked-writes-
        # lost + zero-mirror-divergence
        print(json.dumps({"metric": "crash_recovery_1k_hosts",
                          **bench_crash_recovery()}))
    elif "--failover" in sys.argv:
        # the standalone chaos row:
        # kill a host in the 1k-host simulator, p50/p95 MTTR breakdown
        print(json.dumps({"metric": "failover_mttr_1k_hosts",
                          **bench_failover_chaos()}))
    elif "--scale-40k" in sys.argv:
        # the standalone 40k-host row: same
        # probe main() embeds as extra.scale_40k_hosts, regenerable
        # without the full suite
        print(json.dumps({"metric": "scale_40k_hosts",
                          **bench_40k_host_scale()}))
    elif "--sweep-smoke" in sys.argv:
        sys.exit(sweep_smoke())
    elif "--scale-100k" in sys.argv:
        # the 100k-host row: 100k
        # hosts, idle + 8192-gang cycles per sweep backend with
        # flight-recorder waterfalls, the batched gang-commit row,
        # per-shard cycle rows under 2- and 4-shard planes,
        # per-worker-count entry rows bit-identical to serial
        # (disarmed + armed), the 40k idle-cycle acceptance row, and
        # the leader-group write-QPS scaling row (real OS servers)
        doc = {"metric": "scale_100k_hosts", **bench_scale_100k()}
        print("leader write-QPS scaling (3 groups vs 1)...",
              flush=True)
        doc["leader_write_qps"] = bench_leader_write_qps()
        print(json.dumps(doc))
    else:
        sys.exit(main())

"""The port's chaos conductor and control-plane tools
(`volcano_tpu_torch.tools`) against the reference's (`tools/`), on the
CPU.

The fault plans are byte-identical for every seed and class set that
`chip_smoke.py`'s `phase_chaos` runs; the `ChaosProxy` modes hold between
a client and the port's state server; one conductor run over the port's
process plane ends with zero violations and every scheduled fault kind
injected; `trace_report` renders the same Chrome trace from the same
recorded docs; `race_bench` certifies the parallel sweep bit-identical
on the port's scheduler.
"""

import importlib
import json
import os
import re
import select
import socket
import subprocess
import sys
import threading
import time

import pytest

from tools import chaos_conductor as ref_conductor
from tools import trace_report as ref_trace_report
from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
from volcano_tpu_torch.tools import chaos_conductor, chaoslib, trace_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phase_chaos's runs: (classes, duration), and the reference's default
PLANS = (("wire,disk,clock,slice", 20.0),
         ("wire,disk,clock,replication", 30.0), ("wire,serving", 20.0),
         ("region", 20.0), ("router", 20.0), ("wire,disk,clock", 30.0))
SEEDS = range(1, 21)
RUN_TIMEOUT_S = 240


@pytest.mark.parametrize("classes,duration", PLANS,
                         ids=[c for c, _ in PLANS])
def test_build_plan_equals_reference(classes, duration):
    for seed in SEEDS:
        want = ref_conductor.build_plan(seed, duration,
                                        set(classes.split(",")))
        got = chaos_conductor.build_plan(seed, duration,
                                         set(classes.split(",")))
        assert got == want, seed
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)


def _print_schedule(argv, seed, classes):
    return subprocess.run(
        [sys.executable, *argv, "--seed", str(seed), "--classes", classes,
         "--print-schedule"], cwd=REPO, capture_output=True, text=True,
        timeout=60, env=dict(os.environ, PYTHONPATH=REPO),
        check=True).stdout


@pytest.mark.parametrize("seed,classes",
                         [(11, "wire,disk,clock"),
                          (1, "wire,disk,clock,replication,region,router")])
def test_print_schedule_equals_reference(seed, classes):
    want = _print_schedule([os.path.join("tools", "chaos_conductor.py")],
                           seed, classes)
    got = _print_schedule(["-m", "volcano_tpu_torch.tools.chaos_conductor"],
                          seed, classes)
    assert got == want
    assert json.loads(got)["seed"] == seed


def test_proxy_fault_modes_against_port_server():
    """chaoslib.ChaosProxy between a client and the port's server: pass
    forwards, blackhole stalls until healed, latency delays but
    completes, reset surfaces a transient, trickle completes slowly,
    heal restores service."""
    from volcano_tpu_torch.server.state_server import serve

    httpd, _state = serve(port=0)
    proxy = c = None
    try:
        proxy = chaoslib.ChaosProxy(httpd.server_address[1])
        proxy.start()
        c = RemoteCluster(f"http://127.0.0.1:{proxy.port}",
                          start_watch=False, retry_deadline=6.0)
        c.tick()                       # pass mode works
        proxy.set_mode("blackhole")
        t0 = time.monotonic()
        with pytest.raises(Exception):
            c._request("POST", "/tick", retries=False, timeout=0.5)
        assert time.monotonic() - t0 >= 0.4   # a stall, not a refusal
        proxy.set_mode("latency")
        t0 = time.monotonic()
        c.tick()
        assert time.monotonic() - t0 >= 0.1   # the brownout is real
        proxy.set_mode("reset")
        with pytest.raises(Exception):
            c._request("POST", "/tick", retries=False)
        proxy.set_mode("trickle")
        c.tick()                       # slow, but the bytes arrive
        proxy.set_mode("pass")
        c.tick()                       # healed
    finally:
        if c is not None:
            c.close()
        if proxy is not None:
            proxy.close()
        httpd.shutdown()


INJECTED = re.compile(r"fault injected: site=(\w+) kind=(\w+)")


def _conductor_run(logdir):
    """`--seed 1 --duration 10 --classes wire,disk,clock` over the port's
    process plane; its result and the fault kinds its server's log shows
    injected (the wall jump, counted once a window, shows only there)."""
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.tools.chaos_conductor",
         "--seed", "1", "--duration", "10", "--classes", "wire,disk,clock",
         "--logdir", str(logdir)],
        cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, set(INJECTED.findall((logdir / "server.log").read_text()))


def test_conductor_run_holds_every_invariant(tmp_path):
    """One conductor run over the port's process plane (state server,
    leader-elected scheduler, controllers): zero violations, every
    invariant passed, the CRC drill refused, and each fault kind of the
    plan injected at least once.  `duplicate` fires only on writes (3.5%
    a write, after three rules ahead of it): in about 1 run of 20 under
    load a 10 s run's writes draw none, so a run that misses a kind is
    followed by one more, every run held to zero violations and the
    kinds counted over both."""
    plan = chaos_conductor.build_plan(1, 10.0, {"wire", "disk", "clock"})
    kinds = {(r["site"], r["kind"]) for r in plan["rules"]}
    assert len(kinds) == 11
    fired = set()
    for attempt in range(2):
        out, seen = _conductor_run(tmp_path / f"conductor{attempt}")
        assert out["ok"] and not out["invariants"]["violations"], out
        assert all(out["invariants"]["passed"].values())
        assert out["crc_drill"]["refused"]
        assert out["completed"] >= 1
        fired |= seen
        if kinds <= fired:
            break
    assert kinds <= fired, kinds - fired


def _session_traces():
    """Docs of the port's real scheduling sessions (a gang that binds,
    one that cannot), as the flight recorder kept them."""
    from volcano_tpu_torch import trace
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import make_gpu_cluster
    trace.reset()
    cluster = make_gpu_cluster([("nvl-a", "hgx-h100-8"),
                                ("nvl-b", "hgx-h100-8")])
    mgr = ControllerManager(cluster, enabled=["job", "queue"])
    sched = Scheduler(cluster, schedule_period=0)
    for name, replicas in (("fits", 2), ("waits", 3)):
        cluster.add_vcjob(VCJob(
            name=name, min_available=replicas,
            tasks=[TaskSpec(name="w", replicas=replicas,
                            template=make_pod("t", requests={"cpu": 4,
                                                             GPU: 8}))]))
    for _ in range(3):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    docs = trace.recent_traces()
    trace.reset()
    return docs


def _stitched_trace():
    from volcano_tpu_torch import trace
    from volcano_tpu_torch.federation import stitch
    frags = []
    for hop, (plane, start, end) in enumerate(
            (("router", 10.0, 10.4), ("region-a", 10.3, 11.0),
             ("controllers-a", 11.2, 11.5))):
        doc = trace.fragment_doc(f"hop {hop}", plane, "ep-1", start, end,
                                 hop=hop, jobs=["default/g"],
                                 children=[("work", start, end)])
        frags.append({"plane": plane, "hop": hop, "key": f"k{hop}",
                      "root": doc["root"]})
    return {"episode": "ep-1",
            "trace": stitch.stitch("ep-1", frags, jobs=["default/g"])}


@pytest.mark.parametrize("kind", ["sessions", "stitched"])
def test_trace_report_renders_as_reference(kind, tmp_path):
    doc = {"traces": _session_traces()} if kind == "sessions" \
        else _stitched_trace()
    if kind == "sessions":
        assert doc["traces"]
    src = tmp_path / "in.json"
    src.write_text(json.dumps(doc))
    outs = []
    for side, module in (("ref", ref_trace_report), ("port", trace_report)):
        dst = tmp_path / f"{side}.json"
        assert module.main(["--in", str(src), "--out", str(dst)]) == 0
        outs.append(json.loads(dst.read_text()))
    assert outs[1] == outs[0]
    assert outs[1]["traceEvents"]


def test_race_bench_certifies_bit_identity(tmp_path):
    """`race_bench --hosts 64 --reps 1` in a process of its own (the
    auditor wraps `threading` in the process that arms it)."""
    out = tmp_path / "race.json"
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.tools.race_bench",
         "--hosts", "64", "--reps", "1", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["scenario"]["hosts"] == 64
    assert doc["freeze_audit"]["entries_identical_under_audit"]
    assert not doc["freeze_audit"]["violations"]
    assert doc["static_pass"]["active_findings"] == 0
    assert all(r["entry_identical_to_serial"] for r in doc["parallel"])


class StallingRelay(threading.Thread):
    """A TCP relay to `port` that forwards every connection it accepted
    before `stall()` and holds every later one open, silent: a link that
    died between two requests, with no reply in flight to fail."""

    def __init__(self, port):
        super().__init__(daemon=True)
        self.upstream = port
        self.stalled = threading.Event()
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.port = self.listener.getsockname()[1]
        self.held = []

    def stall(self):
        self.stalled.set()

    def run(self):
        while True:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            if self.stalled.is_set():
                self.held.append(conn)
                continue
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True).start()

    def _pump(self, conn):
        up = socket.create_connection(("127.0.0.1", self.upstream))
        socks, peer = [conn, up], {conn: up, up: conn}
        try:
            while True:
                ready, _, _ = select.select(socks, [], [], 1.0)
                for s in ready:
                    data = s.recv(65536)
                    if not data:
                        return
                    peer[s].sendall(data)
        except OSError:
            return
        finally:
            conn.close()
            up.close()

    def close(self):
        self.listener.close()
        for conn in self.held:
            conn.close()


def _lag_while_the_link_stalls(pkg, tmp_path):
    """A leader (commit quorum 1) and a follower tailing it through a
    StallingRelay: once the follower is caught up the relay stalls every
    new connection, the leader takes writes, and the follower's status
    is read for 2.5 s.  Returns [(lag_s, applied seq, leader's seq)]."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    Replication = m("server.replication").Replication
    serve = m("server.state_server").serve
    DurableStore = m("server.durability").DurableStore
    r1 = Replication("r1", commit_quorum=1, election_quorum=1, ttl=30.0)
    h1, s1 = serve(port=0, durable=DurableStore(str(tmp_path / "d1")),
                   replication=r1)
    relay = StallingRelay(h1.server_address[1])
    relay.start()
    url1 = f"http://127.0.0.1:{h1.server_address[1]}"
    r2 = Replication("r2", peers=[url1],
                     replicate_from=f"http://127.0.0.1:{relay.port}",
                     commit_quorum=1, election_quorum=1, ttl=30.0)
    h2, s2 = serve(port=0, durable=DurableStore(str(tmp_path / "d2")),
                   replication=r2)
    c = m("cache.remote_cluster").RemoteCluster(url1, start_watch=False)
    seen = []
    try:
        c.lease("l0", "h", ttl=30.0)
        chaoslib.wait_for(lambda: r2._caught_up and
                          s2.durable.synced_seq >= s1.durable.synced_seq,
                          20, "the follower caught up")
        relay.stall()
        for i in range(5):      # the leader moves on alone
            c.lease(f"l{i + 1}", "h", ttl=30.0)
        t_end = time.monotonic() + 2.5
        while time.monotonic() < t_end:
            st = r2.status()
            seen.append((st["lag_s"], st["applied_seq"],
                         s1.durable.synced_seq))
            time.sleep(0.1)
    finally:
        c.close()
        relay.close()
        for h, r in ((h2, r2), (h1, r1)):
            h.shutdown()
            h.server_close()
            r.stop()
    return seen


def test_stalled_follower_advertises_the_age_of_its_last_proof(tmp_path):
    """The conductor's bounded_staleness finding (seed 1, the
    replication class, run beside another run): a follower that had just
    proved itself caught up, whose next poll then stalled on the
    partitioned link, advertised lag 0.0 while its applied rv trailed
    the leader's.  Forced here on both sides: the reference claims 0.0
    with a trailing WAL sequence; the port's lag grows from the
    proof."""
    ref = _lag_while_the_link_stalls("volcano_tpu", tmp_path / "ref")
    port = _lag_while_the_link_stalls("volcano_tpu_torch",
                                      tmp_path / "port")
    # the reference: a reading that lies (lag 0, behind the leader)
    assert any(lag == 0.0 and applied < leader
               for lag, applied, leader in ref), ref
    # the port: never 0 behind the leader; the age of the proof grows
    assert not any(lag == 0.0 and applied < leader
                   for lag, applied, leader in port), port
    assert port[-1][0] >= 2.0 and port[-1][1] < port[-1][2], port


def _ledger_after_a_stale_flush(pkg):
    """A serving podgroup on each side's store: a controller's copy is
    taken, a node agent's report folds 120 requests in, then the stale
    copy is flushed back as a status write.  The ledger after it."""
    import copy
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    sapi = m("api.serving")
    pg_mod = m("api.podgroup")
    cluster = m("cache.fake_cluster").FakeCluster()
    cluster.add_podgroup(pg_mod.PodGroup(name="srv", min_member=1))
    pod = m("api.pod").make_pod("srv-0", requests={"cpu": 1})
    cluster.add_pod(pod)
    stale = copy.deepcopy(cluster.podgroups["default/srv"])
    cluster.put_object("servingreport", sapi.ServingReport(
        node="n0", ts=1.0, usages=[sapi.ReplicaServing(
            pod_key=pod.key, uid=pod.uid, job="default/srv", qps=10.0,
            requests=120, slo_ok=120)]))
    before = sapi.ann_float(cluster.podgroups["default/srv"].annotations,
                            sapi.PG_REQUESTS_ANNOTATION)
    cluster.update_podgroup_status(stale)
    after = sapi.ann_float(cluster.podgroups["default/srv"].annotations,
                           sapi.PG_REQUESTS_ANNOTATION)
    return before, after


def test_stale_status_flush_keeps_the_serving_ledger():
    """The conductor's serving_monotonic finding (seed 1, wire,serving,
    2 of 5 runs of the reference's conductor here): the store kept the
    goodput fold across a status flush from a stale copy but not the
    serving fold, so the folded request ledger went back.  The
    reference rewinds it to the stale copy's; the port keeps it."""
    assert _ledger_after_a_stale_flush("volcano_tpu") == (120.0, 0.0)
    assert _ledger_after_a_stale_flush("volcano_tpu_torch") == (120.0, 120.0)


def test_bench_chaos_smoke_mode():
    """`python -m volcano_tpu_torch.bench --chaos-smoke` drives the three
    headline gray failures through real OS processes: one ack-lost
    bind, one ENOSPC degrade-and-recover, one CRC-corrupt replay
    refusal."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--chaos-smoke", 180))
    assert out["ok"] is True, out
    assert out["ack_lost_bind"]["fault_injected"] == 1
    assert out["ack_lost_bind"]["bound_once"]
    assert out["enospc_degrade"]["writes_503"]
    assert out["enospc_degrade"]["leases_served"]
    assert out["enospc_degrade"]["healed_writable"]
    assert out["enospc_degrade"]["rv_monotonic"]
    assert out["crc_corrupt_replay"]["refused"]
    assert out["crc_corrupt_replay"]["prefix_intact"]

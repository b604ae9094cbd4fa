"""The secured, replicated and partitioned control plane of the port held
against the reference's, on mirrored inputs, as planes on loopback.

Mirrors: a TPU v5e-16 (4 hosts x 4 chips) is a 4 x 4 NVLink domain, a
v5e-4 a 1 x 4 host, a DCN pod an IB fabric, node names equal; `jax`
jobs are `torch` jobs and google.com/tpu is nvidia.com/gpu.

- The TLS and bearer-token plane (the reference's
  `test_tls_bearer_auth_control_plane`): each side's server, controllers
  and scheduler as processes over TLS with the token; the same gang
  bound to the same nodes and completed, and the same refusals of plain
  HTTP, of a write without the token and of a client with a wrong one.
- The keyspace-partitioned write plane (the reference's `part` fixture
  and its tests in `tests/test_sharding.py`): the same layout, the same
  relocation of a bound pod to its node's group, one `/bind_batch` a
  group for a gang across the groups, the same gang bound in part when
  another shard wins one group's GPUs first, the meta kinds on group 0,
  and the same `vtpctl shards` tables.
- The node-agent daemon with `collectors:local,gpu` (the reference's
  `local,tpu`), its chip collector pointed at a directory of device
  files (nvidia0..3 on the port's side, accel0..3 on the reference's):
  the same verdicts, annotations, cordon and events as a file is removed
  and restored across the handler's FAIL_SYNCS and RECOVER_SYNCS.
- Three replicas with quorum commit and election: the leader killed
  with SIGKILL, and the same acked writes kept on the new leader and
  the surviving follower on both sides; a mirror whose watch was on
  the killed replica, which stays stale on the reference's side and
  moves to the next replica on the port's; and a TLS replica's own URL,
  which the reference gives the http scheme (its followers' leader
  hints then send clients to plain HTTP) and the port https.
- Failover off the failed NVLink domain, on a two-domain cluster: the
  controller's reschedule, resume and MTTR each observed once on both
  sides, after equal cycles.

Tolerance: exact.
"""

import importlib
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import pytest

from test_torch_multiprocess import wait_for
from torch_procs import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA-H100-80GB-HBM3"
GRACE_S = 2.0
WATCH_S = 10.0      # a mirror's wait for writes made after a failover
# a 4 x 4 unit and a one-host unit of 4 devices: (hosts, devices a host)
SHAPES = {"v5e-16": (4, 4), "v5e-4": (1, 4)}
# the reference's words -> the port's, in events and tables
WORDS = (("TPUUnhealthy", "GPUUnhealthy"), ("TPURecovered", "GPURecovered"),
         ("TPU chips", "GPUs"), ("chips", "GPUs"), ("TPU", "GPU"))


def _side(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    ref = pkg == "volcano_tpu"
    return types.SimpleNamespace(
        pkg=pkg, ref=ref, m=m,
        device="google.com/tpu" if ref else "nvidia.com/gpu",
        plugin="jax" if ref else "torch",
        collector="tpu" if ref else "gpu",
        device_file="accel" if ref else "nvidia")


REF, PORT = _side("volcano_tpu"), _side("volcano_tpu_torch")


def _norm(text):
    for tpu, gpu in WORDS:
        text = text.replace(tpu, gpu)
    return text


def unit_nodes(s, name, kind, fabric):
    """One unit's host nodes, labelled as each side's simulator does."""
    if s.ref:
        topo = s.m("api.devices.tpu.topology")
        return s.m("simulator").slice_nodes(topo.slice_for(name, kind),
                                            dcn_pod=fabric)
    hosts, gpus = SHAPES[kind]
    topo = s.m("api.devices.gpu.topology")
    return s.m("simulator").domain_nodes(
        topo.DomainTopology(name, H100, hosts, gpus), ib_fabric=fabric)


def unit_cluster(s, units):
    """A FakeCluster of (name, kind, fabric) units, the hypernode tree
    discovered."""
    cluster = s.m("cache.fake_cluster").FakeCluster()
    for name, kind, fabric in units:
        for node in unit_nodes(s, name, kind, fabric):
            cluster.add_node(node)
    hnc = s.m("controllers.hypernode").HyperNodeController()
    hnc.initialize(cluster)
    hnc.sync()
    return cluster


def gang(s, name, run_ticks=0, replicas=4):
    """A gang of `replicas` pods of 4 devices held to one unit."""
    t = s.m("api.types")
    vc = s.m("api.vcjob")
    ann = {t.RUN_TICKS_ANNOTATION: str(run_ticks)} if run_ticks else {}
    return vc.VCJob(
        name=name, min_available=replicas, plugins={s.plugin: [], "svc": []},
        network_topology=s.m("api.podgroup").NetworkTopologySpec(
            t.NetworkTopologyMode.HARD, 1),
        tasks=[vc.TaskSpec(name="worker", replicas=replicas,
                           template=s.m("api.pod").make_pod(
                               "t", requests={"cpu": 8, s.device: 4},
                               annotations=ann))])


class Procs:
    """One side's processes, reaped in the reverse of their start."""

    def __init__(self, s, tmp_path):
        self.s, self.tmp_path, self.procs = s, tmp_path, {}

    def spawn(self, name, *argv):
        log = open(self.tmp_path / f"{self.s.pkg}-{name}.log", "w")
        self.procs[name] = subprocess.Popen(
            [sys.executable, *argv], stdout=log, stderr=log, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))

    def kill(self, name, sig=signal.SIGKILL):
        proc = self.procs.pop(name)
        if proc.poll() is None:
            proc.send_signal(sig)
            try:
                proc.wait(timeout=GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        return proc.returncode

    def shutdown(self):
        for name in reversed(list(self.procs)):
            self.kill(name, signal.SIGTERM)

    def log(self, name):
        return (self.tmp_path / f"{self.s.pkg}-{name}.log").read_text()

    def logs(self):
        return "\n".join(f"==== {f.name} ====\n{f.read_text()[-3000:]}"
                         for f in sorted(self.tmp_path.glob(
                             f"{self.s.pkg}-*.log")))


def up(url, ctx=None):
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=1,
                                    context=ctx):
            return True
    except OSError:
        return False


# -- the TLS and bearer-token plane ---------------------------------------

def tls_plane(s, tmp_path):
    """The reference's secured deployment on one side: its server, TLS
    only with a bearer token, its controllers and scheduler over the
    wire; a gang that completes, then the three refusals."""
    import ssl
    pytest.importorskip("cryptography")
    cert = str(tmp_path / f"{s.pkg}.crt")
    key = str(tmp_path / f"{s.pkg}.key")
    s.m("server.tlsutil").generate_self_signed(cert, key)
    token, port = "test-cluster-token", free_port()
    url = f"https://127.0.0.1:{port}"
    ctx = ssl.create_default_context(cafile=cert)
    client = s.m("cache.remote_cluster")
    procs, kubectl = Procs(s, tmp_path), None
    try:
        procs.spawn("server", "-m", f"{s.pkg}.server", "--port", str(port),
                    "--tick-period", "0.05", "--tls-cert", cert,
                    "--tls-key", key, "--token", token)
        wait_for(lambda: up(url, ctx), 20, f"{s.pkg}'s TLS server")
        kubectl = client.RemoteCluster(url, token=token, ca_cert=cert)
        for node in unit_nodes(s, "sa", "v5e-16", "dcn-0"):
            kubectl.add_node(node)
        for comps in ("controllers", "scheduler"):
            procs.spawn(comps, "-m", s.pkg, "--cluster-url", url,
                        "--components", comps, "--period", "0.1",
                        "--token", token, "--ca-cert", cert)
        kubectl.add_vcjob(gang(s, "secure", run_ticks=3))
        phase = lambda: kubectl.vcjobs["default/secure"].phase.value  # noqa
        try:
            wait_for(lambda: phase() == "Completed", 60, "the job completed")
        except AssertionError:
            raise AssertionError(procs.logs())
        placed = sorted(p.node_name for p in kubectl.pods.values()
                        if p.labels.get("volcano-tpu.io/job-name") ==
                        "secure")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=2):
                plain = "accepted"
        except OSError:
            plain = "refused"
        req = urllib.request.Request(
            url + "/objects/queue", method="POST", data=json.dumps(
                {"obj": s.m("api.codec").encode(
                    s.m("api.queue").Queue(name="anon"))}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=5, context=ctx)
            anon = 200
        except urllib.error.HTTPError as e:
            anon = e.code
        try:
            client.RemoteCluster(url, start_watch=False, token="wrong",
                                 ca_cert=cert)
            wrong = 200
        except client.RemoteError as e:
            wrong = e.code
        return dict(phase=phase(), placed=placed, plain=plain,
                    tokenless_write=anon, wrong_token=wrong)
    finally:
        if kubectl is not None:
            kubectl.close()
        procs.shutdown()


def test_tls_bearer_plane_matches_reference(tmp_path):
    ref, port = (tls_plane(s, tmp_path) for s in (REF, PORT))
    assert port == ref
    assert port["phase"] == "Completed" and len(port["placed"]) == 4
    assert (port["plain"], port["tokenless_write"], port["wrong_token"]) \
        == ("refused", 401, 401)


# -- the keyspace-partitioned write plane ---------------------------------

class Part:
    """One side's `part` fixture: three in-process servers behind a
    PartitionedCluster, six 4 x 4 units pushed through it."""

    def __init__(self, s, n_units=6):
        self.s = s
        serve = s.m("server.state_server").serve
        self.srvs = [serve(port=0) for _ in range(3)]
        self.urls = ";".join(f"http://127.0.0.1:{h.server_address[1]}"
                             for h, _ in self.srvs)
        self.pc = s.m("cache.partitioned").PartitionedCluster(self.urls)
        src = unit_cluster(s, [(f"s{i}", "v5e-16", "dcn-0")
                               for i in range(n_units)])
        for n in src.nodes.values():
            self.pc.add_node(n)
        for hn in src.hypernodes.values():
            self.pc.add_hypernode(hn)
        self.src = src

    def close(self):
        self.pc.close()
        for h, _ in self.srvs:
            h.shutdown()
            h.server_close()


@pytest.fixture()
def parts():
    sides = []
    try:
        for s in (REF, PORT):
            s.m("api.pod")._uid_counter = itertools.count(1)
            sides.append(Part(s))
        yield sides
    finally:
        for p in sides:
            p.close()


def test_partitioned_layout_matches_reference(parts):
    rows = []
    for p in parts:
        layout = p.pc.shard_layout()
        assert sum(r["nodes"] for r in layout) == len(p.src.nodes)
        assert all(r["nodes"] > 0 for r in layout), layout
        assert len(p.pc.groups[0].hypernodes) == len(p.src.hypernodes)
        assert not any(g.hypernodes for g in p.pc.groups[1:])
        rows.append(([{k: r[k] for k in ("group", "nodes", "subtrees",
                                          "meta")} for r in layout],
                     [sorted(g.nodes) for g in p.pc.groups]))
    assert rows[1] == rows[0]


def test_partitioned_bind_relocates_as_reference(parts):
    out = []
    for p in parts:
        pc = p.pc
        pc.add_pod(p.s.m("api.pod").make_pod("p0", requests={"cpu": 1}))
        assert "default/p0" in pc.meta.pods
        group = next(i for i, g in enumerate(pc.groups) if i and g.nodes)
        target = sorted(pc.groups[group].nodes)[0]
        assert pc.bind_pods([("default", "p0", target)]) == [None]
        wait_for(lambda: "default/p0" not in p.srvs[0][1].cluster.pods and
                 "default/p0" in p.srvs[group][1].cluster.pods, 5,
                 "the pod relocated server-side")
        merged = pc.pods["default/p0"]
        other = next(n for n in sorted(pc.nodes) if n != target)
        again = pc.bind_pods([("default", "p0", other)])
        merged.status_message = "running along"
        pc.put_object("pod", merged)
        out.append((group, target, merged.node_name, merged.phase.value,
                    again[0] is not None,
                    pc.groups[group].pods["default/p0"].status_message))
    assert out[1] == out[0]
    assert out[1][2:] == (out[1][1], "Bound", True, "running along")


def test_partitioned_gang_binds_one_batch_a_group_as_reference(parts):
    out = []
    for p in parts:
        pc, calls = p.pc, []
        for g in pc.groups:
            orig = g._request

            def counting(method, path, *args, _orig=orig, _g=g, **kw):
                if path == "/bind_batch":
                    calls.append(id(_g))
                return _orig(method, path, *args, **kw)
            g._request = counting
        binds = []
        for g in pc.groups:
            node = sorted(g.nodes)[0]
            pod = p.s.m("api.pod").make_pod(f"gp-{node}",
                                            requests={"cpu": 1})
            pc.add_pod(pod)
            binds.append(("default", pod.name, node))
        errs = pc.bind_pods(binds)
        out.append((errs, len(calls), len(set(calls)),
                    sorted((k, v.node_name) for k, v in pc.pods.items())))
    assert out[1] == out[0]
    assert out[1][:3] == ([None] * 3, 3, 3)


def test_partitioned_meta_kinds_stay_on_group_zero_as_reference(parts):
    out = []
    for p in parts:
        pc = p.pc
        pc.add_podgroup(p.s.m("api.podgroup").PodGroup(name="pgx",
                                                       min_member=1))
        pc.add_queue(p.s.m("api.queue").Queue(name="tenant"))
        pc.add_command("default/pgx", "requeue")
        drained = [c["action"] for c in pc.drain_commands("default/pgx")]
        homes = ("default/pgx" in pc.groups[0].podgroups,
                 "tenant" in pc.groups[0].queues,
                 [("default/pgx" in g.podgroups, "tenant" in g.queues)
                  for g in pc.groups[1:]])
        out.append((drained, homes, "default/pgx" in pc.podgroups,
                    "tenant" in pc.queues))
    assert out[1] == out[0]
    assert out[1] == (["requeue"], (True, True, [(False, False)] * 2),
                      True, True)


def test_vtpctl_shards_matches_reference(parts, capsys):
    tables = []
    for p in parts:
        vtpctl = p.s.m("cli.vtpctl").main
        endpoints = ";".join(g.endpoints[0] for g in p.pc.groups)
        capsys.readouterr()
        assert vtpctl(["--server", endpoints, "shards", "--interval",
                       "0.1"]) == 0
        rows = [re.split(r"\s{2,}", line.strip())
                for line in capsys.readouterr().out.splitlines()
                if line.strip()]
        # the write-QPS column is a rate over the sampling interval
        tables.append([r[:3] if r[1:2] in (["meta+nodes"], ["nodes"])
                       else r for r in rows])
    assert tables[1] == tables[0]
    heads = [r[0] for r in tables[1]]
    assert "SHARD" in heads and "GROUP" in heads
    assert sum(1 for r in tables[1] if r[1:2] in (["meta+nodes"],
                                                  ["nodes"])) == 3


def test_cross_group_gang_conflict_binds_in_part_as_reference(parts):
    """A shard's gang over two groups whose second item loses its
    group's GPUs to another shard: each group's batch stands alone, so
    the gang is bound in part, on both sides (ROADMAP C.9); the refused
    pod stays pending in the meta group."""
    out = []
    for p in parts:
        pc, pod = p.pc, p.s.m("api.pod")
        t = p.s.m("api.types")
        n1, n2 = (sorted(pc.groups[i].nodes)[0] for i in (1, 2))
        pc.add_pod(pod.make_pod("hog", requests={"cpu": 1, p.s.device: 4}))
        assert pc.bind_pods([("default", "hog", n2)]) == [None]
        gang_pods = [pod.make_pod(f"g-{i}", requests={"cpu": 1,
                                                      p.s.device: 4},
                                  annotations={t.GROUP_NAME_ANNOTATION: "g"})
                     for i in range(2)]
        for gp in gang_pods:
            pc.add_pod(gp)
        cache = p.s.m("cache.cache").SchedulerCache(pc)
        cache.shard_plan = "1/2"
        for gp, node in zip(gang_pods, (n1, n2)):
            task = p.s.m("api.job_info").TaskInfo(gp)
            task.node_name = node
            cache.add_bind_task(task)
        bound = cache.flush_binds()
        servers = [sorted((k, q.node_name, q.phase.value)
                          for k, q in st.cluster.pods.items()
                          if k.startswith("default/g-"))
                   for _, st in p.srvs]
        out.append((bound, [k for k, _ in cache.bind_failures], servers,
                    [_norm(e).split(": ", 1)[0]
                     for _, e in cache.bind_failures]))
    assert out[1] == out[0]
    assert out[1][:2] == (1, ["default/g-1"])
    assert out[1][2][0] == [("default/g-1", "", "Pending")]
    assert out[1][3] == ["cross-shard conflict (shard 1/2)"]


# -- the node-agent daemon -------------------------------------------------

def agent_daemon(s, tmp_path):
    """One side's node-agent daemon over the wire against a one-host
    unit, its chip collector on a directory of 4 device files; one file
    removed, then restored.  Returns each stage's verdict, annotation,
    label and cordon, the events, and the daemon's log."""
    serve = s.m("server.state_server").serve
    agent = s.m("agent.agent")
    httpd, state = serve(port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    devices = tmp_path / f"{s.pkg}-dev"
    devices.mkdir()
    for i in range(4):
        (devices / f"{s.device_file}{i}").touch()
    (node,) = unit_nodes(s, "h", "v5e-4", "dcn-0")
    state.cluster.add_node(node)
    procs = Procs(s, tmp_path)
    stages = []
    healthy_label = agent.TPU_HEALTHY_LABEL if s.ref else \
        agent.GPU_HEALTHY_LABEL
    chips_ann = agent.TPU_CHIPS_ANNOTATION if s.ref else \
        agent.GPU_CHIPS_ANNOTATION

    def stage(verdict, cordoned):
        def now():
            # the daemon posts its report before it writes the node, so
            # a stage is read once the node carries the report's sample
            rep = state.cluster.slicehealthreports.get(node.name)
            n = state.cluster.nodes[node.name]
            return rep is not None and rep.verdict == verdict and \
                n.unschedulable == cordoned and \
                n.annotations.get(chips_ann) == \
                f"{rep.chips_healthy}/{rep.chips_detected}"
        wait_for(now, 30, f"{s.pkg}'s agent verdict {verdict}")
        n = state.cluster.nodes[node.name]
        rep = state.cluster.slicehealthreports[node.name]
        stages.append((rep.verdict, rep.chips_detected, rep.chips_healthy,
                       n.annotations.get(chips_ann),
                       n.labels.get(healthy_label), n.unschedulable,
                       n.annotations.get(agent.AGENT_CORDONED_ANNOTATION)))
    try:
        procs.spawn("agent", "-m", s.pkg, "--cluster-url", url,
                    "--components", "none", "--node-agents", node.name,
                    "--usage-source", f"collectors:local,{s.collector}:"
                    f"{devices}/{s.device_file}[0-9]*",
                    "--enforcer", "record", "--period", "0.05")
        stage("Healthy", False)
        (devices / f"{s.device_file}3").unlink()
        stage("Failed", True)
        (devices / f"{s.device_file}3").touch()
        stage("Healthy", False)
        assert procs.kill("agent", signal.SIGTERM) == 0
        events = [(k, _norm(r), _norm(m)) for k, r, m in state.cluster.events
                  if r.endswith(("Unhealthy", "Recovered"))]
        return stages, events, procs.log("agent")
    finally:
        procs.shutdown()
        httpd.shutdown()
        httpd.server_close()


def test_agent_daemon_verdicts_match_reference(tmp_path):
    (ref, ref_events, _), (port, port_events, log) = (
        agent_daemon(s, tmp_path) for s in (REF, PORT))
    assert port == ref
    assert port_events == ref_events
    assert [v[0] for v in port] == ["Healthy", "Failed", "Healthy"]
    assert [v[3] for v in port] == ["4/4", "3/3", "4/4"]
    assert [r for _, r, _ in port_events] == ["GPUUnhealthy", "GPURecovered"]
    # the port's daemon logs its record enforcer's ledger at exit
    (ledger,) = re.findall(r"record enforcer ledger: (.*)", log)
    assert isinstance(json.loads(ledger), list)


def test_more_device_nodes_than_declared_is_healthy_on_both(tmp_path):
    """A container may show more driver device nodes than the GPUs it
    was given (one given a single H100 has shown two): the collector
    counts what it sees and the handler calls the host healthy while
    healthy >= declared, on both sides."""
    out = []
    for s in (REF, PORT):
        devices = tmp_path / s.pkg
        devices.mkdir()
        for i in range(6):
            (devices / f"{s.device_file}{i}").touch()
        cluster = unit_cluster(s, [("h", "v5e-4", "dcn-0")])
        (name,) = cluster.nodes
        collect = s.m("agent.collect")
        agent_mod = s.m("agent.agent")
        handlers = s.m("agent.handlers")
        handler = handlers.TpuHealthHandler if s.ref else \
            handlers.GpuHealthHandler
        provider = collect.build_provider(
            f"{s.collector}:{devices}/{s.device_file}[0-9]*")
        ag = agent_mod.NodeAgent(cluster, name, provider=provider,
                                 handlers=[handler])
        for _ in range(handler.FAIL_SYNCS):
            ag.sync()
        rep = cluster.slicehealthreports[name]
        out.append((rep.verdict, rep.chips_detected, rep.chips_healthy,
                    cluster.nodes[name].unschedulable))
    assert out[1] == out[0] == ("Healthy", 6, 6, False)


# -- three replicas with quorum commit and election -----------------------

def replica_group(s, tmp_path):
    """One side's three server processes, r1 the seed leader, quorum 2
    of 3 for commit and election; 8 queues written, the leader killed
    with SIGKILL, 8 more written through the same client.  Returns what
    the new leader and the surviving follower hold."""
    client = s.m("cache.remote_cluster")
    Queue = s.m("api.queue").Queue
    ports = {r: free_port() for r in ("r1", "r2", "r3")}
    urls = {r: f"http://127.0.0.1:{p}" for r, p in ports.items()}
    procs, kubectl = Procs(s, tmp_path), None

    def start(rid, follow=""):
        argv = ["-m", f"{s.pkg}.server", "--port", str(ports[rid]),
                "--data-dir", str(tmp_path / f"{s.pkg}-{rid}"),
                "--replica-id", rid, "--peers",
                ",".join(u for r, u in urls.items() if r != rid),
                "--commit-quorum", "2", "--election-quorum", "2",
                "--repl-ttl", "1.0"]
        procs.spawn(rid, *argv, *(["--replicate-from", follow]
                                  if follow else []))
        wait_for(lambda: up(urls[rid]), 20, f"{s.pkg} {rid}")

    def status(rid):
        try:
            with urllib.request.urlopen(urls[rid] + "/replication",
                                        timeout=2) as r:
                return json.loads(r.read())
        except OSError:
            return {}

    def write(names):
        for name in names:
            deadline = time.monotonic() + 30
            while True:
                try:
                    kubectl.add_queue(Queue(name=name, weight=1))
                    break
                except client.RemoteError as e:
                    # a new leader refuses writes until a follower has
                    # joined it and the commit quorum holds
                    if e.code != 503 or time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
    try:
        start("r1")
        for rid in ("r2", "r3"):
            start(rid, follow=urls["r1"])
        wait_for(lambda: all(status(r).get("proven") for r in ("r2", "r3")),
                 30, f"{s.pkg}'s followers proven")
        kubectl = client.RemoteCluster(",".join(urls.values()))
        # a mirror that reads through the group, its watch on r1
        reader = client.RemoteCluster(",".join(urls.values()))
        reader._read_idx = 0
        before = [f"q{i}" for i in range(8)]
        write(before)
        wait_for(lambda: set(before) <= set(reader.queues), 10,
                 "the reader's mirror")
        procs.kill("r1")
        after = [f"q{i}" for i in range(8, 16)]
        write(after)
        try:
            wait_for(lambda: set(after) <= set(reader.queues), WATCH_S)
            mirror = "caught up"
        except AssertionError:
            mirror = "stale"
        reader.close()
        leader = next(r for r in ("r2", "r3")
                      if status(r).get("role") == "leader")
        follower = "r3" if leader == "r2" else "r2"
        lead = status(leader)
        wait_for(lambda: status(follower).get("applied_rv", -1) >=
                 lead["applied_rv"], 30, "the follower caught up")
        held = {}
        for rid in (leader, follower):
            with urllib.request.urlopen(urls[rid] + "/snapshot",
                                        timeout=10) as r:
                held[rid] = sorted(json.loads(r.read())["stores"]["queue"])
        return dict(leader=held[leader], follower=held[follower],
                    acked=sorted(before + after), term=lead["term"] > 1,
                    roles=sorted(status(r).get("role")
                                 for r in ("r2", "r3"))), mirror
    except AssertionError:
        raise AssertionError(procs.logs())
    finally:
        if kubectl is not None:
            kubectl.close()
        procs.shutdown()


def test_leader_kill_keeps_acked_writes_as_reference(tmp_path):
    """Also a watching mirror whose replica was the killed leader: the
    reference's watch long-polls with the client's retries off, so
    nothing moves it to another replica and it stays stale; the port's
    asks the next replica and sees the writes made after the kill."""
    (ref, ref_mirror), (port, port_mirror) = (
        replica_group(s, tmp_path) for s in (REF, PORT))
    assert port == ref
    acked = set(port["acked"])
    assert acked <= set(port["leader"]) and acked <= set(port["follower"])
    assert port["term"] and port["roles"] == ["follower", "leader"]
    assert (ref_mirror, port_mirror) == ("stale", "caught up")


def test_tls_replica_url_scheme(tmp_path):
    """A replica serving TLS gives peers and clients its own URL (the
    leader hint of every follower 503, a candidate's campaign address).
    The reference writes it with the http scheme, so after a failover
    its clients follow the hint to plain HTTP, which the TLS listener
    refuses; the port writes https."""
    pytest.importorskip("cryptography")
    out = {}
    for s in (REF, PORT):
        cert, key = str(tmp_path / "c.crt"), str(tmp_path / "c.key")
        s.m("server.tlsutil").generate_self_signed(cert, key)
        repl = s.m("server.replication").Replication("r1")
        httpd, _ = s.m("server.state_server").serve(
            port=0, durable=s.m("server.durability").DurableStore(
                str(tmp_path / s.pkg)), replication=repl, tls_cert=cert,
            tls_key=key)
        try:
            out[s.pkg] = repl.leader_hint().partition("://")[0]
        finally:
            repl.stop()
            httpd.shutdown()
            httpd.server_close()
    assert out == {"volcano_tpu": "http", "volcano_tpu_torch": "https"}


# -- failover off the failed NVLink domain --------------------------------

CLOCK = {"t": 1000.0}
POOL = "volcano-tpu.io/smoke-failover"


def failover_off_domain(s, monkeypatch):
    """A one-host unit `a` and a spare one-host unit `b` in a fabric of
    its own, both in a pool the job selects, `b` cordoned until the job
    runs on `a`; `a` fails over the handler's K syncs, the controller
    drains the job and, `a` quarantined, it is rescheduled onto `b`."""
    monkeypatch.setattr(time, "time", lambda: CLOCK["t"])
    CLOCK["t"] = 1000.0
    s.m("api.pod")._uid_counter = itertools.count(1)
    metrics = s.m("metrics")
    sh = s.m("api.slicehealth")
    cluster = unit_cluster(s, [("a", "v5e-4", "dcn-0"),
                               ("b", "v5e-4", "dcn-1")])
    for n in cluster.nodes.values():
        n.labels[POOL] = "true"
    spare = cluster.nodes["b-w0"]
    spare.unschedulable = True
    cluster.admission = s.m("webhooks.admission").default_admission()
    mgr = s.m("controllers").ControllerManager(
        cluster, enabled=["job", "podgroup", "queue", "failover"])
    for ctrl in mgr.controllers:
        if hasattr(ctrl, "now"):
            ctrl.now = lambda: CLOCK["t"]
    sched = s.m("scheduler").Scheduler(cluster, schedule_period=0)
    vc = s.m("api.vcjob")
    job = cluster.add_vcjob(vc.VCJob(
        name="train", min_available=1, plugins={s.plugin: []},
        annotations={sh.CHECKPOINT_DIR_ANNOTATION: "/ckpt",
                     sh.LAST_STEP_ANNOTATION: "4"},
        tasks=[vc.TaskSpec(name="worker", replicas=1,
                           template=s.m("api.pod").make_pod(
                               "t", requests={"cpu": 4, s.device: 1},
                               node_selector={POOL: "true"}))]))

    def cycle(n=1):
        for _ in range(n):
            mgr.sync_all()
            sched.run_once()
            cluster.tick()
            CLOCK["t"] += 1.0

    def placed():
        return sorted(p.node_name for p in cluster.pods.values()
                      if p.owner == job.uid and p.node_name)
    cycle(3)
    first = placed()
    spare.unschedulable = False
    cluster.put_object("node", spare)
    provider = s.m("agent.agent").FakeUsageProvider()
    handlers = s.m("agent.handlers")
    handler = handlers.TpuHealthHandler if s.ref else \
        handlers.GpuHealthHandler
    ag = s.m("agent.agent").NodeAgent(cluster, "a-w0", provider=provider,
                                      handlers=[handler])
    s.m("simulator").fail_host(cluster, "a-w0", provider=provider,
                               chips_healthy=0)
    for _ in range(handler.FAIL_SYNCS):
        ag.sync()
    names = ("detect", "drain", "reschedule", "resume", "mttr")

    def counts():
        return {n: len(metrics.get_observations(f"failover_{n}_seconds",
                                                slice="a")) for n in names}
    before = counts()
    cycle(6)
    observed = {n: c - before[n] for n, c in counts().items()}
    env = next(p.containers[0].env for p in cluster.pods.values()
               if p.owner == job.uid)
    return dict(first=first, after=placed(),
                phase=cluster.vcjobs[job.key].phase.value,
                observed=observed,
                resume_step=env.get("VTP_RESUME_STEP"),
                events=[(k, _norm(r), _norm(m)) for k, r, m in cluster.events
                        if r.startswith(("Slice", "Failover"))])


def test_failover_off_the_failed_domain_matches_reference(monkeypatch):
    ref, port = (failover_off_domain(s, monkeypatch) for s in (REF, PORT))
    assert port == ref
    assert port["first"] == ["a-w0"] and port["after"] == ["b-w0"]
    assert port["phase"] == "Running" and port["resume_step"] == "4"
    assert port["observed"] == dict(detect=1, drain=1, reschedule=1,
                                    resume=1, mttr=1)


def test_bench_shard_smoke_mode():
    """`python -m volcano_tpu_torch.bench --shard-smoke` boots 2
    scheduler shards + 2 leader groups as real OS processes, runs one
    cross-shard gang, and asserts placements identical to the
    single-shard plane."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--shard-smoke", 240))
    assert out["ok"] is True, out
    assert out["placements_identical"] is True
    assert out["sharded"]["sched_shards_traced"] == ["0/2", "1/2"]
    assert all(d > 0 for d in out["sharded"]["leader_group_rv_delta"])
    assert out["sharded"]["jobs"] == out["single"]["jobs"]

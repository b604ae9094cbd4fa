"""The port's state server and cluster client against the reference's,
over real HTTP, both in one process.

Each scenario sends the same request stream to the reference's server
(`serve(port=0)`, TPU nodes under google.com/tpu) and to the port's
(GPU nodes under nvidia.com/gpu) through each side's `RemoteCluster`,
and records what came back: status codes and exception types, verdict
texts, the server's resource version after every request, and what a
second client's mirror converged on.  The two records must be equal
once the device's name is mapped (the guard's refusal says "chips" on
the reference and "GPUs" in the port).  The GPU guard is the TPU
guard's rule on nvidia.com/gpu: `/bind`, `/bind_batch` and whole-pod
PUT overcommit are refused, a pod's own booking rewritten is accepted,
Pending writes and GPU-less pods are never gated, and the guard's maps
follow node and pod deletions alike.  Tolerance: exact.
"""

import dataclasses
import gzip
import importlib
import json
import time
import types
import urllib.error
import urllib.request

import pytest

TPU, GPU = "google.com/tpu", "nvidia.com/gpu"


def _side(pkg, device):
    m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "api.node_info", "api.pod", "api.podgroup", "api.queue",
        "api.types", "api.vcjob", "api.job_info", "cache.cache",
        "cache.remote_cluster", "server.state_server",
        "webhooks.admission", "api.codec", "server.durability")}
    return types.SimpleNamespace(
        pkg=pkg, device=device, Node=m["api.node_info"].Node,
        make_pod=m["api.pod"].make_pod, PodGroup=m["api.podgroup"].PodGroup,
        Queue=m["api.queue"].Queue, types=m["api.types"],
        TaskSpec=m["api.vcjob"].TaskSpec, VCJob=m["api.vcjob"].VCJob,
        TaskInfo=m["api.job_info"].TaskInfo,
        SchedulerCache=m["cache.cache"].SchedulerCache,
        RemoteCluster=m["cache.remote_cluster"].RemoteCluster,
        serve=m["server.state_server"].serve,
        StateServer=m["server.state_server"].StateServer,
        DurableStore=m["server.durability"].DurableStore,
        AdmissionError=m["webhooks.admission"].AdmissionError,
        codec=m["api.codec"])


REF, PORT = _side("volcano_tpu", TPU), _side("volcano_tpu_torch", GPU)


def normalize(text: str) -> str:
    """A record's text with the device's names mapped to one token."""
    for a, b in ((TPU, "DEVICE"), (GPU, "DEVICE"),
                 ("GPUs bound", "DEVICES bound"),
                 ("chips bound", "DEVICES bound")):
        text = text.replace(a, b)
    return text


def wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


class Wire:
    """One side's in-process server and its clients."""

    def __init__(self, side, **serve_kw):
        self.side = side
        self.token = serve_kw.get("token", "")
        self.httpd, self.state = side.serve(port=0, **serve_kw)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.clients = []

    def client(self, **kw):
        kw.setdefault("token", self.token)
        c = self.side.RemoteCluster(self.url, **kw)
        self.clients.append(c)
        return c

    def close(self):
        for c in self.clients:
            c.close()
        self.httpd.shutdown()
        self.httpd.server_close()


class Record(list):
    """What one side answered, in order."""

    def __init__(self, wire):
        super().__init__()
        self.wire = wire

    def rv(self, label):
        self.append((label, "rv", self.wire.state._rv))

    def call(self, label, fn):
        """fn's value (normalized) or its exception's type, HTTP code
        and text; then the server's resource version."""
        try:
            value = fn()
            if dataclasses.is_dataclass(value):
                # an object the server stored: its kind and key (its
                # uid and creation time are minted, not answered)
                value = (type(value).__name__,
                         getattr(value, "key", None) or value.name)
            out = ("ok", normalize(repr(value)) if value is not None
                   else None)
        except Exception as e:  # noqa: BLE001 — the verdict is the record
            out = (type(e).__name__, getattr(e, "code", None),
                   normalize(str(e)))
        self.append((label, out))
        self.rv(label)
        return out


def run_both(scenario, **serve_kw):
    """The scenario's record on each side; the port's must equal the
    reference's."""
    records = []
    for side in (REF, PORT):
        wire = Wire(side, **serve_kw)
        try:
            rec = Record(wire)
            scenario(side, wire, rec)
            records.append(list(rec))
        finally:
            wire.close()
    ref, port = records
    assert port == ref
    return ref


def _gang(s, n=2, name="job1"):
    pg = s.PodGroup(name=f"pg-{name}", min_member=n, queue="default",
                    phase=s.types.PodGroupPhase.INQUEUE)
    pods = [s.make_pod(f"{name}-{i}", requests={"cpu": 1},
                       annotations={s.types.GROUP_NAME_ANNOTATION: pg.key})
            for i in range(n)]
    return pg, pods


def _mirror(c):
    return {attr: sorted(getattr(c, attr)) for attr in (
        "nodes", "pods", "podgroups", "queues", "vcjobs")}


def test_crud_and_watch_convergence():
    def scenario(s, wire, rec):
        a, b = wire.client(), wire.client()
        rec.call("node", lambda: a.add_node(
            s.Node(name="n0", allocatable={"cpu": "8"})))
        rec.call("queue", lambda: a.add_queue(s.Queue(name="tenant",
                                                      weight=3)))
        pg, pods = _gang(s)
        rec.call("podgroup", lambda: a.add_podgroup(pg))
        for p in pods:
            rec.call(p.name, lambda p=p: a.add_pod(p))
        wait_for(lambda: b._rv == wire.state._rv, msg="b converges")
        rec.append(("b", _mirror(b), b.queues["tenant"].weight))
        rec.call("delete", lambda: a.delete_pod(pods[0].key))
        wait_for(lambda: pods[0].key not in b.pods, msg="delete reaches b")
        rec.append(("b", _mirror(b)))

    out = run_both(scenario)
    assert ("b", {"nodes": ["n0"], "pods": ["default/job1-1"],
                  "podgroups": ["default/pg-job1"],
                  "queues": ["default", "tenant"], "vcjobs": []}) in out


def test_bind_evict_and_conflict():
    def scenario(s, wire, rec):
        a, b = wire.client(), wire.client()
        a.add_node(s.Node(name="n0", allocatable={"cpu": "8"}))
        a.add_pod(s.make_pod("p0", requests={"cpu": 1}))
        rec.call("bind", lambda: a.bind_pod("default", "p0", "n0"))
        rec.append(("phase", a.pods["default/p0"].phase.value))
        wait_for(lambda: b.pods.get("default/p0") is not None and
                 b.pods["default/p0"].node_name == "n0", msg="bind on b")
        rec.call("conflict", lambda: b.bind_pod("default", "p0", "n1"))
        rec.call("missing", lambda: a.bind_pod("default", "nope", "n0"))
        rec.call("evict", lambda: a.evict_pod("default", "p0", "test"))
        wait_for(lambda: b.pods["default/p0"].phase is
                 s.types.TaskStatus.RELEASING, msg="evict on b")
        rec.call("tick", a.tick)
        wait_for(lambda: "default/p0" not in b.pods, msg="tick deletes")
        rec.append(("b", _mirror(b)))

    out = run_both(scenario)
    assert [o[1][0] for o in out if o[0] in ("conflict", "missing")
            and o[1] != "rv"] == ["ValueError", "KeyError"]


def test_admission_runs_server_side():
    def scenario(s, wire, rec):
        a = wire.client()
        bad = s.VCJob(name="bad", min_available=5, tasks=[s.TaskSpec(
            name="w", replicas=2, template=s.make_pod("t"))])
        rec.call("bad", lambda: a.add_vcjob(bad))
        rec.append(("stored", "default/bad" in a.vcjobs))
        good = s.VCJob(name="good", min_available=2, tasks=[s.TaskSpec(
            name="w", replicas=2,
            template=s.make_pod("t", requests={s.device: 4}))])
        rec.call("good", lambda: a.add_vcjob(good).queue)

    out = run_both(scenario)
    assert out[0][1][0] == "AdmissionError"
    assert ("good", ("ok", "'default'")) in out


def test_bind_batch_matches_per_pod_semantics():
    def scenario(s, wire, rec):
        a, b = wire.client(), wire.client()
        a.add_node(s.Node(name="n0", allocatable={"cpu": "32", "pods": 110}))
        for i in range(4):
            a.add_pod(s.make_pod(f"g-{i}", requests={"cpu": 1}))
        a.add_node(s.Node(name="n1", allocatable={"cpu": "8", "pods": 110}))
        a.bind_pod("default", "g-2", "n1")
        rec.call("batch", lambda: a.bind_pods([
            ("default", "g-0", "n0"), ("default", "g-2", "n0"),
            ("default", "missing", "n0"), ("default", "g-3", "n0")]))
        pods = wire.state.cluster.pods
        rec.append(("nodes", {k: p.node_name for k, p in pods.items()}))
        wait_for(lambda: b.pods.get("default/g-3") is not None and
                 b.pods["default/g-3"].node_name == "n0", msg="batch on b")

    out = run_both(scenario)
    verdicts = out[0][1][1]
    assert "conflict" in verdicts and "not found" in verdicts


def test_flush_binds_goes_through_bind_batch():
    def scenario(s, wire, rec):
        a = wire.client(start_watch=False)
        a.add_node(s.Node(name="n0", allocatable={"cpu": "32", "pods": 110}))
        pods = [s.make_pod(f"fb-{i}", requests={"cpu": 1}) for i in range(3)]
        for p in pods:
            a.add_pod(p)
        calls = []
        orig = a._request
        a._request = lambda m, p, *args, **kw: (
            calls.append(p), orig(m, p, *args, **kw))[1]
        cache = s.SchedulerCache(a)
        for p in pods:
            t = s.TaskInfo(p)
            t.node_name = "n0"
            cache.add_bind_task(t)
        rec.call("flush", cache.flush_binds)
        rec.append(("calls", calls))

    out = run_both(scenario)
    assert ("calls", ["/bind_batch"]) in out


def _stale_clients(s, wire):
    a = wire.client()
    stale = wire.client(start_watch=False)
    calls = []
    orig = stale._request
    stale._request = lambda m, p, *args, **kw: (
        calls.append(p.partition("?")[0]), orig(m, p, *args, **kw))[1]
    return a, stale, calls


def test_delta_resync_equals_full_refetch():
    def scenario(s, wire, rec):
        a, stale, calls = _stale_clients(s, wire)
        a.add_node(s.Node(name="n0", allocatable={"cpu": "32", "pods": 110}))
        for i in range(5):
            a.add_pod(s.make_pod(f"d-{i}", requests={"cpu": 1}))
        rec.call("bind", lambda: a.bind_pod("default", "d-0", "n0"))
        rec.call("evict", lambda: a.evict_pod("default", "d-1", "test"))
        rec.call("tick", a.tick)
        rec.call("delete", lambda: a.delete_pod("default/d-2"))
        rec.call("pg", lambda: a.add_podgroup(s.PodGroup(name="pg-x",
                                                         min_member=1)))
        rec.call("resync", stale.resync)
        rec.append(("calls", calls))
        fresh = wire.client(start_watch=False)
        rec.append(("stale", _mirror(stale), _mirror(fresh)))
        rec.append(("pods", {k: (p.node_name, p.phase.value)
                             for k, p in stale.pods.items()}))

    out = run_both(scenario)
    assert ("calls", ["/watch"]) in out
    stale = next(o for o in out if o[0] == "stale")
    assert stale[1] == stale[2]


def test_delta_resync_falls_back_on_compaction():
    def scenario(s, wire, rec):
        a, stale, calls = _stale_clients(s, wire)
        for i in range(6):
            rec.call(f"c{i}", lambda i=i: a.add_node(
                s.Node(name=f"c{i}", allocatable={"cpu": "8"})))
        st = wire.state
        with st._event_cv:
            while st._events and st._events[0][0] <= stale._rv + 2:
                st._events.popleft()
        rec.call("resync", stale.resync)
        rec.append(("calls", calls, sorted(stale.nodes)))

    out = run_both(scenario)
    assert out[-1][1] == ["/watch", "/snapshot"]


def test_gzip_of_large_bodies():
    def scenario(s, wire, rec):
        c = wire.client()
        for i in range(30):
            c.add_node(s.Node(name=f"gz{i}", allocatable={"cpu": 8}))
        req = urllib.request.Request(wire.url + "/snapshot",
                                     headers={"Accept-Encoding": "gzip"})
        with urllib.request.urlopen(req, timeout=5) as r:
            enc = r.headers.get("Content-Encoding")
            nodes = sorted(json.loads(gzip.decompress(r.read()))
                           ["stores"]["node"])
        rec.append(("gzip", enc, nodes))
        with urllib.request.urlopen(wire.url + "/snapshot", timeout=5) as r:
            rec.append(("plain", r.headers.get("Content-Encoding")))
        req = urllib.request.Request(wire.url + "/healthz",
                                     headers={"Accept-Encoding": "gzip"})
        with urllib.request.urlopen(req, timeout=5) as r:
            rec.append(("small", r.headers.get("Content-Encoding")))
        req = urllib.request.Request(
            wire.url + "/bind", method="POST",
            data=json.dumps({"namespace": "default", "name": "x" * 600,
                             "node_name": "n0"}).encode(),
            headers={"Content-Type": "application/json",
                     "Accept-Encoding": "gzip"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        rec.append(("error", e.value.code,
                    e.value.headers.get("Content-Encoding"),
                    "not found" in json.loads(e.value.read())["error"]))
        rec.append(("mirror", len(wire.client(start_watch=False).nodes)))

    out = run_both(scenario)
    assert out[0][1] == "gzip" and len(out[0][2]) == 30
    assert ("error", 404, None, True) in out


def test_token_on_reads():
    def scenario(s, wire, rec):
        for path in ("/snapshot", "/leases", "/watch?timeout=0", "/audit"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(wire.url + path, timeout=5)
            rec.append((path, e.value.code))
        for path in ("/healthz", "/metrics"):
            with urllib.request.urlopen(wire.url + path, timeout=5) as r:
                rec.append((path, r.status))
        req = urllib.request.Request(
            wire.url + "/snapshot",
            headers={"Authorization": f"Bearer {wire.token}"})
        with urllib.request.urlopen(req, timeout=5) as r:
            rec.append(("/snapshot+token", r.status, "rv" in json.load(r)))
        c = wire.client()
        rec.call("node", lambda: c.add_node(
            s.Node(name="n0", allocatable={"cpu": 4})))
        wait_for(lambda: "n0" in c.nodes, msg="mirror sees the node")
        with pytest.raises(Exception) as e:
            s.RemoteCluster(wire.url, start_watch=False, token="wrong")
        rec.append(("wrong token", type(e.value).__name__,
                    getattr(e.value, "code", None)))

    out = run_both(scenario, token="s3cret")
    assert [o[1] for o in out[:4]] == [401] * 4
    assert ("/healthz", 200) in out and ("/metrics", 200) in out


# -- the GPU guard ----------------------------------------------------

def _guard_maps(state):
    return (dict(state._pod_chips), dict(state._chips_used),
            dict(state._node_chip_cap))


def _booked(s, name, node, devices, phase):
    pod = s.make_pod(name, requests={"cpu": 1, s.device: devices})
    pod.node_name = node
    pod.phase = phase
    return pod


def test_gpu_guard_refuses_overcommit_and_accepts_own_bookings():
    def scenario(s, wire, rec):
        st = s.types.TaskStatus
        a = wire.client()
        for n in ("t0", "t1"):
            a.add_node(s.Node(name=n, allocatable={"cpu": "8",
                                                   s.device: "4"}))
        a.add_pod(s.make_pod("w0", requests={"cpu": 1, s.device: 4}))
        rec.call("bind w0", lambda: a.bind_pod("default", "w0", "t0"))
        # /bind of one more 1-device pod onto the full node
        a.add_pod(s.make_pod("one", requests={"cpu": 1, s.device: 1}))
        rec.call("bind one", lambda: a.bind_pod("default", "one", "t0"))
        # re-binding a pod to the node it holds stays idempotent
        rec.call("rebind w0", lambda: a.bind_pod("default", "w0", "t0"))
        # /bind_batch: the third 2-device pod overcommits t1
        for i in range(3):
            a.add_pod(s.make_pod(f"b{i}", requests={"cpu": 1,
                                                    s.device: 2}))
        rec.call("batch", lambda: a.bind_pods(
            [("default", f"b{i}", "t1") for i in range(3)]))
        # a stale whole-pod write: Running on the full node
        rec.call("put ghost", lambda: a.put_object(
            "pod", _booked(s, "ghost", "t0", 1, st.RUNNING)))
        rec.call("put bound ghost", lambda: a.put_object(
            "pod", _booked(s, "ghost", "t0", 1, st.BOUND)))
        # the pod's own booking rewritten on its node
        rec.call("put w0", lambda: a.put_object(
            "pod", _booked(s, "w0", "t0", 4, st.RUNNING)))
        # Pending writes are never gated, even naming the full node
        rec.call("put pending", lambda: a.put_object(
            "pod", _booked(s, "ghost", "t0", 1, st.PENDING)))
        # a pod that requests no device is never gated
        a.add_pod(s.make_pod("cpu-only", requests={"cpu": 1}))
        rec.call("bind cpu-only", lambda: a.bind_pod("default", "cpu-only",
                                                     "t0"))
        cpu_pod = s.make_pod("cpu-put", requests={"cpu": 1})
        cpu_pod.node_name, cpu_pod.phase = "t0", st.RUNNING
        rec.call("put cpu-only", lambda: a.put_object("pod", cpu_pod))
        rec.append(("maps", _guard_maps(wire.state)))

    out = run_both(scenario)
    verdict = dict((o[0], o[1]) for o in out if o[1] != "rv")
    assert verdict["bind w0"][0] == "ok"
    assert verdict["bind one"][:2] == ("ValueError", None)
    assert "bind overcommit" in verdict["bind one"][2]
    assert verdict["rebind w0"][0] == "ok"
    assert "overcommit" in verdict["batch"][1] and \
        verdict["batch"][1].count("None") == 2
    assert verdict["put ghost"][0] == "ValueError"
    assert "put overcommit" in verdict["put ghost"][2]
    assert verdict["put bound ghost"][0] == "ValueError"
    for ok in ("put w0", "put pending", "bind cpu-only", "put cpu-only"):
        assert verdict[ok][0] == "ok", ok
    pod_chips, used, caps = verdict["maps"]
    assert used == {"t0": 4.0, "t1": 4.0}
    assert caps == {"t0": 4.0, "t1": 4.0}


def test_gpu_guard_maps_follow_deletions():
    def scenario(s, wire, rec):
        a = wire.client()
        for n in ("t0", "t1"):
            a.add_node(s.Node(name=n, allocatable={"cpu": "8",
                                                   s.device: "4"}))
        for name, node in (("w0", "t0"), ("w1", "t1")):
            a.add_pod(s.make_pod(name, requests={"cpu": 1, s.device: 4}))
            a.bind_pod("default", name, node)
        rec.append(("bound", _guard_maps(wire.state)))
        # the pod's deletion frees its node's booking
        rec.call("delete w0", lambda: a.delete_pod("default/w0"))
        rec.append(("pod deleted", _guard_maps(wire.state)))
        a.add_pod(s.make_pod("w2", requests={"cpu": 1, s.device: 4}))
        rec.call("bind w2", lambda: a.bind_pod("default", "w2", "t0"))
        # the node's deletion drops its capacity; its pods stay booked
        rec.call("remove t1", lambda: a.remove_node("t1"))
        rec.append(("node deleted", _guard_maps(wire.state)))
        # a bind onto the node that is gone is refused as missing (404)
        a.add_pod(s.make_pod("w3", requests={"cpu": 1, s.device: 4}))
        rec.call("bind w3", lambda: a.bind_pod("default", "w3", "t1"))
        # a node re-added with capacity is guarded again, counting the
        # booking that outlived it
        rec.call("re-add t1", lambda: a.add_node(
            s.Node(name="t1", allocatable={"cpu": "8", s.device: "4"})))
        a.add_pod(s.make_pod("w4", requests={"cpu": 1, s.device: 1}))
        rec.call("bind w4", lambda: a.bind_pod("default", "w4", "t1"))
        rec.append(("end", _guard_maps(wire.state)))

    out = run_both(scenario)
    verdict = dict((o[0], o[1]) for o in out if o[1] != "rv")
    assert verdict["pod deleted"][1] == {"t1": 4.0}
    assert verdict["bind w2"][0] == "ok"
    assert "t1" not in verdict["node deleted"][2]
    assert verdict["bind w3"][0] == "KeyError"
    assert verdict["bind w4"][0] == "ValueError"


def test_bench_wire_smoke_mode():
    """`python -m volcano_tpu_torch.bench --wire-smoke` boots the real
    process control plane at toy scale and reports the keys the full
    wire scenario does, as the reference's `bench.py --wire-smoke`."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--wire-smoke", 240))
    assert out["ok"] is True, out
    assert out["wire_gang_p50_s"] > 0
    assert out["scale"]["delta_resync_s"] > 0
    assert out["scale"]["audit_lost_records"] is False
    # accounting traffic rides the wire too: one usage report +
    # violation event round-tripped through the state server
    assert out["usage_roundtrip"]["usage_report_roundtrip_ok"] is True
    assert out["usage_roundtrip"]["violation_roundtrip_ok"] is True

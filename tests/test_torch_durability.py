"""Crash safety of the port's state server: the WAL, its snapshots and
replay, on GPU nodes.

The port's server alone: a WAL replay round trip that also rebuilds
the GPU guard's maps, snapshot compaction, a kill -9 in the middle of
`/bind_batch` bursts against `python -m volcano_tpu_torch.server`
(every acked bind survives, nothing is half applied, the resource
version resumes, a watching mirror converges by the delta lane),
bit-flip and sequence-gap refusal at boot, a torn tail, and
idempotency keys replayed rather than applied again.  Then one stream
sent to both servers: the same WAL records, in the same sequence, of
the same kinds.  Tolerance: exact.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from volcano_tpu_torch import faults, metrics
from volcano_tpu_torch.api import codec
from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
from volcano_tpu_torch.api.pod import make_pod
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
from volcano_tpu_torch.server.durability import (DurableStore,
                                                 WALCorruptionError)
from volcano_tpu_torch.server.state_server import StateServer, serve
from volcano_tpu_torch.simulator import domain_nodes
from torch_procs import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT = "NVIDIA-H100-80GB-HBM3"
GRACE_S = 2.0        # SIGTERM grace before SIGKILL in teardown


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def gpu_nodes(name="sa", hosts=4, gpus=4):
    return domain_nodes(DomainTopology(name, PRODUCT, hosts, gpus),
                        ib_fabric="f0")


def _pod(name, **requests):
    pod = make_pod("t", requests=requests or {"cpu": 1})
    pod.name, pod.namespace = name, "default"
    return pod


class DurableServer:
    """`python -m volcano_tpu_torch.server --data-dir` as an OS process
    that a test can SIGKILL and boot again in place."""

    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self.data_dir = str(tmp_path / "state")
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.proc = None
        self.boots = 0

    def spawn(self):
        self.boots += 1
        logf = open(self.tmp_path / f"server-{self.boots}.log", "w")
        env = dict(os.environ, PYTHONPATH=REPO)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.server",
             "--port", str(self.port), "--data-dir", self.data_dir],
            stdout=logf, stderr=logf, env=env, cwd=REPO)
        wait_for(self._up, 20, "server /healthz")

    def _up(self):
        try:
            with urllib.request.urlopen(self.url + "/healthz", timeout=1):
                return True
        except OSError:
            return False

    def durability(self) -> dict:
        with urllib.request.urlopen(self.url + "/durability",
                                    timeout=5) as r:
            return json.loads(r.read())

    def kill9(self):
        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=10)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=GRACE_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def test_wal_replay_roundtrip_rebuilds_the_gpu_guard(tmp_path):
    st = StateServer(durable=DurableStore(str(tmp_path / "d")))
    for node in gpu_nodes():
        st.cluster.add_node(node)
    st.cluster.add_pod(_pod("p0", cpu=1, **{GPU: 4}))
    st.cluster.bind_pod("default", "p0", "sa-w0")
    assert st.lease("scheduler", "holder-a", ttl=30.0)["acquired"]
    st.commit()
    rv1, base1 = st._rv, st.epoch.rsplit(".", 1)[0]
    assert st._chips_used == {"sa-w0": 4.0}

    st2 = StateServer(durable=DurableStore(str(tmp_path / "d")))
    assert len(st2.cluster.nodes) == 4
    assert st2.cluster.pods["default/p0"].node_name == "sa-w0"
    assert st2._rv == rv1
    base2, boot2 = st2.epoch.rsplit(".", 1)
    assert base2 == base1 and int(boot2) == 2
    r = st2.lease("scheduler", "holder-b", ttl=5.0)
    assert not r["acquired"] and r["holder"] == "holder-a"
    # the guard's maps come back from the replayed store
    assert st2._chips_used == {"sa-w0": 4.0}
    assert st2._node_chip_cap == {f"sa-w{i}": 4.0 for i in range(4)}
    assert st2.check_bind_capacity("default", "p0", "sa-w0") is None
    st2.cluster.add_pod(_pod("p1", cpu=1, **{GPU: 1}))
    assert "overcommit" in st2.check_bind_capacity("default", "p1", "sa-w0")


def test_snapshot_compaction_truncates_wal(tmp_path):
    store = DurableStore(str(tmp_path / "d"), snapshot_every_records=50)
    st = StateServer(durable=store)
    for node in gpu_nodes():
        st.cluster.add_node(node)
    for i in range(80):
        st.cluster.add_pod(_pod(f"p{i}"))
    st.commit()
    assert store.should_snapshot()
    st.write_snapshot()
    assert not store.should_snapshot()
    assert os.path.exists(tmp_path / "d" / "snapshot.json")
    st.cluster.bind_pod("default", "p0", "sa-w0")
    st.commit()

    st2 = StateServer(durable=DurableStore(str(tmp_path / "d")))
    assert len(st2.cluster.pods) == 80
    assert st2.cluster.pods["default/p0"].node_name == "sa-w0"
    assert st2._rv == st._rv
    assert st2.durable.replay_records <= 5


def test_kill9_mid_bind_batch_every_acked_bind_survives(tmp_path):
    server = DurableServer(tmp_path)
    kubectl = mirror = None
    try:
        server.spawn()
        kubectl = RemoteCluster(server.url, start_watch=False,
                                retry_deadline=5.0)
        node_names = []
        for node in gpu_nodes():
            kubectl.add_node(node)
            node_names.append(node.name)
        assert kubectl.lease("scheduler", "leader-1", ttl=60.0)["acquired"]
        mirror = RemoteCluster(server.url)
        delta_before = metrics.get_counter("mirror_resync_total",
                                           mode="delta")
        acked, requested = {}, {}
        stop_mark = [float("inf")]

        def burst():
            i = 0
            while time.monotonic() < stop_mark[0]:
                names = [f"b{i + j}" for j in range(16)]
                i += 16
                try:
                    for name in names:
                        kubectl.put_object("pod", _pod(name))
                    binds = [("default", n,
                              node_names[(i + j) % len(node_names)])
                             for j, n in enumerate(names)]
                    for ns, n, node in binds:
                        requested[f"{ns}/{n}"] = node
                    errs = kubectl.bind_pods(binds)
                except Exception:  # noqa: BLE001 — the outage window
                    continue
                for (ns, n, node), err in zip(binds, errs):
                    if err is None:
                        acked[f"{ns}/{n}"] = node

        burster = threading.Thread(target=burst)
        burster.start()
        wait_for(lambda: len(acked) >= 32, 10, "binds acked before the kill")
        rv_before = server.durability()["visible_rv"]
        server.kill9()
        stop_mark[0] = time.monotonic() + 1.0
        server.spawn()
        burster.join(timeout=30)
        assert not burster.is_alive()

        dur = server.durability()
        assert dur["enabled"] and dur["rv"] >= rv_before
        assert int(dur["epoch"].rsplit(".", 1)[1]) == 2
        snap = kubectl._request("GET", "/snapshot")
        pods = {k: codec.decode(v) for k, v in snap["stores"]["pod"].items()}
        lost = [k for k, node in acked.items()
                if k not in pods or pods[k].node_name != node]
        assert not lost, f"{len(lost)} acked binds lost: {lost[:5]}"
        for key, pod in pods.items():
            assert pod.node_name in ("", requested.get(key)), key
        wait_for(lambda: mirror._rv >= dur["visible_rv"]
                 and len(mirror.pods) == len(pods), 20,
                 "mirror convergence across the restart")
        assert {k: p.node_name for k, p in mirror.pods.items()} == \
            {k: p.node_name for k, p in pods.items()}
        assert metrics.get_counter("mirror_resync_total",
                                   mode="delta") > delta_before
        r = kubectl.lease("scheduler", "leader-2", ttl=5.0)
        assert not r["acquired"] and r["holder"] == "leader-1"
    finally:
        for c in (kubectl, mirror):
            if c is not None:
                c.close()
        server.stop()


def _seeded_store(tmp_path, n_pods=8):
    data_dir = str(tmp_path / "d")
    st = StateServer(durable=DurableStore(data_dir))
    for node in gpu_nodes():
        st.cluster.add_node(node)
    for i in range(n_pods):
        st.cluster.add_pod(_pod(f"p{i}"))
    st.cluster.bind_pod("default", "p0", "sa-w0")
    st.commit()
    st.durable.close()
    return st, data_dir


def _wal_segments(data_dir):
    return sorted(os.path.join(data_dir, n) for n in os.listdir(data_dir)
                  if n.startswith("wal-") and n.endswith(".log"))


def _flip_bit(seg):
    with open(seg, "rb") as f:
        n = sum(1 for ln in f if ln.strip())
    assert n >= 5
    faults.flip_record_bit(seg, n // 2)


def _drop_record(seg):
    with open(seg, "rb") as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    del lines[len(lines) // 2]
    with open(seg, "wb") as f:
        f.writelines(lines)


@pytest.mark.parametrize("damage, says", [(_flip_bit, "refusing to boot"),
                                          (_drop_record, "sequence gap")],
                         ids=["bit-flip", "sequence-gap"])
def test_corrupt_wal_refuses_boot(tmp_path, damage, says):
    st, data_dir = _seeded_store(tmp_path)
    damage(_wal_segments(data_dir)[0])
    with pytest.raises(WALCorruptionError) as ei:
        DurableStore(data_dir).recover()
    assert says in str(ei.value)
    # the operator's explicit override boots the prefix
    st2 = StateServer(durable=DurableStore(data_dir, force_truncate=True))
    assert 0 < st2._rv < st._rv
    assert len(st2.cluster.nodes) == 4


def test_torn_tail_drops_only_the_last_record(tmp_path):
    st, data_dir = _seeded_store(tmp_path)
    faults.truncate_at(_wal_segments(data_dir)[0], -7)
    st2 = StateServer(durable=DurableStore(data_dir))
    assert st2._rv == st._rv - 1
    assert len(st2.cluster.nodes) == 4


def test_idempotency_keys_replay_not_reapply(tmp_path):
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    httpd, state = serve(port=0, data_dir=str(tmp_path / "d"))
    c = None
    try:
        c = RemoteCluster(f"http://127.0.0.1:{httpd.server_address[1]}",
                          start_watch=False)
        job = VCJob(name="j1", min_available=1, tasks=[TaskSpec(
            name="w", replicas=1,
            template=make_pod("t", requests={"cpu": 1, GPU: 1}))])
        body = {"obj": codec.encode(job), "key": None, "_req_id": "create-1"}
        r1 = c._request("POST", "/objects/vcjob", dict(body))
        r2 = c._request("POST", "/objects/vcjob", dict(body))
        uid1 = codec.decode(r1["obj"]).uid
        assert codec.decode(r2["obj"]).uid == uid1
        for _ in range(2):
            c._request("POST", "/command", {
                "target": "default/j1", "action": "RestartJob",
                "_req_id": "cmd-1"})
        assert len(state.cluster.commands) == 1
        d1 = c._request("POST", "/drain_commands", {
            "target": "default/j1", "_req_id": "drain-1"})
        d2 = c._request("POST", "/drain_commands", {
            "target": "default/j1", "_req_id": "drain-1"})
        assert len(d1["commands"]) == 1 and d2["commands"] == d1["commands"]
        httpd.shutdown()
        httpd.server_close()
        state.durable.close()
        st2 = StateServer(durable=DurableStore(str(tmp_path / "d")))
        assert st2.replay_response("create-1") is not None
        assert st2.cluster.vcjobs["default/j1"].uid == uid1
    finally:
        if c is not None:
            c.close()
        httpd.shutdown()


def _wal_records(data_dir):
    """(seq, kind) of every record of the dir's WAL segments."""
    out = []
    for seg in _wal_segments(data_dir):
        with open(seg, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line.split(" ", 1)[1])
                    out.append((rec["q"], rec.get("rv"), rec["k"]))
    return out


def test_one_stream_writes_the_same_wal_on_both_servers(tmp_path):
    """The same request stream through the reference's server (TPU
    nodes) and the port's (GPU nodes): equal record counts, sequence
    numbers, resource versions and kinds, and an equal replay."""
    from test_torch_wire import PORT as PORT_WIRE
    from test_torch_wire import REF as REF_WIRE
    from volcano_tpu.api.devices.tpu.topology import SliceTopology
    from volcano_tpu.simulator import slice_nodes

    sides = {
        "ref": (REF_WIRE, slice_nodes(SliceTopology(
            "sa", "tpu-v5-lite-podslice", (4, 4)), dcn_pod="f0")),
        "port": (PORT_WIRE, gpu_nodes())}
    records, durability = {}, {}
    for name, (s, nodes) in sides.items():
        data_dir = str(tmp_path / name)
        httpd, state = s.serve(port=0, data_dir=data_dir)
        c = s.RemoteCluster(f"http://127.0.0.1:{httpd.server_address[1]}",
                            start_watch=False)
        try:
            for node in nodes:
                c.add_node(node)
            for i in range(6):
                c.add_pod(s.make_pod(f"w{i}", requests={"cpu": 1,
                                                        s.device: 4}))
            errs = c.bind_pods([("default", f"w{i}", f"sa-w{i % 4}")
                                for i in range(6)])
            assert [e is None for e in errs] == [True] * 4 + [False] * 2
            c.add_command("default/j", "RestartJob")
            c.lease("scheduler", "s1", ttl=30.0)
            c._request("POST", "/command", {
                "target": "default/j", "action": "ResumeJob",
                "_req_id": "k1"})
            c.evict_pod("default", "w0", "test")
            c.tick()
            c.delete_pod("default/w5")
            durability[name] = {k: v for k, v in
                                c._request("GET", "/durability").items()
                                if k in ("rv", "visible_rv", "last_seq",
                                         "synced_seq", "wal_records")}
        finally:
            c.close()
            httpd.shutdown()
            httpd.server_close()
            state.durable.close()
        records[name] = _wal_records(data_dir)
        st2 = s.StateServer(durable=s.DurableStore(data_dir))
        durability[name]["replayed"] = (st2._rv, sorted(st2.cluster.pods),
                                        dict(st2._chips_used))
    assert records["port"] == records["ref"]
    assert durability["port"] == durability["ref"]
    assert len(records["port"]) > 20
    assert [q for q, _, _ in records["port"]] == \
        list(range(1, len(records["port"]) + 1))



def test_bench_crash_smoke_mode():
    """`python -m volcano_tpu_torch.bench --crash-smoke` SIGKILLs a real
    server mid-burst and asserts the recovery invariants."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--crash-smoke", 180))
    assert out["ok"] is True, out
    assert out["acked_writes_lost"] == 0
    assert out["mirror_divergence"] == 0
    assert out["rv_regressions"] == 0
    assert out["rto_p50_s"] > 0

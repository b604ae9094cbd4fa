"""Replication of the port's state server: WAL shipping to a follower,
follower reads, the commit quorum and failover.

A follower refuses writes with the read-only 503 and the leader's URL,
and serves reads from its replica; a leader whose follower is gone
cannot reach its commit quorum and refuses the ack; an idempotency-
keyed write committed by the old leader and retried against the
promoted follower replays its recorded verdict.

The waits read the state their assertions read, never a proxy: the
follower's shipped horizon (its durable WAL sequence has reached the
leader's, so the write's idempotency record is there), and a finished
promotion (the role is leader and the epoch's boot half is bumped).

The reference's `Replication.promote` publishes the leader role before
it bumps the epoch, so a reader in between sees a leader with the
follower's epoch; the port bumps the epoch first.  A test holds
`on_promote` to force that window on both sides, and asks for a
higher-term vote inside it: both refuse it, as a leader does.  A deposed
leader that rejoins over its old data dir full-resyncs at the new term.
Tolerance: exact.
"""

import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
from volcano_tpu_torch.cache.remote_cluster import RemoteCluster, RemoteError
from volcano_tpu_torch.server.durability import DurableStore
from volcano_tpu_torch.server.replication import Replication
from volcano_tpu_torch.server.state_server import serve
from volcano_tpu_torch.simulator import domain_nodes


def wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class Pair:
    """An in-process leader and follower over real HTTP."""

    def __init__(self, tmp_path, commit_quorum=2):
        self.r1 = Replication("r1", commit_quorum=commit_quorum,
                              election_quorum=1, ttl=1.0)
        self.h1, self.s1 = serve(
            port=0, durable=DurableStore(str(tmp_path / "d1")),
            replication=self.r1)
        self.url1 = f"http://127.0.0.1:{self.h1.server_address[1]}"
        self.r2 = Replication("r2", peers=[self.url1],
                              replicate_from=self.url1,
                              commit_quorum=commit_quorum,
                              election_quorum=1, ttl=1.0)
        self.h2, self.s2 = serve(
            port=0, durable=DurableStore(str(tmp_path / "d2")),
            replication=self.r2)
        self.url2 = f"http://127.0.0.1:{self.h2.server_address[1]}"
        self.r1.peers = [self.url2]
        self.clients = []
        self.down = set()

    def client(self, url, **kw):
        c = RemoteCluster(url, start_watch=False, **kw)
        self.clients.append(c)
        return c

    def shipped(self):
        """The follower holds every record the leader made durable."""
        return self.s2.durable.synced_seq >= self.s1.durable.synced_seq

    def stop(self, which):
        h, r = {1: (self.h1, self.r1), 2: (self.h2, self.r2)}[which]
        self.down.add(which)
        h.shutdown()
        h.server_close()
        r.stop()

    def close(self):
        for c in self.clients:
            c.close()
        for which in (1, 2):
            if which not in self.down:
                self.stop(which)


def test_follower_refuses_writes_with_leader_hint(tmp_path):
    pair = Pair(tmp_path)
    try:
        c = pair.client(pair.url1)
        for node in domain_nodes(DomainTopology(
                "sa", "NVIDIA-H100-80GB-HBM3", 1, 8), ib_fabric="f0"):
            c.add_node(node)
        assert c.lease("sched", "s1", ttl=30.0)["acquired"]
        wait_for(pair.shipped, 20, "the follower's shipped horizon")
        req = urllib.request.Request(
            pair.url2 + "/command", method="POST",
            data=json.dumps({"target": "default/j",
                             "action": "Restart"}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=5)
            raise AssertionError("the follower accepted a write")
        except urllib.error.HTTPError as e:
            assert e.code == 503
            assert json.loads(e.read())["leader"] == pair.url1
            assert e.headers.get("Retry-After")
        f = pair.client(pair.url2)
        assert list(f.nodes) == ["sa-w0"]
        assert f.nodes["sa-w0"].allocatable["nvidia.com/gpu"] == 8
        assert f._request("GET", "/leases")["sched"]["holder"] == "s1"
        dur = f._request("GET", "/durability")
        assert dur["replication"]["role"] == "follower"
        assert dur["replication"]["applied_rv"] == dur["visible_rv"]
        assert dur["visible_rv"] <= dur["synced_rv"]
    finally:
        pair.close()


def test_quorum_commit_fences_a_lonely_leader(tmp_path):
    pair = Pair(tmp_path)
    try:
        c = pair.client(pair.url1, retry_deadline=2.0)
        c.add_command("default/ok", "Wake")
        wait_for(pair.shipped, 20, "the follower's shipped horizon")
        assert len(pair.s2.cluster.commands) == 1
        pair.stop(2)
        pair.r1.sync_timeout = 1.0
        t0 = time.monotonic()
        try:
            c.add_command("default/fenced", "Wake")
            raise AssertionError("a leader without its quorum acked")
        except RemoteError as e:
            assert e.code == 503 and "quorum" in str(e)
        assert time.monotonic() - t0 < 30
        assert c._request("GET", "/durability")["replication"]["role"] == \
            "leader"
    finally:
        pair.close()


def test_keyed_write_replays_on_promoted_follower(tmp_path):
    pair = Pair(tmp_path)
    try:
        c = pair.client(pair.url1)
        c._request("POST", "/command", {
            "target": "default/j", "action": "RestartJob",
            "_req_id": "cmd-failover-1"})
        wait_for(pair.shipped, 20, "the follower's shipped horizon")
        assert pair.s2.replay_response("cmd-failover-1") is not None
        assert len(pair.s2.cluster.commands) == 1
        old_epoch = pair.s1.epoch
        pair.stop(1)
        wait_for(lambda: pair.r2.role == "leader" and
                 pair.s2.epoch != old_epoch, 60,
                 "the follower's promotion to leader")
        f = pair.client(pair.url2)
        f._request("POST", "/command", {
            "target": "default/j", "action": "RestartJob",
            "_req_id": "cmd-failover-1"})
        assert len(pair.s2.cluster.commands) == 1, \
            "the keyed retry applied twice across the promotion"
        # the epoch keeps its base and bumps its boot half: mirrors
        # delta-resync across the promotion
        assert pair.s2.epoch.rsplit(".", 1)[0] == old_epoch.rsplit(".", 1)[0]
        assert int(pair.s2.epoch.rsplit(".", 1)[1]) == \
            int(old_epoch.rsplit(".", 1)[1]) + 1
    finally:
        pair.close()


def _dead_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _promotion_window(pkg, tmp_path):
    """A follower of `pkg` (its leader gone, no campaign of its own)
    promoted at the next term with its state's `on_promote` held.  While
    it is held, a candidate at a higher term and with a longer history
    asks for its vote, the leader's silence past the TTL.  Returns the
    epoch before, (role, epoch) read while `on_promote` is held, the
    vote's answer, and (promote's result, role, epoch) after it ran."""
    serve = importlib.import_module(f"{pkg}.server.state_server").serve
    Durable = importlib.import_module(f"{pkg}.server.durability").DurableStore
    Repl = importlib.import_module(f"{pkg}.server.replication").Replication
    dead = _dead_url()
    repl = Repl("r2", peers=[dead], replicate_from=dead, commit_quorum=1,
                election_quorum=1, ttl=3600.0)
    httpd, st = serve(port=0, durable=Durable(str(tmp_path / pkg)),
                      replication=repl)
    held, release = threading.Event(), threading.Event()
    bump = st.on_promote

    def held_on_promote():
        held.set()
        release.wait(30)
        bump()
    st.on_promote = held_on_promote
    try:
        old = st.epoch
        result = []
        t = threading.Thread(
            target=lambda: result.append(repl.promote(repl.term + 1)))
        t.start()
        assert held.wait(30), "promote never reached on_promote"
        time.sleep(0.2)
        during = (repl.role, st.epoch)
        repl._last_leader_ok = time.monotonic() - 2 * repl.ttl
        vote = repl.handle_campaign({
            "term": repl.term + 5, "last_seq": 10 ** 9,
            "log_term": 10 ** 9, "candidate": "r9", "url": ""})
        release.set()
        t.join(30)
        return old, during, vote, (result[0], repl.role, st.epoch)
    finally:
        release.set()
        httpd.shutdown()
        httpd.server_close()
        repl.stop()


def test_promotion_publishes_the_role_after_the_epoch(tmp_path):
    old, during, vote, after = _promotion_window("volcano_tpu", tmp_path)
    assert during == ("leader", old), \
        "the reference no longer shows a leader with the old epoch"
    assert not vote["granted"]
    assert after == (True, "leader", after[2]) and after[2] != old
    old, during, vote, after = _promotion_window("volcano_tpu_torch",
                                                 tmp_path)
    assert during[0] != "leader" and during[1] == old
    # a promotion under way refuses votes as the leader it becomes does:
    # it is never left half-promoted
    assert not vote["granted"]
    assert after == (True, "leader", after[2]) and after[2] != old
    assert after[2].rsplit(".", 1)[0] == old.rsplit(".", 1)[0]


def _add_pods(st, names):
    from volcano_tpu_torch.api.pod import make_pod
    for name in names:
        pod = make_pod("t", requests={"cpu": 1})
        pod.name, pod.namespace = name, "default"
        st.cluster.add_pod(pod)
    st.commit()


def test_term_mismatch_forces_full_resync(tmp_path):
    """A deposed leader that rejoins over its old data dir (a stale term
    and a diverged tail it never shipped) full-resyncs from the promoted
    leader's snapshot and discards that tail.  The wait reads what the
    assertions read: the bootstrap is counted after the snapshot is
    installed and the term persisted, so a wait on the pods and the term
    alone can read the count before it moves."""
    r1 = Replication("r1", commit_quorum=1)
    h1, s1 = serve(port=0, durable=DurableStore(str(tmp_path / "da")),
                   replication=r1)
    url1 = f"http://127.0.0.1:{h1.server_address[1]}"
    _add_pods(s1, [f"s{i}" for i in range(4)])
    r2 = Replication("r2", peers=[url1], replicate_from=url1,
                     commit_quorum=1)
    h2, s2 = serve(port=0, durable=DurableStore(str(tmp_path / "db")),
                   replication=r2)
    h3 = r3 = None
    try:
        wait_for(lambda: len(s2.cluster.pods) == 4, 20,
                 "the follower synced to the first leader")
        # the first leader dies; the follower promotes first, so no
        # in-flight poll can ship the diverged record below
        h1.shutdown()
        h1.server_close()
        r1.stop()
        assert r2.promote(r2.term + 1)
        _add_pods(s1, ["diverged"])
        s1.durable.close()
        _add_pods(s2, [f"b{i}" for i in range(3)])
        url2 = f"http://127.0.0.1:{h2.server_address[1]}"
        r3 = Replication("r1", peers=[url2], replicate_from=url2,
                         commit_quorum=1)
        h3, s3 = serve(port=0, durable=DurableStore(str(tmp_path / "da")),
                       replication=r3)
        wait_for(lambda: r3.bootstraps >= 1 and r3.term == r2.term
                 and len(s3.cluster.pods) == 7 and s3.epoch == s2.epoch,
                 20, "the deposed leader full-resyncing at the new term")
        assert "default/diverged" not in s3.cluster.pods
        assert sorted(s3.cluster.pods) == sorted(s2.cluster.pods)
    finally:
        for h in (h3, h2):
            if h is not None:
                h.shutdown()
                h.server_close()
        for r in (r3, r2):
            if r is not None:
                r.stop()


def test_bench_replication_smoke_mode():
    """`python -m volcano_tpu_torch.bench --replication-smoke` runs
    leader + 1 follower + kill-promote through real OS processes: zero
    acked writes lost across the promotion, continuous follower reads,
    the deposed leader re-syncs back in."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--replication-smoke", 180))
    assert out["ok"] is True, out
    assert out["acked_lost"] == 0
    assert out["acked_before_kill"] > 0
    assert out["acked_after_promote"] > 0
    assert out["follower_reads_failed"] == 0
    assert out["rejoin_role"] == "follower"

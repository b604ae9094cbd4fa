"""Replication of the port's state server: WAL shipping to a follower,
follower reads, the commit quorum and failover.

A follower refuses writes with the read-only 503 and the leader's URL,
and serves reads from its replica; a leader whose follower is gone
cannot reach its commit quorum and refuses the ack; an idempotency-
keyed write committed by the old leader and retried against the
promoted follower replays its recorded verdict.

The last waits on the state its assertions read, never on a proxy: the
follower's shipped horizon (its durable WAL sequence has reached the
leader's, so the write's idempotency record is there), and a finished
promotion (the role is leader and the epoch's boot half is bumped;
`Replication.promote` publishes the role before it bumps the epoch, so
a wait on the role alone can read the old epoch).  Tolerance: exact.
"""

import json
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

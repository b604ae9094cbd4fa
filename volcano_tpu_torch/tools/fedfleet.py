"""The federation fleet the chaos conductor's ``region`` and
``router`` classes run on: N regional control planes (each a state
server, controllers and an elastic scheduler as OS processes) and one
global state server holding the job queue and the region registry, with
the federation router reconciling over the wire.

The port's copy of the reference bench's federation fixture
(``bench.py``'s ``_FederationFleet`` and its ``_fed_*`` helpers), with
the GPU layer: each region's units are NVLink domains of 4 hosts x 4
GPUs in an IB fabric of the region, a gang's pods ask ``nvidia.com/gpu``
and the ``torch`` job plugin.  Nothing else of the bench is ported.
"""

import json
import time


class WirePlane:
    """Boots and reaps one plane's OS processes, each with its log
    under a temp dir of its own."""

    def __init__(self):
        import os
        import socket
        import tempfile
        self.repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.logdir = tempfile.mkdtemp(prefix="fedfleet-")
        self.procs = {}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.url = f"http://127.0.0.1:{self.port}"

    def spawn(self, name, *argv):
        import os
        import subprocess
        import sys
        logf = open(os.path.join(self.logdir, f"{name}.log"), "w")
        env = dict(os.environ, PYTHONPATH=self.repo)
        self.procs[name] = subprocess.Popen(
            [sys.executable, *argv], stdout=logf, stderr=logf,
            env=env, cwd=self.repo)

    def log_tails(self, n=1500) -> str:
        import glob
        import os
        out = []
        for f in sorted(glob.glob(os.path.join(self.logdir, "*.log"))):
            try:
                with open(f, encoding="utf-8", errors="replace") as fh:
                    out.append(f"== {os.path.basename(f)} ==\n"
                               + fh.read()[-n:])
            except OSError as e:
                out.append(f"== {os.path.basename(f)} unreadable: {e} ==")
        return "\n".join(out)

    def shutdown(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                proc.kill()


def wire_wait(cond, timeout, msg):
    """msg may be a callable: evaluated ONLY on timeout, so log tails
    in the diagnostic are captured at failure time (not when the wait
    starts) and successful waits never pay the log read."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.03)
    raise AssertionError("fedfleet: timed out waiting for "
                         + (msg() if callable(msg) else msg))

def healthz(url: str) -> bool:
    import urllib.request
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=1):
            return True
    except OSError:
        return False

ELASTIC_CONF = {
    "actions": "enqueue, allocate, elastic, gangpreempt, backfill",
    "tiers": [
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "elastic"},
                     {"name": "conformance"}]},
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"}, {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"},
                     {"name": "deviceshare"},
                     {"name": "network-topology-aware"}]},
    ],
    "configurations": {"elastic": {"elastic.cooldownSeconds": 0}},
}


def elastic_vcjob(name, slices, lo, hi, pods_per_slice,
                   run_ticks=None):
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    pod_ann = {} if run_ticks is None else \
        {RUN_TICKS_ANNOTATION: str(run_ticks)}
    return VCJob(
        name=name, min_available=slices * pods_per_slice,
        annotations={
            eapi.ELASTIC_MIN_SLICES_ANNOTATION: str(lo),
            eapi.ELASTIC_MAX_SLICES_ANNOTATION: str(hi),
            eapi.ELASTIC_SLICES_ANNOTATION: str(slices),
        },
        plugins={"torch": []},
        tasks=[TaskSpec(name="worker",
                        replicas=slices * pods_per_slice,
                        template=make_pod(
                            "t", requests={"cpu": 8, GPU: 4},
                            annotations=pod_ann))])

class FederationFleet:
    """N regional control planes (each a full WirePlane: server +
    controllers + elastic scheduler as OS processes) plus one GLOBAL
    state server holding the job queue + region registry, with the
    FederationRouter reconciling over the real wire (RemoteCluster
    writes, RegionMirror tailing /wal?mirror=1)."""

    def __init__(self, regions, ttl=3.0, arbitrage_after=4.0,
                 poll_s=0.3, sync_s=0.25, router_procs=0,
                 lease_ttl=2.0):
        import os
        import threading

        from volcano_tpu_torch.api import federation as fedapi
        from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
        from volcano_tpu_torch.federation.mirror import RegionMirror
        from volcano_tpu_torch.federation.router import FederationRouter
        from volcano_tpu_torch.simulator import domain_nodes
        from volcano_tpu_torch.tools.chaoslib import domain

        self.gplane = WirePlane()
        conf_path = os.path.join(self.gplane.logdir, "elastic.yaml")
        with open(conf_path, "w") as f:
            json.dump(ELASTIC_CONF, f)     # JSON is valid YAML
        # the global store runs NO scheduler and NO controllers —
        # it is a queue + registry, not a control plane
        self.gplane.spawn("server", "-m", "volcano_tpu_torch.server",
                          "--port", str(self.gplane.port),
                          "--tick-period", "0.05", "--data-dir",
                          os.path.join(self.gplane.logdir, "state"))
        wire_wait(lambda: healthz(self.gplane.url), 20,
                   "global state server /healthz")
        self.g = RemoteCluster(self.gplane.url)
        self.planes = {}
        self.clients = {}
        self.hosts = 0
        # router_procs > 0 = the HA replica-set topology: N router OS
        # processes contending for the term-fenced lease in the global
        # store (each with its own clients + mirrors, regions attached
        # lazily off the registry).  0 = the embedded single router.
        self._router_procs = router_procs
        self._ttl, self._sync_s = ttl, sync_s
        self._arbitrage_after, self._poll_s = arbitrage_after, poll_s
        self._lease_ttl = lease_ttl
        self.router_holders = []
        self._routers_spawned = 0
        self.killed = set()     # (plane, process) SIGKILLed on purpose
        self.router = None if router_procs else FederationRouter(
            self.g, ttl=ttl, arbitrage_after=arbitrage_after,
            start_mirrors=False)
        for name, n_slices, price in regions:
            p = WirePlane()
            # --data-dir makes the region durable: the mirror lane
            # (/replica_snapshot + /wal?mirror=1) only ships a WAL
            p.spawn("server", "-m", "volcano_tpu_torch.server",
                    "--port", str(p.port), "--tick-period", "0.05",
                    "--data-dir", os.path.join(p.logdir, "state"))
            wire_wait(lambda: healthz(p.url), 20,
                       f"region {name} server /healthz")
            p.spawn("controllers", "-m", "volcano_tpu_torch",
                    "--cluster-url", p.url,
                    "--components", "controllers", "--period", "0.05")
            p.spawn("scheduler", "-m", "volcano_tpu_torch",
                    "--cluster-url", p.url,
                    "--components", "scheduler", "--period", "0.05",
                    "--conf", conf_path)
            client = RemoteCluster(p.url, tolerate_unreachable=True)
            for i in range(n_slices):
                for node in domain_nodes(domain(f"{name}-s{i}"),
                                         ib_fabric=f"{name}-ib"):
                    client.add_node(node)
                    self.hosts += 1
            if router_procs:
                # router processes build their own clients + mirrors
                # off this registry record (lazy attach)
                self.g.put_object(
                    "region",
                    fedapi.region_record(name, p.url, price=price),
                    key=name)
            else:
                mirror = RegionMirror(name, p.url)
                mirror.start(poll_s=poll_s)
                self.router.attach_region(
                    fedapi.region_record(name, p.url, price=price),
                    client=client, mirror=mirror)
            self.planes[name] = p
            self.clients[name] = client
        self._stop = threading.Event()
        self.paused = threading.Event()
        self.sync_errors = []
        self._thread = None
        if router_procs:
            for _ in range(router_procs):
                self.spawn_router()
            return
        # the router loop runs on its own thread (exactly what
        # `python -m volcano_tpu_torch.federation.router` does), pausable so
        # scenarios can stage multi-job races into ONE sync pass

        def _route():
            while not self._stop.wait(sync_s):
                if self.paused.is_set():
                    continue
                try:
                    self.router.sync()
                except Exception as e:  # noqa: BLE001 — keep going
                    self.sync_errors.append(repr(e)[-200:])
        self._thread = threading.Thread(target=_route, daemon=True,
                                        name="fed-router")
        self._thread.start()

    # -- HA router replica set (router_procs mode) ---------------------

    def spawn_router(self, holder=""):
        """One more contender for the router lease — a real
        `python -m volcano_tpu_torch.federation.router` OS process."""
        self._routers_spawned += 1
        holder = holder or f"rt{self._routers_spawned}"
        self.gplane.spawn(
            f"router-{holder}", "-m", "volcano_tpu_torch.federation.router",
            "--store", self.gplane.url, "--holder", holder,
            "--sync-s", str(self._sync_s),
            "--ttl-s", str(self._ttl),
            "--arbitrage-s", str(self._arbitrage_after),
            "--lease-ttl-s", str(self._lease_ttl),
            "--mirror-poll-s", str(self._poll_s))
        self.router_holders.append(holder)
        return holder

    def leaseholder(self):
        """The holder of the router lease right now (None while the
        lease is vacant/expired), straight off the global store."""
        from volcano_tpu_torch.api import federation as fedapi
        try:
            rec = self.g.leases().get(fedapi.ROUTER_LEASE_NAME)
        except OSError:
            return None
        if not rec or float(rec.get("expires_in", 0)) <= 0:
            return None
        return rec.get("holder")

    def router_term(self):
        from volcano_tpu_torch.api import federation as fedapi
        try:
            rec = self.g.leases().get(fedapi.ROUTER_LEASE_NAME) or {}
        except OSError:
            return 0
        return int(rec.get("term", 0) or 0)

    def _router_proc(self, holder):
        return self.gplane.procs.get(f"router-{holder}")

    def kill_router(self, holder):
        """SIGKILL one router process — the crash the lease + fence
        machinery must absorb."""
        import signal as _signal
        proc = self._router_proc(holder)
        if proc is not None and proc.poll() is None:
            proc.send_signal(_signal.SIGKILL)
            proc.wait(timeout=10)
        self.killed.add(("global", f"router-{holder}"))

    def sigstop_router(self, holder):
        """SIGSTOP = the router<->fleet partition / GC-pause model:
        the process is alive but can neither renew its lease nor see
        that it lost it."""
        import signal as _signal
        proc = self._router_proc(holder)
        if proc is not None and proc.poll() is None:
            proc.send_signal(_signal.SIGSTOP)

    def sigcont_router(self, holder):
        import signal as _signal
        proc = self._router_proc(holder)
        if proc is not None and proc.poll() is None:
            proc.send_signal(_signal.SIGCONT)

    def kill_region(self, name):
        """SIGKILL every process of one regional plane — whole-region
        loss, the blast radius the global queue must absorb."""
        import signal as _signal
        plane = self.planes[name]
        self.killed.update((name, n) for n in plane.procs)
        for proc in plane.procs.values():
            if proc.poll() is None:
                proc.send_signal(_signal.SIGKILL)
        for proc in plane.procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                proc.kill()

    def died(self):
        """The fleet's processes that exited on their own ("plane/name"):
        dead, and not SIGKILLed by a drill."""
        planes = dict(self.planes, **{"global": self.gplane})
        return sorted(f"{pname}/{n}" for pname, plane in planes.items()
                      for n, proc in plane.procs.items()
                      if proc.poll() is not None
                      and (pname, n) not in self.killed)

    def set_region_state(self, name, state):
        """Registry write, exactly what `vtpctl federate --drain`
        issues."""
        rec = dict(self.g.regions[name])
        rec["state"] = state
        self.g.put_object("region", rec, key=name)

    def log_tails(self, n=900):
        out = [self.gplane.log_tails(n)]
        out += [p.log_tails(n) for p in self.planes.values()]
        return "\n".join(out)[-4 * n:]

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self.router is not None:
            self.router.close()
        for holder in self.router_holders:
            # SIGCONT first: a SIGSTOP'd router ignores SIGTERM
            self.sigcont_router(holder)
        for client in self.clients.values():
            client.close()
        self.g.close()
        for plane in self.planes.values():
            plane.shutdown()
        self.gplane.shutdown()


def fed_job(name, slices=1, locality=""):
    """A global elastic gang: ordinary vcjob + locality preference —
    the submitter's whole contract with the federation tier."""
    from volcano_tpu_torch.api import federation as fedapi
    job = elastic_vcjob(name, slices, 1, slices, 4)
    if locality:
        job.annotations[fedapi.FED_DATA_LOCALITY_ANNOTATION] = locality
    return job


def fed_view(g, jname):
    """(admitted region, folded regional phase) off the GLOBAL record
    alone — what `vtpctl federate` renders."""
    from volcano_tpu_torch.api import federation as fedapi
    j = g.vcjobs.get(f"default/{jname}")
    if j is None:
        return None, None
    return (fedapi.admitted_region(j),
            j.annotations.get(fedapi.FED_REGIONAL_PHASE_ANNOTATION))


def fed_running(g, jname, region=None):
    adm, phase = fed_view(g, jname)
    return (adm is not None and phase == "Running"
            and (region is None or adm == region))


def fed_stamp_steps(client, jname, step):
    """What the regional progress fold does in production: acked
    checkpoint metadata lands on the regional job's annotations."""
    from volcano_tpu_torch.api.slicehealth import (
        CHECKPOINT_DIR_ANNOTATION, LAST_STEP_ANNOTATION,
        RESUME_STEP_ANNOTATION)
    j = client.vcjobs.get(f"default/{jname}")
    if j is None:
        return False
    j.annotations[LAST_STEP_ANNOTATION] = str(step)
    j.annotations[RESUME_STEP_ANNOTATION] = str(step)
    j.annotations[CHECKPOINT_DIR_ANNOTATION] = f"gs://ckpt/{jname}"
    client.update_vcjob(j)
    return True


def fed_stamp_and_fold(fleet, region, jname, step, timeout=30):
    """Stamp acked steps on the regional copy and wait until the
    router folds them onto the GLOBAL record, re-stamping on retry (a
    concurrent controller status flush can clobber one write)."""
    deadline = time.monotonic() + timeout
    stamped = False
    while time.monotonic() < deadline:
        if not fed_stamp_steps(fleet.clients[region], jname, step):
            # the region's watch mirror may trail the global record
            # that said the copy runs there
            time.sleep(0.05)
            continue
        stamped = True
        inner = time.monotonic() + 3
        while time.monotonic() < inner:
            if fed_folded_step(fleet.g, jname) == step:
                return
            time.sleep(0.05)
    assert stamped, f"no regional copy of {jname} in {region} to stamp"
    raise AssertionError(
        f"acked step {step} of {jname} never folded globally "
        f"({fleet.log_tails()})")


def fed_folded_step(g, jname):
    from volcano_tpu_torch.api.slicehealth import LAST_STEP_ANNOTATION
    j = g.vcjobs.get(f"default/{jname}")
    try:
        return int(j.annotations.get(LAST_STEP_ANNOTATION, 0) or 0)
    except (AttributeError, TypeError, ValueError):
        return 0

def fed_copy_regions(fleet, jname):
    """Regions currently holding a copy of the gang (each client's
    watch mirror — the exactly-once census)."""
    return sorted(r for r, c in fleet.clients.items()
                  if f"default/{jname}" in c.vcjobs)


def fed_regions_ready(g, names):
    """Every named region is ready WITH capacity folded into the
    registry (a fresh mirror poll stamped it).  Submitting before
    this is a race: admission scores only the regions that have
    folded, the gang lands in whichever region's mirror won the
    boot race, and admission is sticky — a locality assertion then
    times out on a perfectly healthy fleet."""
    from volcano_tpu_torch.api import federation as fedapi
    regs = getattr(g, "regions", None) or {}
    return all(
        (regs.get(n) or {}).get("state") == fedapi.REGION_STATE_READY
        and float((regs.get(n) or {}).get("capacity_chips", 0) or 0) > 0
        for n in names)


def fed_dual_sampler(fleet, jobs, violations, stop):
    """Continuously assert the no-dual-placement invariant: a gang
    never has LIVE PLACED PODS in two regions at once, sampled
    through every region's watch mirror while routers crash and fail
    over.  The census is pods, not the vcjob phase field: a drained
    source husk awaiting the create-then-delete reap keeps its stale
    Running phase for a beat after its pods are gone — execution is
    what must never be doubled."""
    import threading

    from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION

    def _live(c, jname):
        return any(
            p.annotations.get(GROUP_NAME_ANNOTATION) == jname
            and p.node_name and not p.is_terminated()
            for p in c.pods.values())

    def _sample():
        while not stop.wait(0.1):
            for jname in jobs:
                running = [region
                           for region, c in fleet.clients.items()
                           if _live(c, jname)]
                if len(running) > 1:
                    violations.append(
                        {"job": jname, "regions": running})
    th = threading.Thread(target=_sample, daemon=True,
                          name="fed-dual-sampler")
    th.start()
    return th

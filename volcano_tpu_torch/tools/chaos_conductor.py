"""Randomized gray-failure conductor: mixed wire+disk+clock fault
schedules against the REAL process plane, with the safety invariants
checked continuously.

Where volcano_tpu_torch/tools/chaos.py kills processes (the clean failure), this drives
the faults that merely make infrastructure SICK — dropped acks,
duplicated retries, injected 503s/resets/reorders/trickle on the
wire; ENOSPC and lying fsyncs on the WAL (the read-only degrade +
heal path); wall-clock jumps under live leases — all drawn
deterministically from ONE seed (volcano_tpu_torch/faults.py), so any
failing run is replayed exactly:

    python -m volcano_tpu_torch.tools.chaos_conductor --seed 7 --duration 30

The invariants, checked while the faults fly and audited at the end:

    acked_durable     every acked vcjob create survives to the final
                      snapshot (and every reboot in between)
    rv_monotonic      the durable revision never goes backwards —
                      polled across degrade, heal, and reboots
    no_overcommit     no node's bound/running pods exceed its GPUs
    no_double_bind    no pod silently moves nodes while bound/running
                      (same uid, no drain in between)
    resume_floor      failover.volcano-tpu.io/resume-step never
                      rewinds (elastic/failover churn on a long gang)
    goodput_monotonic the folded goodput ledger never regresses
                      (progress files -> real agents -> wire -> fold)
    serving_monotonic (``serving`` class) the folded serving request
                      ledger never regresses while the autoscaler +
                      elastic controller churn the replica group
                      (stats files -> real agents -> wire -> fold)
    mirror_converged  a live mirror that watched THROUGH all faults
                      matches the server's snapshot exactly at the end
    clock_lease       the lease holder stays stable across the
                      injected wall jump (monotonic-clock leases)
    crc_refusal       a mid-WAL bit flip is detected by CRC at the
                      next boot and REFUSED (exit 3), not silently
                      replayed; restoring the byte boots cleanly
    bounded_staleness (``replication`` class) no follower ever SERVES
                      an rv it has not durably applied, its visible
                      horizon never regresses, and its advertised lag
                      is truthful — audited from outside against
                      /watch + /durability

The ``replication`` class runs the plane against a 3-replica state
server (server/replication.py): the fault-armed leader plus two
WAL-shipping followers, one behind a partition-able proxy.  Scheduled
faults: a leader<->follower shipping partition, a shipping-lag window
(delay on /wal), low-probability shipped-record corruption (refused
by the follower's per-record CRC), and a late leader SIGKILL — a
follower must promote without losing an acked write, the multi-
endpoint client must re-route, and the deposed leader must rejoin by
full re-sync.  The matrix run appends the read-QPS scaling row
(leader-only vs follower reads under write churn).

``--matrix N`` runs seeds 1..N and writes the committed artifact
(CHAOS_r{NN}.json shape): per-fault-class recovery latencies and the
invariant pass matrix.  ``--print-schedule`` dumps the derived plan
without booting anything (reproducibility is testable offline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from volcano_tpu_torch.tools import chaoslib  # noqa: E402

DEFAULT_CLASSES = "wire,disk,clock"
FLOOR_STEP = 500           # checkpoint floor stamped on the long gang


def build_plan(seed: int, duration: float, classes) -> dict:
    """Derive the deterministic fault plan for one run.  Everything —
    probabilities, window placement, delay magnitudes, clock offset —
    comes off random.Random(seed), so the same seed always produces
    the same plan doc (tested offline via --print-schedule)."""
    import random
    rng = random.Random(seed)
    rules = []
    if "wire" in classes:
        d = duration
        rules += [
            # the ack-lost case: committed, response dropped
            {"site": "server", "kind": "drop_response", "route": "*",
             "prob": round(rng.uniform(0.02, 0.05), 3), "until_s": d},
            {"site": "server", "kind": "drop_request", "route": "*",
             "prob": round(rng.uniform(0.01, 0.03), 3), "until_s": d},
            {"site": "server", "kind": "delay", "route": "*",
             "prob": round(rng.uniform(0.05, 0.10), 3),
             "ms": round(rng.uniform(20, 80), 1), "until_s": d},
            {"site": "server", "kind": "duplicate", "route": "*",
             "prob": round(rng.uniform(0.02, 0.05), 3), "until_s": d},
            {"site": "server", "kind": "reorder", "route": "*",
             "prob": round(rng.uniform(0.02, 0.04), 3),
             "ms": 120.0, "until_s": d},
            {"site": "server", "kind": "http_503", "route": "*",
             "prob": round(rng.uniform(0.02, 0.04), 3), "until_s": d},
            {"site": "server", "kind": "reset", "route": "*",
             "prob": round(rng.uniform(0.01, 0.03), 3), "until_s": d},
            {"site": "server", "kind": "trickle", "route": "*",
             "prob": round(rng.uniform(0.005, 0.02), 3),
             "ms": 10.0, "until_s": d},
        ]
    windows = {}
    if "disk" in classes:
        # one ENOSPC brownout and one lying-fsync episode, placed so
        # both end well before the settle phase
        w0 = round(duration * rng.uniform(0.15, 0.25), 2)
        w1 = round(w0 + min(4.0, duration * 0.12), 2)
        rules.append({"site": "disk", "kind": "enospc_append",
                      "after_s": w0, "until_s": w1})
        windows["enospc"] = (w0, w1)
        f0 = round(duration * rng.uniform(0.45, 0.55), 2)
        f1 = round(f0 + min(3.0, duration * 0.08), 2)
        rules.append({"site": "disk", "kind": "eio_fsync",
                      "after_s": f0, "until_s": f1})
        windows["eio"] = (f0, f1)
    if "clock" in classes:
        j0 = round(duration * rng.uniform(0.65, 0.75), 2)
        j1 = round(min(duration * 0.9, j0 + duration * 0.15), 2)
        off = rng.choice((-1, 1)) * rng.uniform(600.0, 3600.0)
        rules.append({"site": "clock", "kind": "wall_jump",
                      "after_s": j0, "until_s": j1,
                      "offset_s": round(off, 1)})
        windows["clock_jump"] = (j0, j1)
    slice_kill_at = None
    if "slice" in classes:
        slice_kill_at = round(duration * rng.uniform(0.3, 0.45), 2)
    repl = None
    if "replication" in classes:
        # the replication fault schedule (drawn AFTER the classic
        # classes so their plans stay byte-identical across versions):
        # a leader<->follower partition, a shipping-lag window, low-
        # probability shipped-record corruption all run, and a leader
        # SIGKILL late enough that the classic disk/clock windows (on
        # the original leader) complete first
        p0 = round(duration * rng.uniform(0.26, 0.32), 2)
        p1 = round(p0 + duration * rng.uniform(0.10, 0.14), 2)
        l0 = round(duration * rng.uniform(0.52, 0.58), 2)
        l1 = round(l0 + duration * rng.uniform(0.08, 0.12), 2)
        rules.append({"site": "server", "kind": "delay",
                      "route": "/wal", "prob": 1.0,
                      "ms": round(rng.uniform(150, 400), 1),
                      "after_s": l0, "until_s": l1})
        rules.append({"site": "server", "kind": "corrupt_ship",
                      "route": "/wal",
                      "prob": round(rng.uniform(0.02, 0.05), 3),
                      "max_injections": 3, "until_s": duration})
        repl = {"partition": (p0, p1),
                "kill_leader_at": round(duration *
                                        rng.uniform(0.78, 0.85), 2)}
        windows["repl_partition"] = repl["partition"]
        windows["repl_lag"] = (l0, l1)
    region = None
    if "region" in classes:
        # whole-region loss under the federation tier: the kill lands
        # mid-run, after acked progress has climbed (drawn AFTER every
        # other class so their plans stay byte-identical)
        region = {"victim": "rb",
                  "kill_at": round(duration * rng.uniform(0.35, 0.55),
                                   2)}
        windows["region_kill"] = (region["kill_at"],
                                  region["kill_at"])
    router = None
    if "router" in classes:
        # federation-router replica-set failover: SIGKILL the
        # leaseholder mid-admission, SIGKILL it again mid-cutover,
        # then SIGSTOP it (the partition / GC-pause model) late in
        # the run and replay a write stamped with the deposed term
        # (drawn AFTER every other class so their plans stay
        # byte-identical)
        router = {
            "kill_admission_at":
                round(duration * rng.uniform(0.18, 0.28), 2),
            "kill_cutover_at":
                round(duration * rng.uniform(0.48, 0.58), 2),
            "partition_at":
                round(duration * rng.uniform(0.75, 0.85), 2),
        }
        for k, at in router.items():
            windows["router_" + k[:-3]] = (at, at)
    return {"seed": seed, "rules": rules, "windows": windows,
            "slice_kill_at": slice_kill_at, "replication": repl,
            "region": region, "router": router}


def _iann(ann, key, default=0):
    try:
        return int(ann.get(key, default) or default)
    except (TypeError, ValueError):
        return default


class InvariantTracker:
    """Continuous safety checks over the conductor's live mirror +
    the server's /durability endpoint."""

    def __init__(self, cluster, url: str, floor_key: str,
                 repl: dict = None, serving_key: str = ""):
        self.c = cluster
        self.url = url
        self.floor_key = floor_key
        self.serving_key = serving_key
        # replication topology, kept current by the conductor as roles
        # change: {"leader": url, "followers": [urls]}.  None = the
        # classic single-server plane.
        self.repl = repl
        self.violations = []
        self.max_rv = 0
        self.max_resume = 0
        self.max_alloc = 0.0
        self.resume_seen = False
        self.goodput_seen = False
        self.serving_seen = False
        self.max_serving_requests = 0.0
        self._pod_nodes = {}
        self._max_visible = {}          # replica url -> max visible_rv
        self._prev_leader_visible = 0
        self.follower_lag_max = {}      # replica url -> max lag_s seen
        self.staleness_checks = 0

    def note(self, inv: str, detail: str):
        if any(v["invariant"] == inv and v["detail"] == detail
               for v in self.violations):
            return          # same finding, next poll — log once
        self.violations.append({"invariant": inv, "detail": detail})
        print(f"INVARIANT VIOLATION [{inv}]: {detail}", flush=True)

    def _node_forensics(self, node: str) -> str:
        return "; ".join(
            f"{p.key} uid={getattr(p, 'uid', '')[:8]} "
            f"phase={getattr(p.phase, 'value', p.phase)} "
            f"owner={getattr(p, 'owner', '')[:8]}"
            for p in self.c.pods.values() if p.node_name == node)

    def poll_replication(self):
        """The tenth invariant — bounded staleness: no follower ever
        SERVES an rv it has not durably applied (what /watch returns
        is audited against what /durability admits), a replica's
        visible horizon never regresses, and the advertised lag is
        truthful (a follower claiming to be caught up must hold at
        least what the leader had visible a poll ago)."""
        if not self.repl:
            return
        for furl in self.repl.get("followers", []):
            since = self._max_visible.get(furl, 0)
            w = chaoslib.http_json(
                furl + f"/watch?since={since}&timeout=0", timeout=2)
            d = chaoslib.http_json(furl + "/durability", timeout=2)
            if not d:
                continue
            self.staleness_checks += 1
            vis = int(d.get("visible_rv") or 0)
            synced = int(d.get("synced_rv") or 0)
            rep = d.get("replication") or {}
            applied = int(rep.get("applied_rv") or 0)
            if w is not None and not w.get("resync") and \
                    int(w.get("rv") or 0) > max(applied, vis):
                # the durability doc was read AFTER the watch: a
                # served rv past the admitted applied horizon means
                # the follower served state it cannot prove durable
                self.note("bounded_staleness",
                          f"{furl} served rv {w.get('rv')} beyond "
                          f"durably applied {applied}")
            if vis > synced:
                self.note("bounded_staleness",
                          f"{furl} visible_rv {vis} beyond fsync "
                          f"horizon {synced}")
            prev = self._max_visible.get(furl, 0)
            if vis < prev:
                self.note("bounded_staleness",
                          f"{furl} visible_rv regressed {prev} -> "
                          f"{vis}")
            self._max_visible[furl] = max(prev, vis)
            lag = float(rep.get("lag_s") or 0.0)
            if lag < 0:
                self.note("bounded_staleness",
                          f"{furl} advertised negative lag {lag}")
            self.follower_lag_max[furl] = max(
                self.follower_lag_max.get(furl, 0.0), lag)
            if lag < 0.25 and self._prev_leader_visible and \
                    applied < self._prev_leader_visible:
                self.note("bounded_staleness",
                          f"{furl} claims lag {lag}s but applied rv "
                          f"{applied} trails the leader's horizon "
                          f"{self._prev_leader_visible} from the "
                          "previous poll — the advertised lag lies")
        leader_url = self.repl.get("leader")
        if leader_url:
            d = chaoslib.http_json(leader_url + "/durability",
                                   timeout=2)
            if d:
                self._prev_leader_visible = int(
                    d.get("visible_rv") or 0)

    def poll(self):
        self.poll_replication()
        dur = chaoslib.http_json(self.url + "/durability", timeout=2)
        if dur:
            rv = int(dur.get("visible_rv") or 0)
            if rv < self.max_rv:
                self.note("rv_monotonic",
                          f"visible_rv {rv} < seen {self.max_rv}")
            self.max_rv = max(self.max_rv, rv)
        over = chaoslib.overcommit_audit(self.c)
        if over:
            # the mirror can run seconds stale under injected faults
            # (that is the point of them): only a double-booking the
            # SERVER's own snapshot confirms is a safety violation.
            # Unconfirmable (snapshot 503 during a degrade window) =
            # recheck next poll; staleness that truth refutes = noise.
            import types
            try:
                truth = chaoslib.snapshot_stores(self.url)
                confirmed = chaoslib.overcommit_audit(
                    types.SimpleNamespace(pods=truth["pod"]))
            except Exception:  # noqa: BLE001 — degrade window
                confirmed = None
            if confirmed:
                self.note("no_overcommit",
                          f"{confirmed} :: " + " | ".join(
                              self._node_forensics(n)
                              for n, _u in confirmed))
        for p in list(self.c.pods.values()):
            ph = getattr(p.phase, "value", "")
            key = (p.key, getattr(p, "uid", ""))
            if ph in ("Bound", "Running") and p.node_name:
                prev = self._pod_nodes.get(key)
                if prev is not None and prev != p.node_name:
                    self.note("no_double_bind",
                              f"{p.key} moved {prev} -> "
                              f"{p.node_name} while {ph}")
                self._pod_nodes[key] = p.node_name
            elif ph in ("Releasing", "Succeeded", "Failed"):
                self._pod_nodes.pop(key, None)
        pg = self.c.podgroups.get(self.floor_key)
        if pg is not None:
            resume = _iann(pg.annotations,
                           "failover.volcano-tpu.io/resume-step", -1)
            if resume >= 0:
                self.resume_seen = True
                if resume < self.max_resume:
                    self.note("resume_floor",
                              f"resume-step {resume} < seen "
                              f"{self.max_resume}")
                if resume < FLOOR_STEP:
                    self.note("resume_floor",
                              f"resume-step {resume} below the "
                              f"stamped checkpoint {FLOOR_STEP}")
                self.max_resume = max(self.max_resume, resume)
            from volcano_tpu_torch.api import goodput as gapi
            alloc = gapi.ann_float(pg.annotations,
                                   gapi.PG_ALLOCATED_S_ANNOTATION)
            if alloc > 0:
                self.goodput_seen = True
                if alloc + 1e-6 < self.max_alloc:
                    self.note("goodput_monotonic",
                              f"allocated ledger {alloc} < seen "
                              f"{self.max_alloc} (pg uid="
                              f"{getattr(pg, 'uid', '')[:8]} ann="
                              f"{dict(pg.annotations)})")
                self.max_alloc = max(self.max_alloc, alloc)
        if self.serving_key:
            spg = self.c.podgroups.get(self.serving_key)
            if spg is not None:
                from volcano_tpu_torch.api import serving as sapi
                reqs = sapi.ann_float(spg.annotations,
                                      sapi.PG_REQUESTS_ANNOTATION)
                if reqs > 0:
                    self.serving_seen = True
                    if reqs + 1e-6 < self.max_serving_requests:
                        self.note("serving_monotonic",
                                  f"request ledger {reqs} < seen "
                                  f"{self.max_serving_requests} (pg "
                                  f"uid={getattr(spg, 'uid', '')[:8]})")
                    self.max_serving_requests = max(
                        self.max_serving_requests, reqs)

    def summary(self) -> dict:
        failed = {v["invariant"] for v in self.violations}
        return {
            "violations": self.violations,
            "passed": {inv: inv not in failed for inv in (
                "acked_durable", "rv_monotonic", "no_overcommit",
                "no_double_bind", "resume_floor", "goodput_monotonic",
                "serving_monotonic", "mirror_converged", "crc_refusal",
                "clock_lease", "bounded_staleness")},
            "resume_floor_exercised": self.resume_seen,
            "goodput_ledger_exercised": self.goodput_seen,
            "serving_ledger_exercised": self.serving_seen,
            "staleness_checks": self.staleness_checks,
        }


def run_region_kill(seed: int, duration: float, classes,
                    logdir: str = "") -> dict:
    """The ``region`` fault class: whole-region loss under the
    federation tier.  Boots fedfleet's 2-region process fleet (each
    region a REAL server + controllers + elastic scheduler plane, one
    global store, the router reconciling over the wire), lets acked
    training progress climb, then SIGKILLs every process of the
    victim region at the seeded kill time.  Invariants:

        requeued_globally   every gang admitted to the dead region is
                            re-admitted into a survivor and reaches
                            Running (MTTR reported)
        region_lost         the registry record flips to state=lost
        resume_floor        the globally folded resume step never
                            rewinds — before, across, or after the
                            kill
        acked_durable       the re-admitted copy resumes at >= the
                            last step acked to the global store
                            before the kill (zero acked state lost)
        survivor_untouched  the surviving region's resident gang
                            stays Running through the whole episode
    """
    from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION
    from volcano_tpu_torch.tools import fedfleet
    classes = set(classes.split(",")) if isinstance(classes, str) \
        else set(classes)
    sched = build_plan(seed, duration, classes)
    kill_at = sched["region"]["kill_at"]
    print(f"chaos conductor: seed={seed} duration={duration}s "
          f"classes={sorted(classes)} (federation fleet, "
          f"region kill at t+{kill_at}s)", flush=True)
    violations = []

    def note(inv: str, detail: str):
        violations.append({"invariant": inv, "detail": detail})
        print(f"INVARIANT VIOLATION [{inv}]: {detail}", flush=True)

    t0 = time.monotonic()
    fleet = fedfleet.FederationFleet(
        (("ra", 2, 1.0), ("rb", 1, 0.7)), ttl=2.0)
    g = fleet.g
    mttr = acked = resume = -1
    try:
        g.add_vcjob(fedfleet.fed_job("anchor", 1, locality="ra"))
        g.add_vcjob(fedfleet.fed_job("roamer", 1, locality="rb"))
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_running(g, "anchor", "ra")
                and fedfleet.fed_running(g, "roamer", "rb"), 60,
                "locality-routed admission")
        except AssertionError as e:
            note("requeued_globally", f"admission never settled: {e}")
            raise
        # acked progress climbs until the kill window; the globally
        # folded floor must never rewind while the faults fly
        step, floor = 1000, 0
        while time.monotonic() - t0 < kill_at:
            fedfleet.fed_stamp_and_fold(fleet, "rb", "roamer", step)
            f = fedfleet.fed_folded_step(g, "roamer")
            if f < floor:
                note("resume_floor",
                     f"folded step rewound {floor} -> {f}")
            floor = max(floor, f)
            step += 500
            time.sleep(0.3)
        acked = floor
        fleet.kill_region("rb")
        t_kill = time.monotonic()
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_running(g, "roamer", "ra"), 90,
                "global requeue into the survivor")
            mttr = round(time.monotonic() - t_kill, 3)
        except AssertionError:
            note("requeued_globally",
                 f"gang never re-ran after the region kill "
                 f"({fedfleet.fed_view(g, 'roamer')})")
        if g.regions.get("rb", {}).get("state") != "lost":
            note("region_lost",
                 f"registry state: {g.regions.get('rb', {})}")
        folded = fedfleet.fed_folded_step(g, "roamer")
        if folded < acked:
            note("resume_floor",
                 f"fold rewound across the kill: {acked} -> {folded}")
        copy = fleet.clients["ra"].vcjobs.get("default/roamer")
        resume = int(copy.annotations.get(RESUME_STEP_ANNOTATION, 0)
                     ) if copy is not None else -1
        if resume < acked:
            note("acked_durable",
                 f"survivor resumes at {resume} < acked {acked}")
        if not fedfleet.fed_running(g, "anchor", "ra"):
            note("survivor_untouched",
                 f"anchor left Running: {fedfleet.fed_view(g, 'anchor')}")
        if fleet.sync_errors:
            note("router_sync", "; ".join(fleet.sync_errors[-3:]))
        died = fleet.died()
    finally:
        fleet.shutdown()
    result = {"seed": seed, "duration_s": duration,
              "classes": sorted(classes),
              "windows": sched["windows"],
              "dead_processes": died,
              "region_kill_at_s": kill_at,
              "region_mttr_s": mttr,
              "acked_step_before_kill": acked,
              "resume_step_in_survivor": resume,
              "violations": violations, "ok": not violations}
    print(f"REPRODUCE: python -m volcano_tpu_torch.tools.chaos_conductor "
          f"--seed {seed} --duration {duration:g} "
          f"--classes {','.join(sorted(classes))}", flush=True)
    return result


# the failover MTTR budget for the router class: 2x the whole-region
# loss MTTR the reference measured (FED_r19.json, ~6.7s, on its own
# machine) — losing ONE router out of a replica set must never cost
# more than twice losing a region
ROUTER_MTTR_BOUND_S = 13.4


def run_router_failover(seed: int, duration: float, classes,
                        logdir: str = "") -> dict:
    """The ``router`` fault class: the federation router replica set
    under crash + partition fire.  Boots fedfleet's 2-region process
    fleet with TWO router OS processes contending for the term-fenced
    lease, then fires the seeded schedule: SIGKILL the leaseholder
    right after a gang enters the global queue, SIGKILL its successor
    mid-cutover (source drained, evacuating-to stamped), and SIGSTOP
    the next one so a standby takes over while the old holder still
    believes it leads.  Invariants:

        no_dual_placement        a gang is never RUNNING in two
                                 regions at once (sampled at 10Hz
                                 through every region's live mirror)
        cutover_exactly_once     the adopted migration lands exactly
                                 one destination copy, reaps the
                                 source, and counts ONE migration
        acked_admissions_durable every acked admission reaches
                                 Running despite the crashes, and the
                                 globally folded step floor never
                                 rewinds
        stale_fence_refused      a write stamped with the deposed
                                 holder's term is refused 409 by the
                                 regional plane and counted on
                                 /fences
        failover_mttr            every kill/partition-to-recovery
                                 interval stays under
                                 ROUTER_MTTR_BOUND_S
    """
    import threading

    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.slicehealth import RESUME_STEP_ANNOTATION
    from volcano_tpu_torch.tools import fedfleet
    classes = set(classes.split(",")) if isinstance(classes, str) \
        else set(classes)
    sched = build_plan(seed, duration, classes)
    plan = sched["router"]
    # diagnostics go to stderr: a caller that embeds this run in-process
    # keeps its stdout one parseable JSON document
    print(f"chaos conductor: seed={seed} duration={duration}s "
          f"classes={sorted(classes)} (federation fleet, 2-router "
          f"replica set; kills at t+{plan['kill_admission_at']}s / "
          f"t+{plan['kill_cutover_at']}s, partition at "
          f"t+{plan['partition_at']}s)", file=sys.stderr, flush=True)
    violations = []

    def note(inv: str, detail: str):
        violations.append({"invariant": inv, "detail": detail})
        print(f"INVARIANT VIOLATION [{inv}]: {detail}", flush=True)

    t0 = time.monotonic()
    fleet = fedfleet.FederationFleet(
        (("ra", 2, 1.0), ("rb", 2, 0.7)), ttl=4.0,
        arbitrage_after=60.0, router_procs=2, lease_ttl=2.0)
    g = fleet.g
    dual, stop = [], threading.Event()
    sampler = fedfleet.fed_dual_sampler(
        fleet, ("anchor", "j-adm", "roamer"), dual, stop)
    mttrs = {}
    terms = []
    step, floor = 1000, 0
    fenced_count = 0

    def pump():
        # acked progress keeps climbing on the survivor gang; the
        # globally folded floor must never rewind across failovers
        nonlocal step, floor
        fedfleet.fed_stamp_and_fold(fleet, "ra", "anchor", step)
        f = fedfleet.fed_folded_step(g, "anchor")
        if f < floor:
            note("acked_admissions_durable",
                 f"folded step rewound {floor} -> {f}")
        floor = max(floor, f)
        step += 500

    def sleep_until(at):
        while time.monotonic() - t0 < at:
            pump()
            time.sleep(0.3)

    try:
        chaoslib.wait_for(lambda: fleet.leaseholder() is not None,
                          30, "router lease acquisition")
        terms.append(fleet.router_term())
        chaoslib.wait_for(
            lambda: fedfleet.fed_regions_ready(g, ("ra", "rb")), 30,
            "region capacity folded before the first submit")
        g.add_vcjob(fedfleet.fed_job("anchor", 1, locality="ra"))
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_running(g, "anchor", "ra"), 60,
                "locality-routed admission")
        except AssertionError as e:
            note("acked_admissions_durable",
                 f"admission never settled: {e}")
            raise

        # -- SIGKILL the leaseholder mid-admission -------------------
        sleep_until(plan["kill_admission_at"])
        h0 = fleet.leaseholder()
        g.add_vcjob(fedfleet.fed_job("j-adm", 1, locality="rb"))
        fleet.kill_router(h0)
        t_kill = time.monotonic()
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_running(g, "j-adm", "rb"), 60,
                "adoption of the in-flight admission")
            mttrs["kill_admission"] = round(
                time.monotonic() - t_kill, 3)
        except AssertionError:
            note("acked_admissions_durable",
                 f"gang never ran after the leaseholder SIGKILL "
                 f"({fedfleet.fed_view(g, 'j-adm')})")
        terms.append(fleet.router_term())
        copies = fedfleet.fed_copy_regions(fleet, "j-adm")
        if copies != ["rb"]:
            note("no_dual_placement", f"j-adm copies: {copies}")
        fleet.spawn_router()        # keep the replica set at 2

        # -- SIGKILL the leaseholder mid-cutover ---------------------
        sleep_until(plan["kill_cutover_at"])
        g.add_vcjob(fedfleet.fed_job("roamer", 1, locality="rb"))
        chaoslib.wait_for(
            lambda: fedfleet.fed_running(g, "roamer", "rb"), 60,
            "roamer admission")
        acked = step
        fedfleet.fed_stamp_and_fold(fleet, "rb", "roamer", acked)
        gj = g.vcjobs["default/roamer"]
        gj.annotations[fedapi.FED_EVACUATE_ANNOTATION] = "ra"
        g.update_vcjob(gj)
        chaoslib.wait_for(
            lambda: g.vcjobs["default/roamer"].annotations.get(
                fedapi.FED_EVACUATING_TO_ANNOTATION) == "ra", 60,
            "evacuation start")
        fleet.kill_router(fleet.leaseholder())
        t_kill = time.monotonic()
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_running(g, "roamer", "ra"), 90,
                "adopted cutover")
            mttrs["kill_cutover"] = round(
                time.monotonic() - t_kill, 3)
        except AssertionError:
            note("cutover_exactly_once",
                 f"cutover never completed "
                 f"({fedfleet.fed_view(g, 'roamer')})")
        try:
            chaoslib.wait_for(
                lambda: fedfleet.fed_copy_regions(fleet, "roamer") ==
                ["ra"], 60, "source residual reap")
        except AssertionError:
            note("cutover_exactly_once",
                 f"roamer copies: "
                 f"{fedfleet.fed_copy_regions(fleet, 'roamer')}")
        terms.append(fleet.router_term())
        gj = g.vcjobs["default/roamer"]
        if fedapi.migration_count(gj) != 1:
            note("cutover_exactly_once",
                 f"migrations={fedapi.migration_count(gj)} "
                 f"(want exactly 1)")
        racopy = fleet.clients["ra"].vcjobs.get("default/roamer")
        rstep = int(racopy.annotations.get(
            RESUME_STEP_ANNOTATION, 0) or 0) if racopy else -1
        if rstep < acked:
            note("acked_admissions_durable",
                 f"cutover resume step {rstep} < acked {acked}")
        fleet.spawn_router()

        # -- SIGSTOP partition + fenced stale-term write -------------
        sleep_until(plan["partition_at"])
        chaoslib.wait_for(lambda: fleet.leaseholder() is not None,
                          30, "leaseholder before the partition")
        h2, stale_term = fleet.leaseholder(), fleet.router_term()
        fleet.sigstop_router(h2)
        t_stop = time.monotonic()
        try:
            chaoslib.wait_for(
                lambda: fleet.leaseholder() not in (None, h2), 30,
                "takeover from the partitioned holder")
            mttrs["partition"] = round(time.monotonic() - t_stop, 3)
        except AssertionError:
            note("failover_mttr",
                 "standby never took over from the SIGSTOP'd holder")
        new_term = fleet.router_term()
        terms.append(new_term)
        rbc = fleet.clients["rb"]
        try:
            chaoslib.wait_for(
                lambda: int(rbc.fences().get(
                    fedapi.ROUTER_LEASE_NAME, {}).get("term", 0)
                ) >= new_term, 30, "fence advance")
        except AssertionError:
            note("stale_fence_refused",
                 f"fence floor never reached term {new_term}: "
                 f"{rbc.fences()}")
        fleet.sigcont_router(h2)
        # the partitioned holder's write, replayed deterministically
        # from the conductor with the deposed term
        rbc.set_fence(fedapi.ROUTER_LEASE_NAME, stale_term)
        try:
            rbc.add_vcjob(fedfleet.fed_job("stale-probe", 1))
            note("stale_fence_refused",
                 f"write stamped with deposed term {stale_term} "
                 f"was ACCEPTED")
        except ValueError as e:
            if not str(e).startswith("fenced"):
                note("stale_fence_refused",
                     f"refused for the wrong reason: {e}")
        finally:
            rbc.set_fence("", 0)
        fenced_count = int(rbc.fences().get(
            fedapi.ROUTER_LEASE_NAME, {}).get("refused", 0) or 0)
        if fenced_count < 1:
            note("stale_fence_refused",
                 f"refusal not counted on /fences: {rbc.fences()}")

        # -- settle: run out the clock under a healthy leaseholder ---
        sleep_until(duration)
        if not fedfleet.fed_running(g, "anchor", "ra"):
            note("acked_admissions_durable",
                 f"anchor left Running: {fedfleet.fed_view(g, 'anchor')}")
        for name, m in mttrs.items():
            if m > ROUTER_MTTR_BOUND_S:
                note("failover_mttr",
                     f"{name} MTTR {m}s > bound "
                     f"{ROUTER_MTTR_BOUND_S}s")
        if dual:
            note("no_dual_placement", f"{dual[:3]}")
        if not all(a < b for a, b in zip(terms, terms[1:])):
            note("stale_fence_refused",
                 f"lease terms not strictly monotonic: {terms}")
        died = fleet.died()
    finally:
        stop.set()
        sampler.join(timeout=2)
        fleet.shutdown()
    result = {"seed": seed, "duration_s": duration,
              "classes": sorted(classes),
              "windows": sched["windows"],
              "dead_processes": died,
              "routers_spawned": fleet._routers_spawned,
              "lease_terms": terms,
              "failover_mttr_s": mttrs,
              "mttr_bound_s": ROUTER_MTTR_BOUND_S,
              "acked_step_floor": floor,
              "fenced_writes_counted": fenced_count,
              "violations": violations, "ok": not violations}
    print(f"REPRODUCE: python -m volcano_tpu_torch.tools.chaos_conductor "
          f"--seed {seed} --duration {duration:g} "
          f"--classes {','.join(sorted(classes))}",
          file=sys.stderr, flush=True)
    return result


def run_conductor(seed: int, duration: float,
                  classes=DEFAULT_CLASSES, logdir: str = "",
                  lock_audit: bool = False,
                  race_audit: bool = False,
                  sweep_backend: str = "thread",
                  scheduler_shards: int = 1,
                  leader_groups: int = 1) -> dict:
    classes = set(classes.split(",")) if isinstance(classes, str) \
        else set(classes)
    if "router" in classes:
        # router replica-set failover runs on the federation fleet
        # with router OS processes — its own scenario, like region
        return run_router_failover(seed, duration, classes, logdir)
    if "region" in classes:
        # whole-region loss runs on a different topology entirely
        # (the federation fleet: 2 regions behind one global queue),
        # so like the replication class it gets its own scenario
        return run_region_kill(seed, duration, classes, logdir)
    sched = build_plan(seed, duration, classes)
    plan_doc = {"seed": seed, "rules": sched["rules"]}
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "chaos_conductor", f"seed-{seed}")
    import shutil
    shutil.rmtree(logdir, ignore_errors=True)
    audit_dir = os.path.join(logdir, "lockaudit")
    race_dir = os.path.join(logdir, "raceaudit")
    audit_env = {}
    if lock_audit:
        # arm the runtime lock-order auditor (analysis/lockaudit.py)
        # in EVERY child process (server, replicas, scheduler,
        # controllers, agents) and in this conductor too: each
        # process flushes its acquisition graph + violations to
        # audit_dir at 2Hz and at exit, so even a SIGKILL'd server
        # incarnation leaves its last graph behind
        os.makedirs(audit_dir, exist_ok=True)
        from volcano_tpu_torch.analysis import lockaudit
        lockaudit.install()
        audit_env.update(VTP_LOCK_AUDIT="1",
                         VTP_LOCK_AUDIT_OUT=audit_dir)
    if race_audit:
        # arm the snapshot-freeze/data-race auditor the same way
        # (analysis/freezeaudit.py): every scheduler session in the
        # plane deep-freezes its snapshot, and the scheduler child
        # additionally runs the PARALLEL predicate sweep so the
        # fan-out is certified against real chaos traffic, not just
        # tier-1 fixtures
        os.makedirs(race_dir, exist_ok=True)
        from volcano_tpu_torch.analysis import freezeaudit
        freezeaudit.install()
        audit_env.update(VTP_RACE_AUDIT="1",
                         VTP_RACE_AUDIT_OUT=race_dir)
    if audit_env:
        zoo = chaoslib.ProcessZoo(logdir, env=chaoslib.repo_env(
            **audit_env))
    else:
        zoo = chaoslib.ProcessZoo(logdir)
    data_dir = os.path.join(logdir, "state")
    progress_root = os.path.join(logdir, "progress")
    os.makedirs(progress_root, exist_ok=True)
    plan_path = os.path.join(logdir, "fault_plan.json")
    with open(plan_path, "w", encoding="utf-8") as f:
        json.dump(plan_doc, f)
    port = chaoslib.free_port()
    url = f"http://127.0.0.1:{port}"
    server_faulted = ["--data-dir", data_dir,
                      "--fault-plan", f"@{plan_path}"]
    server_clean = ["--data-dir", data_dir]

    print(f"chaos conductor: seed={seed} duration={duration}s "
          f"classes={sorted(classes)} logs={logdir}", flush=True)
    print(f"  schedule: {json.dumps(sched['windows'])} "
          f"{len(sched['rules'])} rules", flush=True)

    result = {"seed": seed, "duration_s": duration,
              "classes": sorted(classes),
              "scheduler_shards": scheduler_shards,
              "leader_groups": leader_groups,
              "windows": sched["windows"]}
    c = None
    proxy = None
    replication = sched.get("replication")
    repl_topology = None
    f_urls = []
    f_dirs = []
    plane_url = url
    try:
        if replication:
            # 3-replica group: the fault-armed leader plus two
            # followers; f1 ships THROUGH a ChaosProxy (the
            # partition-able link), f2 direct.  Campaign/peer traffic
            # stays on the direct URLs, so a shipping partition is a
            # partition, not a total disappearance.
            f_ports = [chaoslib.free_port(), chaoslib.free_port()]
            f_urls = [f"http://127.0.0.1:{p}" for p in f_ports]
            f_dirs = [os.path.join(logdir, f"state-f{i + 1}")
                      for i in range(2)]
            proxy = chaoslib.ChaosProxy(port)
            proxy.start()
            proxy_url = f"http://127.0.0.1:{proxy.port}"
            zoo.spawn_server(port, *server_faulted, "--replica-id",
                             "r1", "--peers", ",".join(f_urls),
                             "--repl-ttl", "1.5")
            chaoslib.wait_server(url)
            chaoslib.spawn_replica(
                zoo, "f1", f_ports[0], f_dirs[0], "r2",
                [url, f_urls[1]], replicate_from=proxy_url)
            chaoslib.spawn_replica(
                zoo, "f2", f_ports[1], f_dirs[1], "r3",
                [url, f_urls[0]], replicate_from=url)
            for u in f_urls:
                chaoslib.wait_server(u)
            chaoslib.wait_role(url, "leader")
            repl_topology = {"leader": url, "followers": list(f_urls)}
            plane_url = ",".join([url] + f_urls)
        else:
            zoo.spawn_server(port, *server_faulted)
            chaoslib.wait_server(url)
        # keyspace-partitioned write leaders (docs/design/sharding.md):
        # group 0 is the fault-armed plane above (meta keyspace + its
        # node subtrees); groups 1.. are clean single-server leaders
        # owning the remaining subtrees.  Faults stay on group 0 — the
        # invariants keep polling the faulted group while keyed writes
        # (binds, pod status) split across every group.
        g_urls = []
        client_spec = plane_url
        if leader_groups > 1:
            for gi in range(1, leader_groups):
                gp = chaoslib.free_port()
                zoo.spawn_server(
                    gp, "--data-dir",
                    os.path.join(logdir, f"state-g{gi}"),
                    name=f"server-g{gi}")
                g_urls.append(f"http://127.0.0.1:{gp}")
            for gu in g_urls:
                chaoslib.wait_server(gu)
            client_spec = ";".join([plane_url] + g_urls)
        t_plan0 = time.monotonic()     # ~ the server plan's t0
        # leader-elected scheduler(s): the clock-jump invariant is
        # about the LEASE surviving a wall step — there must be a
        # lease.  With --scheduler-shards N, N schedulers each own a
        # disjoint subtree shard and elect on their own per-shard
        # lease ("scheduler-shard0", ...); the clock invariant tracks
        # shard 0's lease.
        sched_extra = []
        if race_audit or scheduler_shards > 1:
            conf_path = os.path.join(logdir, "sched_conf.yaml")
            import yaml
            from volcano_tpu_torch.conf import DEFAULT_SCHEDULER_CONF
            conf_doc = dict(DEFAULT_SCHEDULER_CONF)
            alloc_conf = {}
            if race_audit:
                # the pilot under certification: default conf + the
                # parallel leaf-shard predicate sweep
                alloc_conf.update(
                    {"parallelPredicates": sweep_backend,
                     "parallelPredicates.workers": 8})
            if scheduler_shards > 1:
                # the sharded plane runs the batched gang commit and
                # soft cross-shard spill — the production shape the
                # chaos certification is for
                alloc_conf.update({"gangCommit": "batch",
                                   "shard-spill": "soft"})
            conf_doc["configurations"] = {"allocate": alloc_conf}
            with open(conf_path, "w", encoding="utf-8") as f:
                yaml.safe_dump(conf_doc, f)
            sched_extra = ["--conf", conf_path]
        sched_lease = "scheduler-shard0" if scheduler_shards > 1 \
            else "scheduler"
        for si in range(scheduler_shards):
            shard_flags = list(sched_extra)
            if scheduler_shards > 1:
                shard_flags += ["--shard-index", str(si),
                                "--shard-count", str(scheduler_shards)]
            zoo.spawn_plane(
                f"sched-{si}" if scheduler_shards > 1 else "sched",
                client_spec, "scheduler",
                "--leader-elect", "--holder", f"s{si + 1}",
                "--lease-ttl", "1.5", *shard_flags)
        zoo.spawn_plane("ctrl", client_spec, "controllers")

        # high-rate sampler: the main loop slows down under injected
        # faults (that is the point), so the degrade/heal windows and
        # the lease holder are sampled on their own 100ms thread
        import threading
        samples = []            # (t_rel, readonly_reason, visible_rv)
        leader_track = []       # (t_rel, holder)
        repl_reads = []         # (t_rel, ok) — follower read liveness
        inv = None              # InvariantTracker, created below
        sampler_stop = threading.Event()
        # with replication on, the lease/rv sampling moves to f2 (a
        # replica that lives through the whole run): leases are
        # WAL-shipped, so the follower's view IS the group's, and its
        # 10Hz answers double as the continuous-follower-reads proof
        sample_url = f_urls[1] if replication else url

        def sampler():
            while not sampler_stop.wait(0.1):
                t_rel = time.monotonic() - t_plan0
                dur = chaoslib.http_json(url + "/durability",
                                         timeout=2)
                if dur:
                    samples.append((t_rel, dur.get("readonly") or "",
                                    int(dur.get("visible_rv") or 0)))
                leader_track.append((t_rel, chaoslib.leader(
                    sample_url, sched_lease)))
                if replication:
                    repl_reads.append(
                        (t_rel, chaoslib.http_json(
                            sample_url + "/durability", timeout=2)
                         is not None))
                    # the partitioned follower's advertised lag, at
                    # 10Hz: the churn loop can stall for seconds on a
                    # faulted submit and miss a whole lag window
                    d = chaoslib.http_json(
                        f_urls[0] + "/durability", timeout=2)
                    if d and inv is not None:
                        lag = float((d.get("replication") or {})
                                    .get("lag_s") or 0.0)
                        inv.follower_lag_max[f_urls[0]] = max(
                            inv.follower_lag_max.get(f_urls[0], 0.0),
                            lag)

        threading.Thread(target=sampler, daemon=True).start()

        from volcano_tpu_torch.api import goodput as gapi
        from volcano_tpu_torch.api import elastic as eapi
        from volcano_tpu_torch.api.pod import make_pod
        from volcano_tpu_torch.api.resource import GPU
        from volcano_tpu_torch.api.types import RUN_TICKS_ANNOTATION
        from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
        from volcano_tpu_torch.cache.remote_cluster import RemoteCluster

        # watches THROUGH every fault; with replication the client is
        # multi-endpoint — writes follow the leader across the kill,
        # reads stick to one replica.  With partitioned leaders the
        # mirror is the keyspace-routing client: one watch per group,
        # merged reads, binds relocating pods to their owner group.
        if leader_groups > 1:
            from volcano_tpu_torch.cache.partitioned import \
                PartitionedCluster
            c = PartitionedCluster(client_spec)
        else:
            c = RemoteCluster(plane_url)
        chaoslib.seed_slices(c, ("sa", "sb", "sc"))
        acked_jobs = set()

        # the long elastic gang: resizes + failover churn exercise
        # the resume-step floor; its progress stream (real agents)
        # exercises the goodput ledger
        elastic_key = "default/echaos"
        c.add_vcjob(VCJob(
            name="echaos", min_available=4,
            annotations={
                eapi.ELASTIC_MIN_SLICES_ANNOTATION: "1",
                eapi.ELASTIC_MAX_SLICES_ANNOTATION: "2",
                eapi.ELASTIC_SLICES_ANNOTATION: "1",
                "failover.volcano-tpu.io/last-checkpoint-step":
                    str(FLOOR_STEP),
                gapi.PROGRESS_DIR_ANNOTATION: progress_root,
            },
            plugins={"torch": []},
            tasks=[TaskSpec(name="worker", replicas=4,
                            template=make_pod(
                                "t", requests={"cpu": 4, GPU: 4},
                                annotations={RUN_TICKS_ANNOTATION:
                                             "1000000"}))]))
        acked_jobs.add(elastic_key)

        # the serving churn class: a serving-class elastic gang whose
        # replica stats (REAL ServingCollector/Handler -> wire -> fold)
        # feed the autoscaler while the classic faults fly — decisions
        # ride the same elastic resize path the echaos gang churns
        serving_key = ""
        serving_root = os.path.join(logdir, "serving")
        if "serving" in classes:
            from volcano_tpu_torch.api import serving as sapi
            os.makedirs(serving_root, exist_ok=True)
            serving_key = "default/schaos"
            c.add_vcjob(VCJob(
                name="schaos", min_available=4,
                annotations={
                    sapi.SLO_P99_MS_ANNOTATION: "50",
                    sapi.MIN_REPLICAS_ANNOTATION: "1",
                    sapi.MAX_REPLICAS_ANNOTATION: "2",
                    sapi.TARGET_QPS_ANNOTATION: "100",
                    sapi.STATS_DIR_ANNOTATION: serving_root,
                    eapi.ELASTIC_SLICES_ANNOTATION: "1",
                },
                plugins={"torch": []},
                tasks=[TaskSpec(name="replica", replicas=4,
                                template=make_pod(
                                    "s", requests={"cpu": 4, GPU: 4},
                                    annotations={RUN_TICKS_ANNOTATION:
                                                 "1000000"}))]))
            acked_jobs.add(serving_key)

        from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
        from volcano_tpu_torch.agent.collect import GoodputCollector
        from volcano_tpu_torch.agent.handlers import GoodputHandler
        from volcano_tpu_torch.workloads.progress import ProgressReporter

        goodput_col = GoodputCollector(progress_root)
        goodput_agents = {}
        fed = {"step": FLOOR_STEP, "epoch": 0}

        def feed_goodput():
            """Play the long gang's workers + node agents for one
            beat (the soak.py contract: epoch-aware progress files ->
            REAL GoodputCollector/Handler -> wire -> store fold)."""
            epg = c.podgroups.get(elastic_key)
            ej = c.vcjobs.get(elastic_key)
            if epg is None or ej is None:
                return
            epoch = _iann(epg.annotations,
                          "failover.volcano-tpu.io/generation") + \
                _iann(epg.annotations, eapi.ELASTIC_GENERATION_ANNOTATION)
            if epoch != fed["epoch"]:
                fed["epoch"] = epoch
                fed["step"] = max(FLOOR_STEP, _iann(
                    epg.annotations,
                    "failover.volcano-tpu.io/resume-step"))
            fed["step"] += 1
            pods = [p for p in c.pods.values()
                    if p.owner == ej.uid and p.node_name
                    and getattr(p.phase, "value", p.phase) == "Running"]
            for p in pods:
                ProgressReporter(
                    gapi.progress_file_for(progress_root, p.uid),
                    epoch=fed["epoch"]).report(
                        step=fed["step"], examples=fed["step"] * 8.0)
                if p.node_name not in goodput_agents:
                    goodput_agents[p.node_name] = NodeAgent(
                        c, p.node_name, FakeUsageProvider(),
                        handlers=[GoodputHandler],
                        goodput_collector=goodput_col)
            for agent in goodput_agents.values():
                try:
                    agent.sync()
                except Exception as e:  # noqa: BLE001 — chaos is on
                    print("goodput agent sync failed:", e, flush=True)

        serving_agents = {}
        served = {"requests": 0, "slo_ok": 0}

        def feed_serving():
            """Play the serving gang's replicas + node agents for one
            beat: cumulative stats files (epoch = elastic generation,
            so a resize restart reads as a ledger restart, not a
            regression) -> REAL ServingCollector/Handler -> wire ->
            store fold the serving_monotonic invariant audits."""
            if not serving_key:
                return
            from volcano_tpu_torch.agent.collect import ServingCollector
            from volcano_tpu_torch.agent.handlers import ServingHandler
            from volcano_tpu_torch.api import serving as sapi
            from volcano_tpu_torch.workloads.serve import \
                ServingStatsReporter
            spg = c.podgroups.get(serving_key)
            sj = c.vcjobs.get(serving_key)
            if spg is None or sj is None:
                return
            epoch = _iann(spg.annotations,
                          eapi.ELASTIC_GENERATION_ANNOTATION)
            served["requests"] += 30
            served["slo_ok"] += 30
            pods = [p for p in c.pods.values()
                    if p.owner == sj.uid and p.node_name
                    and getattr(p.phase, "value", p.phase)
                    == "Running"]
            for p in pods:
                ServingStatsReporter(
                    sapi.stats_file_for(serving_root, p.uid),
                    epoch=epoch).report(
                        requests=served["requests"],
                        slo_ok=served["slo_ok"],
                        p50_ms=4.0, p99_ms=30.0)
                if p.node_name not in serving_agents:
                    serving_agents[p.node_name] = NodeAgent(
                        c, p.node_name, FakeUsageProvider(),
                        handlers=[ServingHandler],
                        serving_collector=ServingCollector(
                            serving_root))
            for agent in serving_agents.values():
                try:
                    agent.sync()
                except Exception as e:  # noqa: BLE001 — chaos is on
                    print("serving agent sync failed:", e, flush=True)

        inv = InvariantTracker(c, url, elastic_key,
                               repl=repl_topology,
                               serving_key=serving_key)
        import random as _random
        churn_rng = _random.Random(seed * 7919 + 13)
        submit_latencies = []
        submit_failures = 0
        submitted = 1    # the elastic gang
        killed_host = None
        # replication event state
        partitioned = False
        leader_killed_at = None
        leader_respawned = False
        promote_s = None
        new_leader_url = None
        faults_before_kill = None
        repl_state = {"partitioned": partitioned,
                      "killed_at": leader_killed_at,
                      "respawned": leader_respawned,
                      "promote_s": promote_s,
                      "new_leader": new_leader_url,
                      "faults_before_kill": faults_before_kill}
        # serializes the one-shot kill/respawn steps: the tick thread
        # and the post-settle direct call may otherwise interleave
        repl_tick_lock = threading.Lock()

        def replication_tick(now_s: float) -> None:
            """Drive the replication fault schedule (called from the
            tick thread AND once after settle — the kill lands late,
            so the promotion/rejoin tail often completes during
            settle).  Serialized: the one-shot steps are guarded by
            plain flags."""
            if not replication or not repl_tick_lock.acquire(
                    timeout=10.0):
                return
            try:
                _replication_tick_locked(now_s)
            finally:
                repl_tick_lock.release()

        def _replication_tick_locked(now_s: float) -> None:
            p0, p1 = replication["partition"]
            if not repl_state["partitioned"] and p0 <= now_s < p1:
                repl_state["partitioned"] = True
                proxy.set_mode("blackhole")
                print(f"replication fault: f1<->leader shipping "
                      f"PARTITIONED at t={now_s:.1f}s", flush=True)
            elif repl_state["partitioned"] and now_s >= p1:
                repl_state["partitioned"] = False
                proxy.set_mode("pass")
                print(f"replication fault: partition healed at "
                      f"t={now_s:.1f}s", flush=True)
            if repl_state["killed_at"] is None and \
                    now_s >= replication["kill_leader_at"]:
                repl_state["faults_before_kill"] = chaoslib.http_json(
                    url + "/faults") or {}
                zoo.kill9("server")
                repl_state["killed_at"] = time.monotonic()
                print(f"replication fault: leader SIGKILLed at "
                      f"t={now_s:.1f}s", flush=True)
            if repl_state["killed_at"] is not None and \
                    repl_state["new_leader"] is None:
                for u in f_urls:
                    st_r = chaoslib.replication_status(u)
                    if st_r and st_r.get("role") == "leader":
                        repl_state["new_leader"] = u
                        repl_state["promote_s"] = \
                            time.monotonic() - repl_state["killed_at"]
                        inv.repl["leader"] = u
                        inv.repl["followers"] = [
                            x for x in f_urls if x != u]
                        inv.url = u
                        print(f"replication: {u} PROMOTED "
                              f"{repl_state['promote_s']:.2f}s after "
                              f"the kill (term {st_r.get('term')})",
                              flush=True)
                        break
            if repl_state["new_leader"] is not None and \
                    not repl_state["respawned"]:
                # the deposed leader rejoins over its old dir: its
                # stale term forces the full re-sync
                chaoslib.spawn_replica(
                    zoo, "server-rejoin", port, data_dir, "r1",
                    f_urls, replicate_from="auto")
                repl_state["respawned"] = True
                inv.repl["followers"].append(url)

        # the replication fault schedule runs on its own 100ms thread:
        # the churn loop can block for seconds inside a submit retry
        # (that is the point of the wire faults), and a partition that
        # starts late because a submit was stuck would smear the
        # windows the recovery audit measures
        repl_tick_stop = threading.Event()
        if replication:
            def repl_tick_loop():
                while not repl_tick_stop.wait(0.1):
                    try:
                        replication_tick(time.monotonic() - t_plan0)
                    except Exception as e:  # noqa: BLE001
                        print("replication tick failed:", e,
                              flush=True)
            threading.Thread(target=repl_tick_loop,
                             daemon=True).start()

        i = 0
        t_end = time.monotonic() + duration
        while time.monotonic() < t_end:
            now_s = time.monotonic() - t_plan0
            n = churn_rng.choice((1, 2, 4))
            t0 = time.monotonic()
            try:
                c.add_vcjob(chaoslib.gang_job(f"cj-{seed}-{i}", n))
                acked_jobs.add(f"default/cj-{seed}-{i}")
                submitted += 1
                submit_latencies.append(time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 — chaos is on
                submit_failures += 1
                print(f"submit failed at t={now_s:.1f}s: {e}",
                      flush=True)
            i += 1
            if sched["slice_kill_at"] is not None and \
                    killed_host is None and \
                    now_s >= sched["slice_kill_at"]:
                from volcano_tpu_torch.simulator import fail_host
                killed_host = "sc-w0"
                try:
                    fail_host(c, killed_host)
                    print(f"slice fault: killed {killed_host} at "
                          f"t={now_s:.1f}s", flush=True)
                except Exception as e:  # noqa: BLE001
                    print("fail_host failed:", e, flush=True)
                    killed_host = None
            feed_goodput()
            feed_serving()
            inv.poll()
            time.sleep(churn_rng.uniform(0.25, 0.6))

        # settle: every fault window is over (until_s <= duration);
        # give the plane a fault-free tail to finish the short gangs
        settle_until = time.monotonic() + min(30.0, duration)
        while time.monotonic() < settle_until:
            feed_goodput()
            feed_serving()
            inv.poll()
            done = sum(1 for j in c.vcjobs.values()
                       if getattr(j.phase, "value", j.phase)
                       == "Completed")
            if done >= submitted - 1 and (
                    not replication or
                    repl_state["new_leader"] is not None):
                break               # all short gangs (+ promotion)
            time.sleep(0.5)
        if replication:
            # the promotion tail must complete before the audits:
            # new leader elected, deposed leader re-synced back in
            chaoslib.wait_for(
                lambda: repl_state["new_leader"] is not None,
                60, "a follower promoting after the leader kill")
            repl_tick_stop.set()
            replication_tick(time.monotonic() - t_plan0)
            truth_url = repl_state["new_leader"]
            chaoslib.wait_role(url, "follower", timeout=60)
            chaoslib.wait_follower_caught_up(url, truth_url,
                                             timeout=60)
        else:
            truth_url = url

        # -- end-of-run audits ---------------------------------------
        sampler_stop.set()
        time.sleep(1.0)
        c.resync()
        inv.poll()
        phases = chaoslib.phase_counts(c)
        truth = _truth_stores([truth_url] + g_urls)
        missing = [k for k in acked_jobs if k not in truth["vcjob"]]
        if missing:
            inv.note("acked_durable",
                     f"{len(missing)} acked vcjobs missing: "
                     f"{missing[:5]}")
        # the mirror that watched THROUGH everything must converge.
        # The plane is still live (ticks, status flushes), so compare
        # snapshot-vs-mirror repeatedly until a quiescent pair
        # matches — only a divergence that never settles is real.
        final_rv = int((chaoslib.http_json(truth_url + "/durability")
                        or {}).get("visible_rv") or 0)
        meta_mirror = c.groups[0] if leader_groups > 1 else c
        try:
            chaoslib.wait_for(lambda: meta_mirror._rv >= final_rv, 20,
                              "mirror caught up after heal")
        except AssertionError as e:
            inv.note("mirror_converged", str(e))
        div = None
        for _ in range(8):
            truth = _truth_stores([truth_url] + g_urls)
            div = chaoslib.mirror_divergence(c, truth)
            if div == 0:
                break
            time.sleep(0.5)
        if div:
            inv.note("mirror_converged", f"{div} diverged entries "
                     "(stable across 8 compares)")
        faults_fired = repl_state["faults_before_kill"] if replication \
            else chaoslib.http_json(url + "/faults") or {}
        if scheduler_shards > 1:
            # every shard's cycles stamp labels.shard on the meta
            # /traces ring — the run only counts as sharded if every
            # shard actually scheduled through the faults
            tr = chaoslib.http_json(url + "/traces?limit=128") or {}
            result["sched_shards_traced"] = sorted(
                {(t.get("root", {}).get("labels") or {}).get("shard")
                 for t in tr.get("traces", [])} - {None})
            want = {f"{i}/{scheduler_shards}"
                    for i in range(scheduler_shards)}
            if not want <= set(result["sched_shards_traced"]):
                inv.note("sharded_plane",
                         f"sharded plane incomplete: traced "
                         f"{result['sched_shards_traced']}, "
                         f"wanted {sorted(want)}")
        if leader_groups > 1:
            result["leader_group_rv"] = [
                int((chaoslib.http_json(u + "/durability") or {})
                    .get("rv") or 0) for u in [url] + g_urls]
            result["leader_group_layout"] = c.shard_layout()

        # the plane's processes that exited on their own, before the
        # drill below kills and refuses boots on purpose
        result["dead_processes"] = zoo.died()

        # -- CRC bit-rot drill: kill -9, flip one bit mid-WAL, boot
        # must REFUSE (exit 3); restore the byte, boot must recover —
        # then every acked job must still be there
        crc = {"checked": False}
        if replication:
            # replication flavor of the drill: a FOLLOWER's local WAL
            # must be a complete recovery point — kill a current
            # follower, flip one bit mid-WAL, a standalone boot over
            # its dir must REFUSE (per-record CRC); restore the byte
            # and every acked job must be in ITS recovered store.
            drill_url = [u for u in f_urls
                         if u != repl_state["new_leader"]][0]
            fi = f_urls.index(drill_url)
            drill_name, drill_dir = f"f{fi + 1}", f_dirs[fi]
            drill_port = int(drill_url.rsplit(":", 1)[1])
            rv_before = inv.max_rv
            chaoslib.wait_follower_caught_up(drill_url, truth_url,
                                             timeout=60)
            zoo.kill9(drill_name)
            seg, idx = _flippable_record(drill_dir)
            if seg is not None:
                from volcano_tpu_torch import faults as faults_mod
                off = faults_mod.flip_record_bit(seg, idx)
                crc.update({"checked": True, "replica": drill_name,
                            "segment": os.path.basename(seg),
                            "record": idx})
                zoo.spawn(f"{drill_name}-crc", "-m",
                          "volcano_tpu_torch.server", "--port",
                          str(drill_port), "--data-dir", drill_dir)
                code = zoo.wait_exit(f"{drill_name}-crc", timeout=30)
                refused = code == 3 and bool(zoo.scrape(
                    f"{drill_name}-crc", "refusing to boot"))
                crc["refused"] = refused
                if not refused:
                    inv.note("crc_refusal",
                             f"corrupt follower WAL boot exit={code},"
                             " no refusal banner")
                faults_mod.flip_bit(seg, off)
                zoo.spawn(f"{drill_name}-crc2", "-m",
                          "volcano_tpu_torch.server", "--port",
                          str(drill_port), "--data-dir", drill_dir)
                chaoslib.wait_server(drill_url)
                dur = chaoslib.http_json(drill_url + "/durability") \
                    or {}
                crc["recovered_rv"] = int(dur.get("rv") or 0)
                if crc["recovered_rv"] < rv_before:
                    inv.note("rv_monotonic",
                             f"follower post-restore rv "
                             f"{crc['recovered_rv']} < {rv_before}")
                truth2 = chaoslib.snapshot_stores(drill_url)
                missing2 = [k for k in acked_jobs
                            if k not in truth2["vcjob"]]
                if missing2:
                    inv.note("acked_durable",
                             f"{len(missing2)} acked vcjobs missing "
                             "from the follower's own recovery")
            else:
                crc["skipped"] = "no follower WAL segment with >=3 " \
                                 "records"
        elif "disk" in classes or "wire" in classes:
            rv_before = inv.max_rv
            zoo.kill9("server")
            seg, idx = _flippable_record(data_dir)
            if seg is not None:
                from volcano_tpu_torch import faults as faults_mod
                off = faults_mod.flip_record_bit(seg, idx)
                crc["checked"] = True
                crc["segment"] = os.path.basename(seg)
                crc["record"] = idx
                zoo.spawn("server", "-m", "volcano_tpu_torch.server",
                          "--port", str(port), "--tick-period", "0.2",
                          *server_clean)
                code = zoo.wait_exit("server", timeout=30)
                refused = code == 3 and bool(zoo.scrape(
                    "server", "refusing to boot"))
                crc["refused"] = refused
                if not refused:
                    inv.note("crc_refusal",
                             f"corrupt WAL boot exit={code}, "
                             "no refusal banner")
                # restore the flipped byte: the log is whole again
                faults_mod.flip_bit(seg, off)
                zoo.spawn("server", "-m", "volcano_tpu_torch.server",
                          "--port", str(port), "--tick-period", "0.2",
                          *server_clean)
                chaoslib.wait_server(url)
                dur = chaoslib.http_json(url + "/durability") or {}
                crc["recovered_rv"] = int(dur.get("rv") or 0)
                if crc["recovered_rv"] < rv_before:
                    inv.note("rv_monotonic",
                             f"post-restore rv {crc['recovered_rv']} "
                             f"< {rv_before}")
                truth2 = chaoslib.snapshot_stores(url)
                missing2 = [k for k in acked_jobs
                            if k not in truth2["vcjob"]]
                if missing2:
                    inv.note("acked_durable",
                             f"{len(missing2)} acked vcjobs lost "
                             "across the CRC drill")
            else:
                crc["skipped"] = "no WAL segment with >=3 records"

        # the sampler saw the durable revision at 10Hz: it must never
        # have gone backwards, degrade or not
        rv_seen = 0
        for t_rel, _ro, rv in samples:
            if rv < rv_seen:
                inv.note("rv_monotonic",
                         f"sampler saw rv {rv} < {rv_seen} at "
                         f"t={t_rel:.1f}s")
            rv_seen = max(rv_seen, rv)

        summary = inv.summary()
        recovery = {}
        for wname, (w0, w1) in sched["windows"].items():
            if wname == "clock_jump" or wname.startswith("repl_"):
                continue    # not disk-degrade windows
            # 10Hz readonly trace: degrade must have been observable
            # inside the window (+heal slack), and the first writable
            # sample after the last readonly one dates the recovery
            ro_ts = [t for t, ro, _rv in samples
                     if ro and w0 <= t <= w1 + 3.0]
            ep = {"window": [w0, w1],
                  "degrade_observed": bool(ro_ts)}
            if ro_ts:
                after = [t for t, ro, _rv in samples
                         if not ro and t > max(ro_ts)]
                if after:
                    ep["readonly_recover_s"] = round(
                        min(after) - w1, 3)
            recovery[wname] = ep
        if "clock" in classes and "clock_jump" in sched["windows"]:
            j0, j1 = sched["windows"]["clock_jump"]
            during = {l for t, l in leader_track
                      if j0 <= t <= j1 and l}
            before = {l for t, l in leader_track if t < j0 and l}
            recovery["clock_jump"] = {
                "window": [j0, j1],
                "leaders_during_jump": sorted(during),
                "leader_stable": bool(during) and
                len(during | before) <= 1}
            if not recovery["clock_jump"]["leader_stable"]:
                inv.note("clock_lease",
                         f"lease holder changed across the wall jump:"
                         f" before={sorted(before)} "
                         f"during={sorted(during)}")
        if submit_latencies:
            sl = sorted(submit_latencies)
            recovery["wire"] = {
                "submit_p50_s": round(sl[len(sl) // 2], 4),
                "submit_p95_s": round(
                    sl[min(len(sl) - 1, int(0.95 * len(sl)))], 4),
                "submit_failures": submit_failures}
        if replication:
            # follower-read liveness at 10Hz across partition, lag
            # window, leader kill and promotion: the max gap between
            # consecutive successful /durability answers from f2
            gaps, last_ok = [], None
            for t_rel, ok in repl_reads:
                if ok:
                    if last_ok is not None:
                        gaps.append(t_rel - last_ok)
                    last_ok = t_rel
            p0, p1 = replication["partition"]
            f1_lag = inv.follower_lag_max.get(f_urls[0], 0.0)
            recovery["replication"] = {
                "kill_leader_at": replication["kill_leader_at"],
                "promote_s": round(repl_state["promote_s"], 3)
                if repl_state["promote_s"] is not None else None,
                "new_leader": repl_state["new_leader"],
                "deposed_leader_rejoined": repl_state["respawned"],
                "partition_window": [p0, p1],
                "partitioned_follower_lag_max_s": round(f1_lag, 3),
                "partition_lag_observed": f1_lag >=
                (p1 - p0) * 0.5,
                "follower_reads_total": sum(
                    1 for _t, ok in repl_reads if ok),
                "follower_read_gap_max_s": round(max(gaps), 3)
                if gaps else None,
                "staleness_checks": inv.staleness_checks,
            }

        result.update({
            "submitted": submitted,
            "phases": phases,
            "completed": phases.get("Completed", 0),
            "killed_host": killed_host,
            "faults_injected": faults_fired.get("rules"),
            "invariants": summary,
            "recovery": recovery,
            "crc_drill": crc,
            "ok": not summary["violations"],
        })
        if lock_audit or race_audit:
            # terminate the plane BEFORE merging: SIGTERM triggers
            # each child's audit flush handlers (atexit never runs
            # under signals), so violations recorded after the last
            # 2Hz flush — the shutdown window where ordering races
            # live — still reach the merged report.  terminate_all is
            # idempotent; the finally's call becomes a no-op.
            zoo.terminate_all()
        if lock_audit:
            result["lock_audit"] = _collect_lock_audit(audit_dir)
            result["ok"] = result["ok"] and not \
                result["lock_audit"]["violations"]
        if race_audit:
            result["race_audit"] = _collect_race_audit(race_dir)
            result["race_audit"]["sweep_backend"] = sweep_backend
            result["ok"] = result["ok"] and not \
                result["race_audit"]["violations"]
        if not result["ok"]:
            # the full plane layout rides along: shard count and
            # leader-group layout change which scheduler binds what
            # and which server absorbs which write, so a replay
            # without them is a different run
            flag = (" --lock-audit" if lock_audit else "") + \
                (" --race-audit" if race_audit else "") + \
                (f" --sweep-backend {sweep_backend}"
                 if race_audit and sweep_backend != "thread" else "") + \
                (f" --scheduler-shards {scheduler_shards}"
                 if scheduler_shards != 1 else "") + \
                (f" --leader-groups {leader_groups}"
                 if leader_groups != 1 else "")
            print(f"\nREPRODUCE: python -m volcano_tpu_torch.tools.chaos_conductor "
                  f"--seed {seed} --duration {duration} "
                  f"--classes {','.join(sorted(classes))}{flag}",
                  flush=True)
        return result
    finally:
        if c is not None:
            c.close()
        if proxy is not None:
            proxy.close()
        zoo.terminate_all()


def _collect_lock_audit(audit_dir: str) -> dict:
    """Merge every process's flushed lockaudit report (plus this
    conductor's own, in-process) into one graph summary: unique lock
    sites, merged edges, all violations, all cycles."""
    import glob

    from volcano_tpu_torch.analysis import lockaudit
    lockaudit.flush(audit_dir)          # the conductor's own report
    locks, edges, violations, cycles = {}, {}, [], []
    same_site = {}
    reports = sorted(glob.glob(os.path.join(audit_dir, "*.json")))
    for path in reports:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            # vtplint: disable=except-pass (a report torn mid-flush by the 2Hz writer; the process's atexit flush supersedes it)
            continue
        for name, n in doc.get("locks", {}).items():
            locks[name] = locks.get(name, 0) + n
        for a, b, n in doc.get("edges", []):
            edges[(a, b)] = edges.get((a, b), 0) + n
        for name, n in doc.get("same_site_nestings", {}).items():
            same_site[name] = same_site.get(name, 0) + n
        violations.extend(doc.get("violations", []))
        for cyc in doc.get("cycles", []):
            if cyc not in cycles:
                cycles.append(cyc)
    return {
        "processes_reporting": len(reports),
        "lock_sites": len(locks),
        "acquisitions_total": sum(locks.values()),
        "edges": sorted([[a, b, n] for (a, b), n in edges.items()]),
        "same_site_nestings": same_site,
        "cycles": cycles,
        "violations": violations,
    }


def _collect_race_audit(race_dir: str) -> dict:
    """Merge every process's flushed freeze-audit report (plus this
    conductor's own, in-process) into one summary: frozen sessions,
    fan-out regions, tracked stores, all violations."""
    import glob

    from volcano_tpu_torch.analysis import freezeaudit
    freezeaudit.flush(race_dir)         # the conductor's own report
    sessions = objects = fanouts = 0
    tracked = {}
    violations = []
    reports = sorted(glob.glob(os.path.join(race_dir, "*.json")))
    for path in reports:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            # vtplint: disable=except-pass (a report torn mid-flush by the 2Hz writer; the process's atexit flush supersedes it)
            continue
        sessions += doc.get("sessions_frozen", 0)
        objects += doc.get("objects_frozen", 0)
        fanouts += doc.get("fanout_regions", 0)
        for name, n in doc.get("tracked_stores", {}).items():
            tracked[name] = tracked.get(name, 0) + n
        violations.extend(doc.get("violations", []))
    return {
        "processes_reporting": len(reports),
        "sessions_frozen": sessions,
        "objects_frozen": objects,
        "fanout_regions": fanouts,
        "tracked_stores": tracked,
        "violations": violations,
    }


def _truth_stores(urls) -> dict:
    """Ground truth across every leader group: group 0 (meta) first,
    then the node groups layered over it — the same merge order the
    partitioned client reads with, so a relocated pod's bound copy
    wins over a benign leftover meta copy."""
    truth = chaoslib.snapshot_stores(urls[0])
    for u in urls[1:]:
        extra = chaoslib.snapshot_stores(u)
        for kind, objs in extra.items():
            truth.setdefault(kind, {}).update(objs)
    return truth


def _flippable_record(data_dir: str):
    """A (segment, record_index) whose corruption is unambiguously
    MID-segment: at least 3 records, index in the middle."""
    try:
        segs = sorted(n for n in os.listdir(data_dir)
                      if n.startswith("wal-") and n.endswith(".log"))
    except OSError:
        return None, None
    for name in segs:
        path = os.path.join(data_dir, name)
        with open(path, "rb") as f:
            n = sum(1 for ln in f if ln.strip())
        if n >= 3:
            return path, n // 2
    return None, None


_READ_WORKER = r'''
import sys, time, urllib.request
url, dur = sys.argv[1], float(sys.argv[2])
t_end = time.monotonic() + dur
n = 0
paths = ["/durability", "/leases", "/watch?since=0&timeout=0"]
i = 0
while time.monotonic() < t_end:
    try:
        with urllib.request.urlopen(url + paths[i % 3],
                                    timeout=3) as r:
            r.read()
        n += 1
    except OSError:
        pass
    i += 1
print(n)
'''


def read_qps_scaling(n_readers: int = 6, measure_s: float = 4.0,
                     logdir: str = "") -> dict:
    """The read-capacity row: aggregate read QPS against a leader
    under sustained keyed write churn, vs the same reads spread over
    its followers — real OS processes end to end (server replicas AND
    reader workers; a single threaded client would GIL-cap the very
    number being measured).  This is the deployment the whole feature
    exists for: dashboards/vtpctl/watch mirrors polling while the
    single writer is busy."""
    import shutil
    import subprocess
    import tempfile
    import threading

    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    from volcano_tpu_torch.simulator import domain_nodes

    logdir = logdir or tempfile.mkdtemp(prefix="repl-qps-")
    ports = [chaoslib.free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    dirs = [os.path.join(logdir, f"qps-s{i}") for i in range(3)]
    zoo = chaoslib.ProcessZoo(logdir)
    stop = [False]
    writers = []
    try:
        chaoslib.spawn_replica(zoo, "qps-leader", ports[0], dirs[0],
                               "r1", urls[1:], tick_period=0.2)
        chaoslib.wait_server(urls[0])
        for i in (1, 2):
            chaoslib.spawn_replica(
                zoo, f"qps-f{i}", ports[i], dirs[i], f"r{i + 1}",
                [urls[0], urls[3 - i]], replicate_from=urls[0],
                tick_period=0.0)
            chaoslib.wait_server(urls[i])
        chaoslib.wait_role(urls[0], "leader")
        seed_c = RemoteCluster(urls[0], start_watch=False)
        node_names = []
        for node in domain_nodes(chaoslib.domain("qa"), ib_fabric="d0"):
            seed_c.put_object("node", node)
            node_names.append(node.name)
        seed_c.close()

        def writer(tid: int):
            cw = RemoteCluster(urls[0], start_watch=False)
            i = 0
            while not stop[0]:
                try:
                    p = make_pod("t", requests={"cpu": 1})
                    p.name = f"qw{tid}-{i}"
                    p.namespace = "default"
                    cw.put_object("pod", p)
                    cw.bind_pods([("default", p.name,
                                   node_names[i % len(node_names)])])
                except Exception:  # noqa: BLE001 — churn is load
                    pass
                i += 1
            cw.close()

        for t in range(3):
            th = threading.Thread(target=writer, args=(t,),
                                  daemon=True)
            th.start()
            writers.append(th)
        time.sleep(1.0)

        def measure_once(endpoints) -> float:
            procs = [subprocess.Popen(
                [sys.executable, "-c", _READ_WORKER,
                 endpoints[w % len(endpoints)], str(measure_s)],
                stdout=subprocess.PIPE, text=True,
                env=chaoslib.repo_env())
                for w in range(n_readers)]
            total = sum(int(p.communicate()[0].strip() or 0)
                        for p in procs)
            return round(total / measure_s, 1)

        def measure(endpoints) -> float:
            # median of 3 windows: a single window on a busy box
            # (this runs right after five chaos seeds) is noisy
            runs = sorted(measure_once(endpoints) for _ in range(3))
            return runs[1]

        leader_only = measure([urls[0]])
        one_follower = measure([urls[1]])
        two_followers = measure([urls[1], urls[2]])
        return {
            "readers": n_readers, "measure_s": measure_s,
            "windows_per_config": 3, "statistic": "median",
            "write_load": "3 writer threads, keyed put+bind churn "
                          "at the leader throughout",
            "read_mix": "/durability + /leases + /watch delta",
            "leader_only_qps": leader_only,
            "one_follower_qps": one_follower,
            "two_followers_qps": two_followers,
            "scaling_1f": round(one_follower / leader_only, 2)
            if leader_only else None,
            "scaling_2f": round(two_followers / leader_only, 2)
            if leader_only else None,
        }
    finally:
        stop[0] = True
        for th in writers:
            th.join(timeout=5)
        zoo.terminate_all()
        shutil.rmtree(logdir, ignore_errors=True)


def run_matrix(seeds, duration: float, classes: str,
               out: str = "", lock_audit: bool = False,
               race_audit: bool = False,
               sweep_backend: str = "thread",
               scheduler_shards: int = 1,
               leader_groups: int = 1) -> dict:
    rows = []
    for seed in seeds:
        rows.append(run_conductor(seed, duration, classes,
                                  lock_audit=lock_audit,
                                  race_audit=race_audit,
                                  sweep_backend=sweep_backend,
                                  scheduler_shards=scheduler_shards,
                                  leader_groups=leader_groups))
        print(json.dumps({"seed": seed, "ok": rows[-1]["ok"]}),
              flush=True)
    invariant_names = sorted(rows[0]["invariants"]["passed"])
    matrix = {inv: all(r["invariants"]["passed"][inv] for r in rows)
              for inv in invariant_names}
    recover = [r["recovery"].get("enospc", {}).get("readonly_recover_s")
               for r in rows]
    recover = sorted(x for x in recover if x is not None)
    eio = sorted(x for x in (
        r["recovery"].get("eio", {}).get("readonly_recover_s")
        for r in rows) if x is not None)
    doc = {
        "metric": "gray_failure_chaos_matrix",
        "seeds": [r["seed"] for r in rows],
        "duration_s": duration,
        "classes": rows[0]["classes"],
        "scheduler_shards": scheduler_shards,
        "leader_groups": leader_groups,
        "hosts": 12,
        "invariant_matrix": matrix,
        "zero_violations": all(r["ok"] for r in rows),
        "total_faults_injected": sum(
            sum(rule.get("injected", 0)
                for rule in (r.get("faults_injected") or []))
            for r in rows),
        "submitted_total": sum(r["submitted"] for r in rows),
        "completed_total": sum(r["completed"] for r in rows),
        "enospc_readonly_recover_s": {
            "p50": recover[len(recover) // 2] if recover else None,
            "max": recover[-1] if recover else None},
        "eio_readonly_recover_s": {
            "p50": eio[len(eio) // 2] if eio else None,
            "max": eio[-1] if eio else None},
        "crc_refusals": sum(
            1 for r in rows if r["crc_drill"].get("refused")),
        "clock_jump_leader_stable": all(
            r["recovery"].get("clock_jump", {}).get("leader_stable",
                                                    True)
            for r in rows),
        "wire_submit_p95_s": max(
            (r["recovery"].get("wire", {}).get("submit_p95_s") or 0)
            for r in rows),
        "resume_floor_exercised": any(
            r["invariants"]["resume_floor_exercised"] for r in rows),
        "goodput_ledger_exercised": any(
            r["invariants"]["goodput_ledger_exercised"] for r in rows),
        "serving_ledger_exercised": any(
            r["invariants"].get("serving_ledger_exercised")
            for r in rows),
        "per_seed": rows,
    }
    if "replication" in rows[0]["classes"]:
        promotes = sorted(
            r["recovery"]["replication"]["promote_s"]
            for r in rows
            if r["recovery"].get("replication", {}).get("promote_s")
            is not None)
        doc["replication"] = {
            "replicas": 3,
            "promotions": len(promotes),
            "promote_p50_s": promotes[len(promotes) // 2]
            if promotes else None,
            "promote_max_s": promotes[-1] if promotes else None,
            "acked_writes_lost_across_promotions": 0 if all(
                r["invariants"]["passed"]["acked_durable"]
                for r in rows) else "SEE per_seed",
            "deposed_leader_rejoined_all": all(
                r["recovery"].get("replication", {}).get(
                    "deposed_leader_rejoined") for r in rows),
            "partition_lag_observed_all": all(
                r["recovery"].get("replication", {}).get(
                    "partition_lag_observed") for r in rows),
            "follower_read_gap_max_s": max(
                (r["recovery"].get("replication", {}).get(
                    "follower_read_gap_max_s") or 0) for r in rows),
            "staleness_checks_total": sum(
                r["invariants"].get("staleness_checks", 0)
                for r in rows),
            "corrupt_ship_injected_total": sum(
                sum(rule.get("injected", 0)
                    for rule in (r.get("faults_injected") or [])
                    if rule.get("kind") == "corrupt_ship")
                for r in rows),
        }
        print("measuring read-QPS scaling row "
              "(leader+2 followers, write churn)...", flush=True)
        doc["read_qps_scaling"] = read_qps_scaling()
    if scheduler_shards > 1:
        doc["sched_shards_traced_all_seeds"] = all(
            set(r.get("sched_shards_traced") or []) >=
            {f"{i}/{scheduler_shards}"
             for i in range(scheduler_shards)} for r in rows)
    if leader_groups > 1:
        doc["leader_groups_all_absorbed_writes"] = all(
            (r.get("leader_group_rv") or []) and
            all(rv > 0 for rv in r["leader_group_rv"]) for r in rows)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {out}", flush=True)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos-conductor")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--classes", default=DEFAULT_CLASSES,
                    help="comma set of wire,disk,clock,slice,"
                         "replication,serving,region,router")
    ap.add_argument("--logdir", default="")
    ap.add_argument("--matrix", type=int, default=0,
                    help="run seeds 1..N and aggregate the "
                         "invariant pass matrix")
    ap.add_argument("--out", default="",
                    help="write the matrix JSON here")
    ap.add_argument("--print-schedule", action="store_true",
                    help="dump the derived fault plan for --seed and "
                         "exit (no processes; reproducibility check)")
    ap.add_argument("--lock-audit", action="store_true",
                    help="arm analysis/lockaudit.py in every process "
                         "and fail the run on any lock-order/guarded-"
                         "store violation (the vtplint runtime smoke)")
    ap.add_argument("--race-audit", action="store_true",
                    help="arm analysis/freezeaudit.py in every "
                         "process (snapshot deep-freeze + unsync-pair "
                         "tracking), run the scheduler with the "
                         "parallel predicate sweep, and fail the run "
                         "on any race/freeze violation")
    ap.add_argument("--scheduler-shards", type=int, default=1,
                    help="run N subtree-sharded schedulers (each "
                         "leader-elected on its own per-shard lease) "
                         "instead of the single plane scheduler; "
                         "carried on the REPRODUCE line")
    ap.add_argument("--leader-groups", type=int, default=1,
                    help="split the keyspace across N write-leader "
                         "groups (group 0 keeps the fault plan + meta "
                         "keyspace); carried on the REPRODUCE line")
    ap.add_argument("--sweep-backend", default="thread",
                    choices=("thread", "process"),
                    help="which parallel sweep backend the "
                         "--race-audit scheduler runs: the GIL-bound "
                         "thread pool or the "
                         "mirror-worker process pool "
                         "(actions/procpool.py)")
    args = ap.parse_args(argv)
    classes = args.classes
    if args.print_schedule:
        print(json.dumps(build_plan(
            args.seed, args.duration, set(classes.split(","))),
            indent=1, sort_keys=True))
        return 0
    if args.matrix:
        doc = run_matrix(range(1, args.matrix + 1), args.duration,
                         classes, out=args.out,
                         lock_audit=args.lock_audit,
                         race_audit=args.race_audit,
                         sweep_backend=args.sweep_backend,
                         scheduler_shards=args.scheduler_shards,
                         leader_groups=args.leader_groups)
        print(json.dumps({k: v for k, v in doc.items()
                          if k != "per_seed"}, indent=1))
        return 0 if doc["zero_violations"] else 1
    out = run_conductor(args.seed, args.duration, classes,
                        logdir=args.logdir,
                        lock_audit=args.lock_audit,
                        race_audit=args.race_audit,
                        sweep_backend=args.sweep_backend,
                        scheduler_shards=args.scheduler_shards,
                        leader_groups=args.leader_groups)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""HTTP/JSON state server — the apiserver analogue.

This is the wire boundary the reference control plane is built around:
scheduler, controller manager, agent scheduler and node agents run as
separate OS processes and coordinate ONLY through this server, the way
the reference components only meet at the Kubernetes apiserver
(pkg/scheduler/cache/cache.go:109 informer wiring, cache.go:984 bind
POST, event_handlers.go watch dispatch).

Design:
  * The authoritative store is a FakeCluster (same semantics in-process
    and served — one implementation of truth).  The admission chain
    runs server-side on create, like real webhooks at the apiserver.
  * Every mutation appends to a monotonically-versioned event log; GET
    /watch?since=rv long-polls it.  Clients that fall off the ring
    re-list (resync), mirroring k8s watch/"too old resource version".
  * Leases implement leader election (cmd/scheduler/app/server.go:99):
    compare-and-swap on {name, holder, ttl} under the server lock.
  * POST /tick advances the simulated kubelet (Bound->Running,
    Releasing->deleted), or --tick-period makes the server self-tick.

Stdlib-only (ThreadingHTTPServer + urllib on the client side).
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from volcano_tpu_torch.api import codec
from volcano_tpu_torch.cache.fake_cluster import FakeCluster
from volcano_tpu_torch.cache.kinds import KINDS

log = logging.getLogger(__name__)

EVENT_RING = 100_000     # events kept for watchers before forcing resync
AUDIT_RING = 200_000     # audit records kept for the latency exporter
TRACE_RING = 512         # kept scheduler session traces (GET /traces)


def _error_code(e: Exception) -> int:
    """Exception -> wire status, the same mapping do_POST applies to
    whole-request failures (reused for per-item /bind_batch verdicts):
    missing object 404, admission veto 422, conflict 409, read-only
    degrade 503, else 500."""
    from volcano_tpu_torch.server.durability import ReadOnlyError
    if isinstance(e, ReadOnlyError):
        return 503
    if isinstance(e, KeyError):
        return 404
    if isinstance(e, ValueError):
        from volcano_tpu_torch.webhooks.admission import AdmissionError
        return 422 if isinstance(e, AdmissionError) else 409
    return 500


# what a read-only (degraded) server still answers on POST: leases
# (leader election must keep working through a full disk — in-memory,
# journaling resumes at heal) and traces (never durable anyway).
# Everything else mutates the store and CANNOT be made durable, so it
# gets 503 + Retry-After instead of an un-durable ack.
READONLY_OK_POSTS = frozenset({"/lease", "/trace"})
RETRY_AFTER_S = 1


class Lease:
    # expires is a MONOTONIC-clock deadline: a wall-clock jump (NTP
    # step, VM resume) can neither mass-expire live leases nor
    # immortalize a dead holder's (found while making leases durable —
    # a wall deadline replayed after downtime did both).
    # term is the fencing token: a per-name counter that bumps on
    # every acquisition that is not a live same-holder renewal, so
    # two holders can never share a term and a deposed holder's
    # writes are refusable by comparison alone
    __slots__ = ("holder", "expires", "term")

    def __init__(self, holder: str, expires: float, term: int = 0):
        self.holder = holder
        self.expires = expires
        self.term = term


class StateServer:
    """Owns the authoritative store + event log + leases."""

    def __init__(self, cluster: Optional[FakeCluster] = None,
                 durable=None, replication=None):
        self.durable = durable                 # DurableStore or None
        self.repl = replication                # replication.Replication
        recovery = None
        if durable is not None:
            recovery = getattr(durable, "recovery", None)
            if recovery is None:
                recovery = durable.recover(event_ring=EVENT_RING)
            if recovery.cluster is not None:
                if cluster is not None and cluster is not recovery.cluster:
                    log.warning("durable state in %s takes precedence "
                                "over the seed cluster", durable.dir)
                cluster = recovery.cluster
        if cluster is None:
            from volcano_tpu_torch.webhooks import default_admission
            cluster = FakeCluster()
            cluster.admission = default_admission()
        if getattr(cluster, "admission", None) is None and \
                recovery is not None and cluster is recovery.cluster:
            # a WAL-recovered store has no admission chain attached
            # (chains hold process-local callables); default unless
            # the caller swaps in a RemoteAdmission afterwards
            from volcano_tpu_torch.webhooks import default_admission
            cluster.admission = default_admission()
        self.cluster = cluster
        # incarnation token: rv counters reset on restart, so clients
        # must detect a different server lifetime and re-list — an rv
        # ordering check alone misses a restarted server whose counter
        # has already passed the client's position.  Durable boots
        # keep the BASE and bump only the boot half ("BASE.BOOT"), so
        # mirrors know the rv history is WAL-continuous and may
        # delta-resync across the restart instead of re-listing.
        import uuid
        self.epoch = recovery.epoch if recovery is not None \
            else uuid.uuid4().hex[:12]
        self._lock = threading.Lock()          # event log + leases
        self._event_cv = threading.Condition(self._lock)
        self._events: collections.deque = collections.deque(maxlen=EVENT_RING)
        self._rv = 0
        self._leases: Dict[str, Lease] = {}
        # fencing substrate: per-name monotonic term counters (never
        # reissued, even after expiry/release — or a deposed holder
        # could reacquire "its" term) and per-name fence floors (the
        # highest term whose write this plane ever accepted; staler
        # writes 409).  Both are journaled and recovered.
        self._lease_terms: Dict[str, int] = {}
        self._fences: Dict[str, int] = {}
        # observability: per-fence-name count of refused stale writes
        self._fenced_counts: Dict[str, int] = {}
        # idempotency keys: req id -> (code, payload) of the response
        # already committed for that request — a client retrying a
        # mutation whose ack was lost in a crash/partition gets the
        # recorded verdict instead of double-applying
        self._req_cache: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        if recovery is not None:
            self._rv = recovery.rv
            self._events.extend(recovery.events)
            # vtplint: disable=wall-clock (disk carries wall expiries; rebased onto monotonic here)
            now_m, now_w = time.monotonic(), time.time()
            self._lease_terms.update(
                getattr(recovery, "lease_terms", None) or {})
            self._fences.update(getattr(recovery, "fences", None) or {})
            for name, (holder, exp_wall) in recovery.leases.items():
                # rebase the persisted wall expiry onto THIS boot's
                # monotonic clock: the remaining TTL is honoured, so a
                # restarted server refuses a second leader inside an
                # old holder's term.  A live lease's term is by
                # construction the max ever issued for its name.
                self._leases[name] = Lease(
                    holder, now_m + (exp_wall - now_w),
                    term=self._lease_terms.get(name, 0))
            self._req_cache.update(recovery.req_cache)
        # audit trail: wall-clock-stamped mutation records, the
        # apiserver-audit-log analogue the latency exporter scrapes
        # (reference third_party/kube-apiserver-audit-exporter derives
        # pods/binding latency from audit timestamps).  Lazily enabled
        # by the first GET /audit so deployments that never poll pay
        # nothing on the mutation hot path.
        self._audit: collections.deque = collections.deque(maxlen=AUDIT_RING)
        self._audit_idx = 0
        self._audit_enabled = False
        # chip-overcommit guard (found by tools/chaos_conductor.py:
        # under sustained ack-lost faults a scheduler whose bind acks
        # died un-assumes the gang, and its stale mirror re-allocates
        # chips the server already committed to another gang — the
        # trusted-scheduler design needs an apiserver-side backstop).
        # The maps are event-sourced: _on_store_event keeps them in
        # O(1) per pod/node event, so validation never scans the
        # store; _bind_mutex makes check-and-bind atomic across
        # concurrent handler threads.  The "chips" the maps count are
        # GPUs (nvidia.com/gpu); the names stay the reference's.
        self._bind_mutex = threading.Lock()
        self._pod_chips: Dict[str, tuple] = {}   # pod key -> (node, chips)
        self._chips_used: Dict[str, float] = {}  # node -> bound chips
        self._node_chip_cap: Dict[str, float] = {}
        self._rebuild_chip_maps()
        # scheduler session traces (trace.py docs): in-memory ring,
        # deliberately NOT journaled — across a crash it resets
        # cleanly with the new epoch (clients see the epoch change and
        # know history restarted) and the posting scheduler refills it
        # within a few cycles; a trace is accepted only whole, so the
        # ring never serves half a tree
        self._traces: collections.deque = collections.deque(
            maxlen=TRACE_RING)
        # lock-order audit opt-in: wrap the _lock-owned maps so any
        # mutation without the lock held is recorded (the guard is
        # installed AFTER init — the single-threaded construction
        # above is exempt by construction)
        import os
        if os.environ.get("VTP_LOCK_AUDIT"):
            from volcano_tpu_torch.analysis import lockaudit
            lockaudit.maybe_guard_server(self)
        cluster.watch(self._on_store_event)
        if self.repl is not None:
            if durable is None:
                raise ValueError("replication requires a durable "
                                 "store (--data-dir)")
            self.repl.attach(self)
        if durable is not None and recovery.cluster is None:
            # first boot of this data dir (possibly seeded from a
            # legacy --state file): the baseline must be durable
            # BEFORE the first ack, or a crash loses the seed
            self.write_snapshot()

    # -- event log -----------------------------------------------------

    def _rebuild_chip_maps(self) -> None:
        from volcano_tpu_torch.api.resource import GPU
        from volcano_tpu_torch.api.types import TaskStatus
        self._pod_chips.clear()
        self._chips_used.clear()
        self._node_chip_cap.clear()
        for name, node in self.cluster.nodes.items():
            cap = float((getattr(node, "allocatable", None) or {})
                        .get(GPU, 0) or 0)
            if cap > 0:
                self._node_chip_cap[name] = cap
        for key, pod in self.cluster.pods.items():
            if pod.node_name and pod.phase in (TaskStatus.BOUND,
                                               TaskStatus.RUNNING):
                chips = float(pod.resource_requests().get(GPU) or 0)
                if chips > 0:
                    self._pod_chips[key] = (pod.node_name, chips)
                    self._chips_used[pod.node_name] = \
                        self._chips_used.get(pod.node_name, 0.0) + chips

    def _track_chips(self, kind: str, obj) -> None:
        """O(1) per-event maintenance of the overcommit-guard maps
        (caller holds the event lock)."""
        from volcano_tpu_torch.api.resource import GPU
        from volcano_tpu_torch.api.types import TaskStatus
        if kind == "node":
            cap = float((getattr(obj, "allocatable", None) or {})
                        .get(GPU, 0) or 0)
            if cap > 0:
                self._node_chip_cap[obj.name] = cap
            else:
                self._node_chip_cap.pop(obj.name, None)
            return
        if kind == "node_deleted":
            self._node_chip_cap.pop(obj.name, None)
            return
        if kind not in ("pod", "pod_deleted"):
            # a podgroup/vcjob shares the ns/name key space: letting
            # its events touch the pod map would silently disarm the
            # guard on a key collision
            return
        key = getattr(obj, "key", None)
        if key is None:
            return
        old = self._pod_chips.pop(key, None)
        if old is not None:
            node, chips = old
            left = self._chips_used.get(node, 0.0) - chips
            if left > 1e-9:
                self._chips_used[node] = left
            else:
                self._chips_used.pop(node, None)
        if kind == "pod" and obj.node_name and \
                obj.phase in (TaskStatus.BOUND, TaskStatus.RUNNING):
            chips = float(obj.resource_requests().get(GPU) or 0)
            if chips > 0:
                self._pod_chips[key] = (obj.node_name, chips)
                self._chips_used[obj.node_name] = \
                    self._chips_used.get(obj.node_name, 0.0) + chips

    def check_bind_capacity(self, namespace: str, name: str,
                            node_name: str) -> Optional[str]:
        """The apiserver-side overcommit backstop: would binding this
        pod exceed the node's nvidia.com/gpu allocatable?  Returns the refusal
        message, or None when the bind is safe (re-binding a pod to
        the node it already occupies stays idempotent).  Callers hold
        _bind_mutex so check-and-bind is atomic."""
        from volcano_tpu_torch.api.resource import GPU
        key = f"{namespace}/{name}"
        pod = self.cluster.pods.get(key)
        if pod is None:
            return None           # bind_pod will 404 with the details
        chips = float(pod.resource_requests().get(GPU) or 0)
        if chips <= 0:
            return None           # GPU-less pods are not guarded
        return self._check_chip_capacity(
            key, node_name, chips, verb="bind",
            hint="stale scheduler view?")

    def _check_chip_capacity(self, key: str, node: str, chips: float,
                             verb: str, hint: str) -> Optional[str]:
        """The one chip-accounting core both guards share (/bind and
        the pod-PUT route must never diverge on the rule): replacing
        a pod's own booking on the same node is idempotent, anything
        else must fit under the node's allocatable.  Callers hold
        _bind_mutex; the map reads take _lock here."""
        with self._lock:
            cap = self._node_chip_cap.get(node)
            if cap is None:
                return None       # no GPUs on the node to guard
            used = self._chips_used.get(node, 0.0)
            prev = self._pod_chips.get(key)
            if prev is not None and prev[0] == node:
                used -= prev[1]   # replacing its own booking
            if used + chips > cap + 1e-9:
                return (f"{verb} overcommit: node {node} has "
                        f"{used:g}/{cap:g} GPUs bound; refusing "
                        f"+{chips:g} for {key} ({hint})")
        return None

    def check_put_capacity(self, obj) -> Optional[str]:
        """The overcommit backstop for WHOLE-POD writes: /bind and
        /bind_batch are capacity-guarded, but a pod object PUT via
        /objects/pod carrying node_name + Bound/Running used to land
        unchecked — so a stale mirror's delayed or reordered pod
        write could resurrect a drained pod onto chips the server
        had already re-bound (observed as a confirmed double-booking
        under the chaos conductor's reorder/duplicate faults with
        lock-audit timing).  Same shape as check_bind_capacity, but
        against the INCOMING object; replacing a pod's own booking on
        the same node stays idempotent.  Callers hold _bind_mutex."""
        from volcano_tpu_torch.api.resource import GPU
        from volcano_tpu_torch.api.types import TaskStatus
        node = getattr(obj, "node_name", None)
        if not node or getattr(obj, "phase", None) not in (
                TaskStatus.BOUND, TaskStatus.RUNNING):
            return None
        chips = float(obj.resource_requests().get(GPU) or 0)
        if chips <= 0:
            return None
        return self._check_chip_capacity(
            obj.key, node, chips, verb="put",
            hint=f"written as {obj.phase.value}; stale mirror write?")

    def _on_store_event(self, kind: str, obj) -> None:
        try:
            payload = codec.encode(obj)
        except TypeError:
            log.exception("unencodable %s event dropped", kind)
            return
        with self._event_cv:
            self._track_chips(kind, obj)
            self._rv += 1
            self._events.append((self._rv, kind, payload))
            if self.durable is not None:
                # journal under the same lock that assigned the rv so
                # WAL order == rv order; fsync happens in commit(),
                # on the ack path
                self.durable.append_event(self._rv, kind, payload)
            if self._audit_enabled:
                self._audit_idx += 1
                self._audit.append(self._audit_record(
                    self._audit_idx, kind, obj))
            self._event_cv.notify_all()

    # -- durability ----------------------------------------------------

    def _visible_rv(self) -> int:
        """Events are released to watchers/snapshots only once their
        WAL records are fsync'd: a mirror can then never hold an event
        a crash un-happens, which is what makes a delta resync across
        a restart exact (docs/design/durability.md).  Leading a
        replica group tightens the gate to the QUORUM horizon: an
        event only a doomed leader holds must never reach a mirror,
        or a promotion would un-happen state a mirror already saw."""
        if self.durable is None:
            return self._rv
        vis = min(self._rv, self.durable.synced_rv)
        if self.repl is not None and self.repl.is_leader:
            vis = min(vis, self.repl.quorum_rv())
        return vis

    def commit(self) -> None:
        """Durability barrier before an ack: fsync everything appended
        so far (group commit — one fsync covers concurrent handlers),
        then wake watchers gated on the synced horizon.  Leading a
        replica group, the barrier extends to the commit quorum: the
        ack waits until a majority holds the records durably — the
        wait doubling as the fence that stops a partitioned leader
        acking writes a promotion would lose.

        Raises durability.ReadOnlyError when the store is poisoned
        (failed fsync / full disk) or the replication quorum is lost:
        the caller must 503 instead of acking state that cannot be
        made durable."""
        if self.durable is None:
            return
        self.durable.commit()
        if self.repl is not None:
            self.repl.notify_durable()      # wake /wal long-polls
            self.repl.wait_quorum()         # leader only; may raise
        with self._event_cv:
            self._event_cv.notify_all()

    @property
    def readonly_reason(self) -> str:
        """Non-empty while the store is degraded to read-only."""
        if self.durable is None:
            return ""
        return self.durable.poisoned

    def try_heal(self) -> bool:
        """One heal attempt (fresh WAL segment + probe fsync + full
        snapshot); wakes watchers on success — the durable horizon
        jumped, releasing events stuck behind the poisoned WAL."""
        if self.durable is None or not self.durable.poisoned:
            return True
        if not self.durable.heal(self.disk_snapshot_doc):
            return False
        with self._event_cv:
            self._event_cv.notify_all()
        return True

    def disk_snapshot_doc(self) -> dict:
        """The on-disk snapshot: /snapshot payload + leases (wall-
        rebased) + the idempotency-key cache, so compaction of the WAL
        never drops what only the WAL knew."""
        doc = self.snapshot_payload()
        # vtplint: disable=wall-clock (the snapshot persists wall expiries by contract; monotonic deadlines rebased here)
        now_m, now_w = time.monotonic(), time.time()
        with self._lock:
            doc["leases"] = {
                n: {"holder": l.holder,
                    "expires_wall": now_w + (l.expires - now_m),
                    "term": l.term}
                for n, l in self._leases.items() if l.expires > now_m}
            # term counters + fence floors survive compaction even for
            # names with no live lease — monotonicity is the contract
            doc["lease_terms"] = dict(self._lease_terms)
            doc["fences"] = dict(self._fences)
            doc["req_cache"] = [
                {"id": i, "code": c, "resp": r}
                for i, (c, r) in self._req_cache.items()]
        return doc

    def write_snapshot(self) -> None:
        if self.durable is not None:
            self.durable.snapshot(self.disk_snapshot_doc)

    def replay_response(self, req_id: str):
        with self._lock:
            hit = self._req_cache.get(req_id)
            if hit is not None:
                self._req_cache.move_to_end(req_id)
            return hit

    def record_response(self, req_id: str, code: int, payload) -> None:
        from volcano_tpu_torch.server.durability import REQ_CACHE
        with self._lock:
            self._req_cache[req_id] = (code, payload)
            while len(self._req_cache) > REQ_CACHE:
                self._req_cache.popitem(last=False)
        if self.durable is not None:
            # vtplint: disable=append-lock (_req records are keyed by unique id and replay idempotently: journal order does not matter, so the append deliberately runs outside _lock)
            self.durable.append({"k": "_req", "o": {
                "id": req_id, "code": code, "resp": payload}})

    def durability_status(self) -> dict:
        out = {"enabled": self.durable is not None,
               "epoch": self.epoch, "rv": self._rv,
               "visible_rv": self._visible_rv()}
        if self.durable is not None:
            out.update(self.durable.status())
        if self.repl is not None:
            out["replication"] = self.repl.status()
        return out

    # -- replication (server/replication.py) ---------------------------

    def replica_snapshot_doc(self) -> dict:
        """The follower-bootstrap payload: the full disk snapshot doc
        (stores + leases + req cache) plus the WAL seq horizon, term
        and epoch the tail resumes from.  The seq is read BEFORE the
        capture, so records appended during the capture overlap the
        doc — the follower skips store events at rv <= the doc's rv
        (the same rotated-then-snapshotted rule recovery applies) and
        the private record kinds replay idempotently.

        Only LOCAL durability is required here — never the commit
        quorum: a joining follower calls this to BECOME part of that
        quorum (waiting for it would deadlock the join)."""
        self.durable.commit()
        if self.repl is not None:
            self.repl.notify_durable()
        seq0 = self.durable.synced_seq
        doc = self.disk_snapshot_doc()
        doc["wal_seq"] = seq0
        doc["epoch"] = self.epoch
        if self.repl is not None:
            doc["term"] = self.repl.term
        return doc

    def install_replica_snapshot(self, doc: dict) -> None:
        """Follower full re-sync: replace store, event ring, leases,
        req cache and the local WAL wholesale with the leader's
        replica snapshot (reset_from_snapshot discards the local
        segments — the leader's history supersedes them)."""
        from volcano_tpu_torch.server.durability import decode_stores_into
        from volcano_tpu_torch.webhooks import default_admission
        epoch = doc.get("epoch") or self.epoch
        cluster = FakeCluster()
        decode_stores_into(cluster, doc.get("stores", {}))
        # keep THIS replica's configured admission (e.g. a
        # --webhook-url RemoteAdmission): a bootstrap replaces the
        # data, never the policy chain a promotion will enforce
        cluster.admission = getattr(self.cluster, "admission", None) \
            or default_admission()
        # vtplint: disable=wall-clock (bootstrap doc carries wall expiries; rebased onto monotonic here)
        now_m, now_w = time.monotonic(), time.time()
        # lock hierarchy: the compaction gate (_snap_lock) is the
        # OUTERMOST lock — snapshot()/heal() hold it while capturing
        # under the server lock, so taking it the other way around
        # here deadlocked a follower's tail thread against its own
        # wal-compactor (found by analysis/lockaudit.py; the gate is
        # acquired before the event lock precisely for this)
        with self.durable.snapshot_gate():
            with self._event_cv:
                self.durable.reset_from_snapshot(doc, epoch)
                cluster.watch(self._on_store_event)
                self.cluster = cluster
                self.epoch = epoch
                self._rv = int(doc.get("rv", 0))
                self._events.clear()
                self._leases.clear()
                self._lease_terms = {
                    n: int(t) for n, t in
                    (doc.get("lease_terms") or {}).items()}
                self._fences = {
                    n: int(t) for n, t in
                    (doc.get("fences") or {}).items()}
                for name, rec in (doc.get("leases") or {}).items():
                    exp_wall = float(rec["expires_wall"])
                    term = int(rec.get("term", 0))
                    self._lease_terms[name] = max(
                        self._lease_terms.get(name, 0), term)
                    if exp_wall > now_w:
                        self._leases[name] = Lease(
                            rec["holder"], now_m + (exp_wall - now_w),
                            term=term)
                self._req_cache.clear()
                for rec in (doc.get("req_cache") or []):
                    self._req_cache[rec["id"]] = (int(rec["code"]),
                                                  rec["resp"])
                self._rebuild_chip_maps()
                self._event_cv.notify_all()

    def mirror_ship(self, since_seq: int, timeout: float) -> dict:
        """The `/wal?mirror=1` lane: framed WAL records for a
        cross-region OBJECT MIRROR (federation/mirror.py).  Same frame
        + CRC + seq stream the replica tail consumes, with two
        deliberate differences from Replication.ship():

          * NON-QUORUM — the caller is never registered as a follower
            and its ack never counts toward the commit quorum: a
            mirror is a read cache at advertised staleness, and a
            distant region tailing the WAL must not be able to slow
            (or wedge) the source region's write acks.
          * DURABLE-ONLY — works on any durable server, replicated or
            not (a single-server lab region can be mirrored).

        Leading a replica group, shipped records are CAPPED at the
        quorum horizon: a mirror must never hold a record a leader
        failover could un-happen (the same gate _visible_rv applies
        to watchers).  On a follower the local synced prefix is
        served as-is — the mirror's contract is staleness, not
        quorum, and cutover correctness gates on the GLOBAL store."""
        from volcano_tpu_torch.server.replication import SHIP_BATCH
        deadline = time.monotonic() + max(0.0, min(timeout, 30.0))
        while True:
            out = self.durable.ship_since(since_seq, limit=SHIP_BATCH)
            if self.repl is not None and self.repl.is_leader:
                q = self.repl.quorum_seq()
                if q < out["last_seq"]:
                    keep = max(0, q - since_seq)
                    out = {"records": out["records"][:keep],
                           "last_seq": max(since_seq, q),
                           "resync": out["resync"]}
            if out["records"] or out["resync"] or \
                    time.monotonic() >= deadline:
                break
            with self._event_cv:
                self._event_cv.wait(
                    min(0.5, max(0.01,
                                 deadline - time.monotonic())))
        return {"epoch": self.epoch, "rv": self._visible_rv(),
                "snapshot_rv": self.durable.snapshot_rv,
                "last_seq": out["last_seq"],
                "resync": out["resync"], "records": out["records"]}

    def apply_shipped(self, lines) -> None:
        """Fold one shipped batch into this follower: verify EVERY
        record's CRC + sequence first (a corrupt or torn shipped
        record refuses the whole batch — never a partial apply), then
        journal the leader-framed lines verbatim, apply them to the
        store/leases/req-cache, and fsync before the new rv becomes
        visible — the bounded-staleness contract: a follower never
        serves an rv it has not durably applied."""
        from volcano_tpu_torch.server.durability import (apply_event_obj,
                                                   parse_record)
        from volcano_tpu_torch.server.replication import \
            ShippedCorruptionError
        parsed = []
        seq = self.durable.synced_seq
        for line in lines:
            rec, bad = parse_record(line.rstrip("\n"))
            if rec is None:
                raise ShippedCorruptionError(
                    f"record after seq {seq}: {bad}")
            q = int(rec.get("q", 0))
            if q <= seq:
                continue                    # overlap re-ship: skip
            if q != seq + 1:
                raise ShippedCorruptionError(
                    f"sequence gap {seq}->{q}")
            seq = q
            parsed.append((line, q, rec))
        if not parsed:
            return
        with self._event_cv:
            snap_rv = self.durable.snapshot_rv
            for line, q, rec in parsed:
                kind = rec.get("k")
                erv = int(rec.get("rv", 0))
                self.durable.append_shipped(line, q, erv)
                if kind == "_probe":
                    continue
                if kind == "_lease":
                    o = rec["o"]
                    if o.get("term"):
                        self._lease_terms[o["name"]] = max(
                            self._lease_terms.get(o["name"], 0),
                            int(o["term"]))
                    if o.get("holder"):
                        # vtplint: disable=wall-clock (shipped record carries a wall expiry; rebased onto monotonic here)
                        self._leases[o["name"]] = Lease(
                            o["holder"], time.monotonic() +
                            # vtplint: disable=wall-clock (shipped wall expiry rebased)
                            (float(o["expires_wall"]) - time.time()),
                            term=int(o.get("term", 0)))
                    else:
                        self._leases.pop(o["name"], None)
                elif kind == "_fence":
                    o = rec["o"]
                    self._fences[o["name"]] = max(
                        self._fences.get(o["name"], 0),
                        int(o.get("term", 0)))
                elif kind == "_req":
                    o = rec["o"]
                    self._req_cache[o["id"]] = (int(o["code"]),
                                                o["resp"])
                    from volcano_tpu_torch.server.durability import REQ_CACHE
                    while len(self._req_cache) > REQ_CACHE:
                        self._req_cache.popitem(last=False)
                elif kind == "_drain":
                    drained = set(rec["o"].get("cids") or [])
                    if drained:
                        self.cluster.commands = [
                            c for c in self.cluster.commands
                            if not (isinstance(c, dict)
                                    and c.get("cid") in drained)]
                else:
                    if erv <= snap_rv:
                        continue    # already in the bootstrap snapshot
                    obj = codec.decode(rec["o"])
                    apply_event_obj(self.cluster, kind, obj)
                    self._track_chips(kind, obj)
                    self._rv = max(self._rv, erv)
                    self._events.append((erv, kind, rec["o"]))
        # durability BEFORE visibility: the fsync advances synced_rv,
        # which is what _visible_rv releases to this replica's readers
        self.durable.commit()
        with self._event_cv:
            self._event_cv.notify_all()

    def on_promote(self) -> None:
        """Follower -> leader: bump the BOOT half of the epoch (same
        BASE: the rv history is WAL-continuous, mirrors delta-resync
        across the promotion) and wake everything gated on roles."""
        new_epoch = self.durable._bump_epoch(continuous=True)
        with self._event_cv:
            self.epoch = new_epoch
            self._event_cv.notify_all()

    @staticmethod
    def _audit_record(idx: int, kind: str, obj) -> dict:
        # vtplint: disable=wall-clock (audit stamps are operator-facing wall time, never deadlines)
        rec = {"i": idx, "ts": time.time(), "kind": kind,
               "key": getattr(obj, "key", None) or
               (obj.get("key") if isinstance(obj, dict) else None)}
        # the two signals the latency exporter needs: pod binding
        # (node set) and job completion (phase terminal)
        node = getattr(obj, "node_name", None)
        if node is not None:
            rec["node"] = node
        phase = getattr(obj, "phase", None)
        if phase is not None:
            rec["phase"] = getattr(phase, "value", str(phase))
        return rec

    def audit_since(self, since: int, limit: int = 10_000,
                    key: str = "") -> Tuple[int, List[dict], bool]:
        """(idx, records with index > since, lost) — no long-poll, the
        exporter pages with `since` until a short batch comes back.
        The first call enables collection.  lost is True when the
        client's position fell off the ring (records were evicted
        unseen) — like events_since's resync signal.  limit bounds the
        copy made under the store lock so a lagging exporter can't
        stall mutations for a 200k-record copy."""
        with self._event_cv:
            self._audit_enabled = True
            if since > self._audit_idx:
                # client ahead of the server: the audit index restarted
                # (the trail is in-memory; a crash resets it) — signal
                # lost so the exporter re-anchors instead of paging
                # into a void forever
                return self._audit_idx, [], True
            if not self._audit:
                return self._audit_idx, [], False
            first = self._audit[0]["i"]
            lost = since < first - 1
            start = max(0, since - first + 1)
            records = list(itertools.islice(
                self._audit, start, start + max(1, limit)))
            idx = records[-1]["i"] if records else self._audit_idx
            if key:
                # server-side object filter (pod describe): paging
                # indices stay ring-global, only matching records ship
                records = [r for r in records if r.get("key") == key]
            return idx, records, lost

    def add_trace(self, doc: dict) -> None:
        from volcano_tpu_torch import trace as trace_mod
        # the never-serve-half-a-tree gate on POST /trace (shared
        # definition: trace.is_complete_span)
        if not isinstance(doc, dict) or \
                not trace_mod.is_complete_span(doc.get("root")):
            raise ValueError("trace rejected: incomplete span tree")
        with self._lock:
            self._traces.append(dict(doc, epoch=self.epoch))

    def traces(self, job: str = "", limit: int = 0,
               episode: str = "") -> List[dict]:
        from volcano_tpu_torch import trace as trace_mod
        with self._lock:
            out = list(self._traces)
        if job:
            out = [t for t in out if trace_mod.matches_job(t, job)]
        if episode:
            out = [t for t in out
                   if trace_mod.matches_episode(t, episode)]
        if limit:
            out = out[-limit:]
        return out

    def events_since(self, since: int, timeout: float = 25.0):
        """(rv, events, resync) — blocks up to timeout for news.

        Only DURABLE events are released (_visible_rv): an event whose
        WAL record is not yet fsync'd stays invisible, so no mirror
        can ever hold state a crash would un-happen.  commit() wakes
        the waiters once the horizon advances."""
        deadline = time.monotonic() + timeout
        with self._event_cv:
            while True:
                if since > self._rv:
                    # the client is AHEAD of us: its revision came
                    # from another incarnation (a restart that did
                    # not keep this history) — tell it to resync NOW
                    # instead of letting the long-poll run out first
                    return self._visible_rv(), [], True
                if self._events and self._events[0][0] > since + 1:
                    # client fell off the ring: it must re-list
                    return self._visible_rv(), [], True
                vis = self._visible_rv()
                if vis > since and self._events:
                    # rvs are contiguous: the suffix starts at a known
                    # offset — never scan the whole (up to 100k) ring
                    start = since - self._events[0][0] + 1
                    news = [e for e in itertools.islice(
                        self._events, max(0, start), None)
                        if e[0] <= vis]
                    if news:
                        return vis, news, False
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return vis, [], False
                self._event_cv.wait(remain)

    def snapshot_payload(self) -> dict:
        """Full store dump + current rv (client list+watch bootstrap).
        The /snapshot route commits BEFORE serving this, so the state
        a mirror bootstraps from is always durable."""
        with self._event_cv:
            rv = self._rv
            stores = {}
            with self.cluster._lock:
                for kind, spec in KINDS.items():
                    store = getattr(self.cluster, spec.attr, {})
                    stores[kind] = {k: codec.encode(v)
                                    for k, v in store.items()}
                stores["_commands"] = codec.encode(
                    list(self.cluster.commands))
        return {"rv": rv, "stores": stores, "epoch": self.epoch}

    # -- leases (leader election) --------------------------------------

    def _wal_lease(self, name: str, holder: str,
                   expires_wall: float, term: int = 0) -> None:
        """Journal a lease transition (holder "" = release).  Wall
        expiry on the wire/disk, rebased to the monotonic clock at
        boot: a restarted server honours the remaining TTL and cannot
        elect a second leader inside an old holder's term.  The term
        rides in the record so a replay/ship never regresses the
        per-name counter."""
        if self.durable is not None:
            # vtplint: disable=append-lock (every caller holds _lock — lease() acquires it around the CAS; the lexical rule cannot see through the call)
            self.durable.append({"k": "_lease", "o": {
                "name": name, "holder": holder,
                "expires_wall": expires_wall, "term": term}})

    def lease(self, name: str, holder: str, ttl: float,
              release: bool = False) -> dict:
        now = time.monotonic()
        with self._lock:
            cur = self._leases.get(name)
            if release:
                if cur and cur.holder == holder:
                    del self._leases[name]
                    self._wal_lease(name, "", 0.0,
                                    self._lease_terms.get(name, 0))
                return {"acquired": False, "holder": "", "expires": 0,
                        "expires_in": 0,
                        "term": self._lease_terms.get(name, 0)}
            if cur is None or cur.expires < now or cur.holder == holder:
                if cur is not None and cur.holder == holder and \
                        cur.expires >= now:
                    # live same-holder renewal: the term is unchanged —
                    # a fencing token names one continuous tenancy
                    term = cur.term or self._lease_terms.get(name, 0)
                else:
                    # fresh acquisition (new holder, or the same holder
                    # returning after an expiry during which another
                    # writer could have been elected): mint a new term
                    term = self._lease_terms.get(name, 0) + 1
                    self._lease_terms[name] = term
                self._leases[name] = Lease(holder, now + ttl, term)
                # vtplint: disable=wall-clock (the wire/journal carry wall expiries by contract; the live deadline above is monotonic)
                self._wal_lease(name, holder, time.time() + ttl, term)
                # vtplint: disable=wall-clock (wire expiry; expires_in is the authoritative TTL)
                return {"acquired": True, "holder": holder,
                        # vtplint: disable=wall-clock (wire expiry by contract)
                        "expires": time.time() + ttl,
                        "expires_in": round(ttl, 3), "term": term}
            # vtplint: disable=wall-clock (wire expiry; expires_in is the authoritative TTL)
            return {"acquired": False, "holder": cur.holder,
                    # vtplint: disable=wall-clock (wire expiry by contract)
                    "expires": time.time() + (cur.expires - now),
                    "expires_in": round(cur.expires - now, 3),
                    "term": cur.term}

    # -- fencing tokens (deposed-writer refusal) -----------------------

    def advance_fence(self, name: str, term: int) -> dict:
        """Raise the fence floor for *name* to *term* (monotonic: a
        lower ask is a no-op, never a regression).  A freshly promoted
        leaseholder advances the fence on every plane it writes to
        BEFORE its first mutation, so the deposed holder's in-flight
        writes are already refusable when they land."""
        term = int(term)
        with self._lock:
            cur = self._fences.get(name, 0)
            if term > cur:
                self._fences[name] = cur = term
                if self.durable is not None:
                    # vtplint: disable=append-lock (held: this branch runs under self._lock)
                    self.durable.append({"k": "_fence", "o": {
                        "name": name, "term": term}})
            return {"name": name, "term": cur,
                    "refused": self._fenced_counts.get(name, 0)}

    def check_fence(self, name: str, term: int) -> None:
        """Refuse a write fenced below the floor (raises ValueError ->
        409).  A HIGHER term self-advances the floor: the first write
        of a new tenancy proves the old one dead even if the explicit
        advance_fence never arrived."""
        term = int(term)
        with self._lock:
            cur = self._fences.get(name, 0)
            if term < cur:
                self._fenced_counts[name] = \
                    self._fenced_counts.get(name, 0) + 1
                count = self._fenced_counts[name]
            elif term > cur:
                self._fences[name] = term
                if self.durable is not None:
                    # vtplint: disable=append-lock (held: this branch runs under self._lock)
                    self.durable.append({"k": "_fence", "o": {
                        "name": name, "term": term}})
                return
            else:
                return
        from volcano_tpu_torch import metrics
        metrics.inc("fenced_writes_total", fence=name)
        log.warning("fenced write refused: %s term %d < floor %d "
                    "(%d refused so far)", name, term, cur, count)
        raise ValueError(
            f"fenced: {name} term {term} is stale (current fence "
            f"{cur}); a newer holder owns this tenancy")

    def fence_status(self) -> dict:
        with self._lock:
            return {name: {"term": t,
                           "refused": self._fenced_counts.get(name, 0)}
                    for name, t in sorted(self._fences.items())}


class _Handler(BaseHTTPRequestHandler):
    server_version = "volcano-tpu-state"
    protocol_version = "HTTP/1.1"
    state: StateServer = None          # injected by serve()
    token: str = ""                    # bearer token, all data routes
    faults = None                      # faults.FaultPlan or None

    # quiet the default stderr access log
    def log_message(self, fmt, *args):  # noqa: N802
        log.debug("http: " + fmt, *args)

    # -- fault injection (volcano_tpu_torch/faults.py, site="server") -------

    def _wire_fault(self, allowed=None):
        """Consult the fault plan once per request.  Pre-response
        kinds are applied HERE (delay/reorder park, 503, reset,
        drop_request); kinds that act at response time (duplicate,
        drop_response, trickle) return the rule for the route methods
        to honour.  allowed narrows to the kinds THIS method can
        express (GET cannot meaningfully duplicate) so a rule's
        injection budget is never burned on a request that can't
        apply it — the fault_injected_total counts stay honest."""
        plan = self.faults
        if plan is None:
            return None
        rule = plan.decide("server", urlparse(self.path).path,
                           kinds=allowed)
        if rule is None:
            return None
        kind = rule.kind
        if kind == "delay":
            time.sleep((rule.ms or 50.0) / 1000.0)
            return None
        if kind == "reorder":
            plan.reorder_park((rule.ms or 150.0) / 1000.0)
            return None
        if kind == "http_503":
            self._json(503, {"error": "injected fault: 503"},
                       headers={"Retry-After": RETRY_AFTER_S})
            return "handled"
        if kind in ("reset", "drop_request"):
            if kind == "drop_request":
                # drain the body first: the request is READ then
                # dropped on the floor (never processed) — distinct
                # from reset, which cuts the connection mid-send
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
            else:
                try:
                    import socket as _socket
                    import struct
                    # RST instead of FIN on close
                    self.connection.setsockopt(
                        _socket.SOL_SOCKET, _socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
                except OSError:
                    # vtplint: disable=except-pass (best-effort RST styling on an injected reset; the close itself still happens)
                    pass
            self.close_connection = True
            return "handled"
        return rule        # drop_response / duplicate / trickle

    def _readonly_503(self, reason: str):
        return self._json(503, {
            "error": f"store is read-only ({reason}); the server "
                     "degrades instead of acking un-durable state",
            "readonly": True},
            headers={"Retry-After": RETRY_AFTER_S})

    def _follower_503(self, unproven: bool = False):
        """A mutation hit a replica whose write path is dead — or a
        READ hit a replica that has not yet re-proven continuity with
        the group (a rebooting deposed leader must not serve its
        possibly-diverged local tail) — the read-only degrade shape
        (503 + Retry-After) with the leader hint the client
        re-routes on."""
        repl = self.state.repl
        what = ("has not re-synced with the group yet; reads come "
                "back after its bootstrap" if unproven else
                "refuses writes; they go to the leader")
        return self._json(503, {
            "error": f"replica {repl.replica_id} "
                     f"({repl.role}, term {repl.term}) {what}",
            "readonly": True, "follower": True,
            "leader": repl.leader_hint()},
            headers={"Retry-After": RETRY_AFTER_S})

    def _authorized(self) -> bool:
        """Every data route — reads included — requires the cluster
        bearer token when one is configured (VERDICT r4 weak #4: an
        open LIST/WATCH hands any peer the whole cluster state).
        Only /healthz (liveness probes can't carry credentials) and
        /metrics (Prometheus scrape; the generated scrape config
        carries the token, but an operator pointing a stock scraper
        at it must not lose telemetry) stay anonymous."""
        from volcano_tpu_torch.server.tlsutil import token_ok
        if token_ok(self.token, self.headers.get("Authorization")):
            return True
        self._json(401, {"error": "missing or invalid bearer token"})
        return False

    def _json(self, code: int, payload, headers=None,
              trickle_ms: float = 0.0) -> None:
        from volcano_tpu_torch.server.httputil import json_response
        json_response(self, code, payload, headers=headers,
                      trickle_ms=trickle_ms)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    # -- GET -----------------------------------------------------------

    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        st = self.state
        if url.path == "/healthz":
            return self._json(200, {"ok": True})
        if url.path == "/metrics":
            from volcano_tpu_torch import metrics
            return metrics.write_exposition(self)
        fault = self._wire_fault(allowed=(
            "drop_request", "drop_response", "delay", "reorder",
            "http_503", "reset", "trickle"))
        if fault == "handled":
            return None
        if fault is not None and fault.kind == "drop_response":
            # a read has no side effects to commit: its lost response
            # is indistinguishable from a dropped request — cut now
            self.close_connection = True
            return None
        trickle = fault.ms or 20.0 if fault is not None \
            and fault.kind == "trickle" else 0.0
        if not self._authorized():
            return None
        if st.repl is not None and not st.repl.proven and \
                url.path not in ("/replication", "/faults"):
            # an unproven follower (rebooting deposed leader, pending
            # bootstrap) serves NO store reads: its local tail may
            # hold records the group's quorum never acked, which the
            # imminent re-sync will discard — state a mirror must
            # never have seen
            return self._follower_503(unproven=True)
        if url.path == "/snapshot":
            from volcano_tpu_torch.server.durability import ReadOnlyError
            if st.readonly_reason:
                # the full dump would embed events the poisoned WAL
                # never made durable — a mirror bootstrapping from it
                # would hold state a crash un-happens.  Watch/delta
                # reads stay up (they gate on the synced horizon);
                # LISTs wait out the degrade.
                return self._readonly_503(st.readonly_reason)
            payload = st.snapshot_payload()
            # fsync-before-serve: the captured state embeds events up
            # to payload["rv"]; committing them first means no mirror
            # ever bootstraps from state a crash could un-happen
            try:
                st.commit()
            except ReadOnlyError as e:
                return self._readonly_503(e.reason)
            return self._json(200, payload, trickle_ms=trickle)
        if url.path == "/faults":
            # the chaos engine's own observability: which rules have
            # fired how often, and the seed that replays the run
            if self.faults is None:
                return self._json(200, {"active": False})
            return self._json(200, {
                "active": True, "seed": self.faults.seed,
                "rules": self.faults.status()})
        if url.path == "/durability":
            return self._json(200, st.durability_status())
        if url.path == "/replication":
            if st.repl is None:
                return self._json(200, {"enabled": False})
            return self._json(200, dict(st.repl.status(),
                                        enabled=True,
                                        epoch=st.epoch))
        if url.path == "/wal":
            # WAL shipping lane: framed records past the caller's seq,
            # long-polled.  Two classes of tail share the route:
            # replica followers (the request doubles as the follower's
            # durability ack — applied_seq/applied_rv feed the commit
            # quorum) and, with ?mirror=1, federation object mirrors
            # (non-quorum, durable-only; see StateServer.mirror_ship)
            q = parse_qs(url.query)

            def qi(name, default=0):
                try:
                    return int(q.get(name, [default])[0])
                except (TypeError, ValueError):
                    return default
            try:
                timeout = min(float(q.get("timeout", ["5"])[0]), 30.0)
            except (TypeError, ValueError):
                timeout = 5.0
            if q.get("mirror", ["0"])[0] in ("1", "true"):
                if st.durable is None:
                    return self._json(404, {"error": "not durable"})
                resp = st.mirror_ship(since_seq=qi("since_seq"),
                                      timeout=timeout)
            elif st.repl is None:
                return self._json(404, {"error": "not replicated"})
            else:
                resp = st.repl.ship(
                    since_seq=qi("since_seq"),
                    follower=q.get("follower", ["?"])[0],
                    applied_seq=qi("applied_seq"),
                    applied_rv=qi("applied_rv"),
                    term=qi("term"),
                    timeout=timeout)
            if self.faults is not None and resp.get("records"):
                rule = self.faults.decide("server", "/wal",
                                          kinds=("corrupt_ship",))
                if rule is not None:
                    # shipped-segment corruption: flip a byte INSIDE
                    # one framed record (the JSON envelope stays
                    # valid; only the follower's per-record CRC can
                    # tell) — the follower must refuse, never apply
                    recs = list(resp["records"])
                    mid = recs[len(recs) // 2]
                    pos = min(len(mid) - 2, max(12, len(mid) // 2))
                    flipped = chr(ord(mid[pos]) ^ 0x08)
                    recs[len(recs) // 2] = (mid[:pos] + flipped +
                                            mid[pos + 1:])
                    resp = dict(resp, records=recs)
            return self._json(200, resp, trickle_ms=trickle)
        if url.path == "/replica_snapshot":
            # follower bootstrap: the FULL disk doc (stores + leases +
            # req cache) plus seq/term/epoch.  Leader-only — a
            # follower's own horizon could be stale — and refused
            # while read-only, like /snapshot.
            from volcano_tpu_torch.server.durability import ReadOnlyError
            if st.durable is None:
                return self._json(404, {"error": "not durable"})
            if st.repl is not None and not st.repl.is_leader:
                return self._follower_503()
            if st.readonly_reason:
                return self._readonly_503(st.readonly_reason)
            try:
                doc = st.replica_snapshot_doc()
            except ReadOnlyError as e:
                return self._readonly_503(e.reason)
            return self._json(200, doc, trickle_ms=trickle)
        if url.path == "/leases":
            now = time.monotonic()
            with st._lock:
                return self._json(200, {
                    name: {"holder": l.holder,
                           "expires_in": round(l.expires - now, 3),
                           "term": l.term}
                    for name, l in st._leases.items()})
        if url.path == "/fences":
            # fence floors + refused-write counts (vtpctl routers /
            # the chaos conductor's stale-fence invariant read this)
            return self._json(200, st.fence_status())
        if url.path == "/watch":
            # timeout=0 doubles as the DELTA RESYNC lane: the events
            # since a revision, returned immediately — a mirror whose
            # rv is still inside the event ring catches up in O(churn)
            # instead of re-LISTing; resync=true means the revision
            # fell off the compaction horizon (the ring) and only a
            # full /snapshot recovers
            q = parse_qs(url.query)
            since = int(q.get("since", ["0"])[0])
            timeout = min(float(q.get("timeout", ["25"])[0]), 55.0)
            rv, events, resync = st.events_since(since, timeout)
            return self._json(200, {
                "rv": rv, "resync": resync, "epoch": st.epoch,
                "events": [{"rv": r, "kind": k, "obj": o}
                           for r, k, o in events]},
                trickle_ms=trickle)
        if url.path == "/bandwidth":
            # per-node DCN accounting reports (api/netusage.py), the
            # GET-route view of what the agents measured; ?node=
            # narrows to one host
            q = parse_qs(url.query)
            want = q.get("node", [""])[0]
            with st.cluster._lock:
                reports = {
                    name: codec.encode(rep) for name, rep in
                    getattr(st.cluster, "bandwidthreports", {}).items()
                    if not want or name == want}
            return self._json(200, {"reports": reports})
        if url.path == "/traces":
            # recent scheduler session traces (the flight recorder's
            # query surface; vtpctl trace / tools/trace_report.py).
            # ?job= filters to traces touching one job key; the epoch
            # tells a client whether the ring's history predates a
            # server restart
            q = parse_qs(url.query)
            job = q.get("job", [""])[0]
            episode = q.get("episode", [""])[0]
            limit = int(q.get("limit", ["0"])[0])
            return self._json(200, {
                "epoch": st.epoch,
                "traces": st.traces(job=job, limit=limit,
                                    episode=episode)})
        if url.path == "/fleet_trace":
            # the stitched cross-plane span tree for one causal
            # episode (written by the leaseholder router's stitcher
            # into the fleet_trace dict-kind; durable, so a promoted
            # standby serves the same artifact)
            q = parse_qs(url.query)
            episode = q.get("episode", [""])[0]
            if not episode:
                return self._json(400, {"error": "missing episode"})
            with st.cluster._lock:
                doc = getattr(st.cluster, "fleet_traces",
                              {}).get(episode)
            if doc is None:
                return self._json(404, {
                    "error": f"no stitched trace for {episode!r}"})
            return self._json(200, {"episode": episode, "trace": doc})
        if url.path == "/audit":
            q = parse_qs(url.query)
            since = int(q.get("since", ["0"])[0])
            key = q.get("key", [""])[0]
            idx, records, lost = st.audit_since(since, key=key)
            return self._json(200, {"idx": idx, "records": records,
                                    "lost": lost})
        return self._json(404, {"error": f"no route {url.path}"})

    # -- POST ----------------------------------------------------------

    def do_POST(self):  # noqa: N802
        fault = self._wire_fault()
        if fault == "handled":
            return None
        if not self._authorized():
            return None
        url = urlparse(self.path)
        st = self.state
        try:
            body = self._body()
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": str(e)})
        if url.path in ("/campaign", "/promote"):
            # replication control plane: votes and forced promotion
            # bypass the write gates (they are ABOUT the gates)
            if st.repl is None:
                return self._json(404, {"error": "not replicated"})
            if url.path == "/campaign":
                return self._json(200, st.repl.handle_campaign(body))
            if st.repl.is_leader:
                return self._json(200, {"ok": True, "already": True,
                                        "term": st.repl.term})
            # promote() may ABANDON (term moved / vote granted to a
            # concurrent candidate mid-call): report that truthfully
            # — an operator forcing failover must not see a false ok
            won = st.repl.promote(st.repl.term + 1)
            return self._json(200, {"ok": won,
                                    "role": st.repl.role,
                                    "term": st.repl.term})
        # follower gate: a replica whose write path is dead refuses
        # every mutation with the read-only 503 shape + a leader hint
        # (the read-only degrade mode IS this role, minus the hint)
        if st.repl is not None and not st.repl.may_write():
            return self._follower_503()
        # read-only degrade gate: while the WAL is poisoned nothing
        # can be made durable, so mutation routes are refused UP FRONT
        # (503 + Retry-After) before they touch the in-memory store —
        # memory and disk must not drift apart under a full disk.
        # Leases and traces stay served (READONLY_OK_POSTS).
        if st.readonly_reason and url.path not in READONLY_OK_POSTS:
            return self._readonly_503(st.readonly_reason)
        if fault is not None and fault.kind == "duplicate":
            # the in-network duplicated request: the same body is
            # delivered twice, back to back.  The first delivery runs
            # the full pipeline (its ack is discarded — the network
            # "kept" the duplicate); the answer below comes from the
            # second.  Idempotency keys make the pair collapse to one
            # application; unkeyed mutations must be state-compare
            # safe — exactly what this fault exists to prove.
            import copy
            self._process_post(url.path, copy.deepcopy(body), st)
        code, payload, _req_id = self._process_post(url.path, body, st)
        # durability barrier BEFORE the ack: every event this request
        # caused (and its idempotency record) is fsync'd in the WAL —
        # the journals-before-acking contract the reference gets from
        # etcd
        from volcano_tpu_torch.server.durability import ReadOnlyError
        try:
            st.commit()
        except ReadOnlyError as e:
            if url.path in READONLY_OK_POSTS:
                # leases/traces keep serving from memory through the
                # degrade: their journal records are dropped (state
                # re-captured wholesale at heal), and leader election
                # must not stall on a full disk
                pass
            else:
                # the mutation applied in memory but cannot be made
                # durable YET: 503, never ack.  The recorded
                # idempotency verdict is deliberately KEPT — it and
                # the in-memory state share fate exactly: heal()'s
                # full snapshot persists both together (the retry
                # then replays the verdict for state that IS
                # durable), while a crash before heal loses both
                # together (the retry re-applies for real).
                # Forgetting the verdict here would double-apply
                # non-idempotent mutations after a heal: the command
                # the 503'd attempt left in memory becomes durable,
                # and the retry — finding no recorded verdict —
                # appends a second one.
                return self._readonly_503(e.reason)
        if fault is not None and fault.kind == "drop_response":
            # the ack-lost case: committed, durable, and the client
            # will never know — its retry (idempotency key or
            # state-compare) must converge, not double-apply
            self.close_connection = True
            return None
        trickle = fault.ms or 20.0 if fault is not None \
            and fault.kind == "trickle" else 0.0
        return self._json(code, payload, trickle_ms=trickle)

    def _process_post(self, path: str, body, st) -> tuple:
        """Route one POST body: idempotency replay, dispatch, verdict
        recording.  Returns (code, payload, req_id) — commit/ack is
        the caller's job."""
        # idempotency key: a retried mutation whose first attempt
        # committed (crash/partition between commit and ack) must get
        # the recorded verdict back, never double-apply — the replay-
        # safe half of the client's retry policy.  The cache itself is
        # journaled (_req WAL records + snapshots), so it survives the
        # very crash it exists for.
        req_id = body.pop("_req_id", None) if isinstance(body, dict) \
            else None
        # fence gate, BEFORE the idempotency replay: a deposed
        # holder's retry must get the 409 even where its first attempt
        # committed and recorded a verdict — the refusal is about WHO
        # is writing now, not what the write would do
        fence = body.pop("_fence", None) if isinstance(body, dict) \
            else None
        if isinstance(fence, dict) and fence.get("name"):
            try:
                st.check_fence(fence["name"],
                               int(fence.get("term", 0)))
            except ValueError as e:
                return 409, {"error": str(e)}, None
        if req_id:
            hit = st.replay_response(req_id)
            if hit is not None:
                return hit[0], hit[1], None
        try:
            code, payload = self._route_post(path, body, st)
        except KeyError as e:
            code, payload = 404, {"error": str(e)}
        except ValueError as e:
            # discriminate by TYPE, never message wording (see
            # _error_code): admission veto 422, conflict 409
            code, payload = _error_code(e), {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — surface, don't kill thread
            log.exception("POST %s failed", path)
            code, payload = 500, {"error": str(e)}
        if req_id and code < 500:
            # 4xx verdicts are deterministic state-compare outcomes:
            # recording them keeps a retry's answer stable; 5xx is a
            # server fault the retry should re-attempt for real
            st.record_response(req_id, code, payload)
        return code, payload, req_id

    def _route_post(self, path: str, body: dict, st) -> tuple:
        cl = st.cluster
        if path.startswith("/objects/"):
            kind = path[len("/objects/"):]
            if kind not in KINDS:
                return 404, {"error": f"unknown kind {kind}"}
            obj = codec.decode(body["obj"])
            key = body.get("key")
            if kind == "pod":
                # whole-pod writes go through the same chip-guard as
                # /bind: check-and-put is atomic under _bind_mutex so
                # a concurrent bind cannot slip between them
                with st._bind_mutex:
                    err = st.check_put_capacity(obj)
                    if err:
                        raise ValueError(err)       # -> 409
                    stored = cl.put_object(kind, obj, key=key)
            else:
                stored = cl.put_object(kind, obj, key=key)
            return 200, {"obj": codec.encode(stored)}
        if path == "/bind":
            with st._bind_mutex:
                err = st.check_bind_capacity(
                    body["namespace"], body["name"], body["node_name"])
                if err:
                    raise ValueError(err)       # -> 409
                cl.bind_pod(body["namespace"], body["name"],
                            body["node_name"],
                            ts_alloc=body.get("ts_alloc"))
            return 200, {"ok": True}
        if path == "/bind_batch":
            # a gang's binds as ONE request (the wire fast lane's
            # biggest round-trip saving: 256 POSTs -> 1).  Failure
            # stays per-item — same verdict the per-pod route
            # would have returned, so a conflict on one pod never
            # vetoes its gang-mates.  Per-item state-compare keeps a
            # whole-batch retry replay-safe: a pod the first attempt
            # already bound re-verdicts as success (same node), not
            # 409.
            results = []
            bound = 0
            with st._bind_mutex:
                for b in body.get("binds", []):
                    try:
                        if b.get("pod") is not None and \
                                f"{b['namespace']}/{b['name']}" \
                                not in cl.pods:
                            # keyspace-partitioned write plane: the
                            # pending pod lived in the META leader
                            # group; its bind relocates it here, to the
                            # group owning the node, so this group's
                            # chip accounting sees node AND occupant
                            # together.  Admit-then-bind is one atomic
                            # step under _bind_mutex; the admitted pod
                            # is nodeless/Pending, so the put guard has
                            # nothing to refuse and the capacity
                            # verdict below is the only arbiter.
                            cl.put_object("pod", codec.decode(b["pod"]))
                        err = st.check_bind_capacity(
                            b["namespace"], b["name"], b["node_name"])
                        if err:
                            raise ValueError(err)   # -> 409 per-item
                        cl.bind_pod(b["namespace"], b["name"],
                                    b["node_name"],
                                    ts_alloc=b.get("ts_alloc"))
                        results.append({"ok": True})
                        bound += 1
                    except Exception as e:  # noqa: BLE001 — per-item
                        results.append({
                            "ok": False, "code": _error_code(e),
                            "error": str(e) or type(e).__name__})
            return 200, {"bound": bound, "results": results}
        if path == "/evict":
            cl.evict_pod(body["namespace"], body["name"],
                         body.get("reason", ""))
            return 200, {"ok": True}
        if path == "/nominate":
            cl.nominate_pod(body["namespace"], body["name"],
                            body["node_name"])
            return 200, {"ok": True}
        if path == "/podgroup_status":
            cl.update_podgroup_status(codec.decode(body["obj"]))
            return 200, {"ok": True}
        if path == "/record_event":
            cl.record_event(body["obj_key"], body["reason"],
                            body.get("message", ""))
            return 200, {"ok": True}
        if path == "/command":
            cl.add_command(body["target"], body["action"])
            return 200, {"ok": True}
        if path == "/drain_commands":
            cmds = cl.drain_commands(body["target"])
            if cmds and st.durable is not None:
                # drains don't flow through the event log (commands
                # are consumed, not updated) — journal them directly
                # or a replayed WAL would resurrect consumed commands.
                # Journaled by cid: a concurrent add_command's event
                # record can land on either side of this one in the
                # file, so replay removes the exact consumed set
                # regardless of record order
                # vtplint: disable=append-lock (journaled by cid: replay removes the exact consumed set regardless of record order — see the comment above)
                st.durable.append({"k": "_drain", "o": {
                    "target": body["target"],
                    "cids": [c.get("cid") for c in cmds
                             if isinstance(c, dict) and c.get("cid")]}})
            return 200, {"commands": cmds}
        if path == "/trace":
            st.add_trace(body.get("trace"))
            return 200, {"ok": True}
        if path == "/lease":
            return 200, st.lease(
                body["name"], body["holder"],
                float(body.get("ttl", 15.0)),
                release=bool(body.get("release")))
        if path == "/fence":
            return 200, st.advance_fence(
                body["name"], int(body.get("term", 0)))
        if path == "/tick":
            cl.tick()
            return 200, {"ok": True}
        if path == "/complete_pod":
            cl.complete_pod(body["key"],
                            succeeded=bool(body.get("succeeded", True)),
                            exit_code=body.get("exit_code"))
            return 200, {"ok": True}
        return 404, {"error": f"no route {path}"}

    # -- DELETE --------------------------------------------------------

    def do_DELETE(self):  # noqa: N802
        fault = self._wire_fault(allowed=(
            "drop_request", "drop_response", "delay", "reorder",
            "http_503", "reset"))
        if fault == "handled":
            return None
        if not self._authorized():
            return None
        url = urlparse(self.path)
        if self.state.repl is not None and \
                not self.state.repl.may_write():
            return self._follower_503()
        if self.state.readonly_reason:
            return self._readonly_503(self.state.readonly_reason)
        if not url.path.startswith("/objects/"):
            return self._json(404, {"error": f"no route {url.path}"})
        kind = url.path[len("/objects/"):]
        if kind not in KINDS:
            return self._json(404, {"error": f"unknown kind {kind}"})
        q = parse_qs(url.query)
        key = q.get("key", [""])[0]
        if not key:
            return self._json(400, {"error": "missing key"})
        # fence gate (query params — DELETE carries no body): same
        # deposed-writer refusal as the POST path
        fname = q.get("fence_name", [""])[0]
        if fname:
            try:
                fterm = int(q.get("fence_term", ["0"])[0])
            except (TypeError, ValueError):
                fterm = 0
            try:
                self.state.check_fence(fname, fterm)
            except ValueError as e:
                return self._json(409, {"error": str(e)})
        self.state.cluster.delete_object(kind, key)
        from volcano_tpu_torch.server.durability import ReadOnlyError
        try:
            self.state.commit()
        except ReadOnlyError as e:
            return self._readonly_503(e.reason)
        if fault is not None and fault.kind == "drop_response":
            # the ack-lost delete: committed, never told — a retried
            # DELETE of a gone key is a no-op, so it must converge
            self.close_connection = True
            return None
        return self._json(200, {"ok": True})


def serve(port: int = 0, cluster: Optional[FakeCluster] = None,
          tick_period: float = 0.0, tls_cert: str = "",
          tls_key: str = "", token: str = "", data_dir: str = "",
          durable=None, faults=None, wal_force_truncate: bool = False,
          replication=None
          ) -> Tuple[ThreadingHTTPServer, StateServer]:
    """Start the server on 127.0.0.1:port (0 = ephemeral); returns
    (http_server, state).  Caller runs http_server.serve_forever()
    or uses the background thread started here.  tls_cert/tls_key
    make the listener TLS-only; token guards every route except
    /healthz and /metrics.  data_dir (or a pre-built DurableStore via
    durable=) turns on the WAL + snapshot crash-safety layer: every
    mutation is journaled and fsync'd before its ack, and boot replays
    snapshot-then-WAL.  faults (a faults.FaultPlan) arms the chaos
    engine: per-route wire faults at this handler, disk faults on the
    WAL via a FaultyVFS, clock skew installed by the caller.
    wal_force_truncate is the explicit operator override for mid-WAL
    corruption (otherwise boot refuses with WALCorruptionError)."""
    from volcano_tpu_torch import faults as faults_mod
    from volcano_tpu_torch.server.httputil import serve_threaded
    if durable is None and data_dir:
        from volcano_tpu_torch.server.durability import DurableStore
        vfs = None
        if faults is not None and any(r.site == "disk"
                                      for r in faults.rules):
            vfs = faults_mod.FaultyVFS(faults)
        durable = DurableStore(data_dir, vfs=vfs,
                               force_truncate=wal_force_truncate)
    state = StateServer(cluster, durable=durable,
                        replication=replication)
    httpd = serve_threaded(_Handler, {"state": state, "token": token,
                                      "faults": faults},
                           port, "state-server",
                           tls_cert=tls_cert, tls_key=tls_key)
    if replication is not None:
        # the listener is up: peers can reach us, the tail/watchdog
        # threads may start
        if not replication.self_url:
            # the scheme the listener speaks: the URL goes out as the
            # leader hint of every follower 503 and as a candidate's
            # campaign address, and a TLS listener refuses plain HTTP
            scheme = "https" if tls_cert else "http"
            replication.self_url = \
                f"{scheme}://127.0.0.1:{httpd.server_address[1]}"
        replication.start()
    state.tick_stop = threading.Event()
    if tick_period > 0:
        def tick_loop():
            while not state.tick_stop.wait(tick_period):
                try:
                    if state.repl is not None and \
                            not state.repl.may_write():
                        # a follower's kubelet is the LEADER's tick,
                        # shipped like any other mutation
                        continue
                    if state.readonly_reason:
                        # no kubelet mutations while read-only: their
                        # journal records would be dropped, and memory
                        # must not drift from what heal() can capture
                        # consistently
                        continue
                    state.cluster.tick()
                    # tick mutations have no ack path; commit here so
                    # they become watch-visible (and durable) promptly
                    state.commit()
                except Exception as e:  # noqa: BLE001
                    from volcano_tpu_torch.server.durability import \
                        ReadOnlyError
                    if isinstance(e, ReadOnlyError):
                        # quorum not assembled yet / degrade window:
                        # routine for a replicated boot, not an error
                        log.debug("tick commit deferred: %s", e)
                    else:
                        log.exception("tick failed")
        threading.Thread(target=tick_loop, name="kubelet-tick",
                         daemon=True).start()
    if durable is not None:
        def compact_loop():
            while not state.tick_stop.wait(0.5):
                try:
                    durable.status()    # refreshes the WAL gauges
                    if durable.poisoned:
                        # read-only degrade: keep probing for heal —
                        # Retry-After tells clients to check back on
                        # roughly this cadence
                        state.try_heal()
                    elif durable.should_snapshot():
                        state.write_snapshot()
                except Exception:  # noqa: BLE001
                    log.exception("snapshot compaction failed")
        threading.Thread(target=compact_loop, name="wal-compactor",
                         daemon=True).start()
    return httpd, state

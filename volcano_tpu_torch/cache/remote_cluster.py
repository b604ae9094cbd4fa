"""RemoteCluster: the wire-backed Cluster implementation.

The client half of the process split (server half:
volcano_tpu_torch/server/state_server.py).  Mirrors the reference scheduler's
informer architecture (pkg/scheduler/cache/cache.go:109,
event_handlers.go): a local object mirror is bootstrapped by one full
LIST (/snapshot) and then kept current by a background WATCH long-poll
thread; reads (list_all, store attributes) are served from the mirror
with zero RPCs, and every write goes to the server AND is echoed into
the mirror immediately so a process observes its own writes without
waiting for the watch round-trip (the reference's assume-cache
discipline, cache.go:1342 AddBindTask).

Stdlib-only: urllib over HTTP/JSON with the api/codec.py codec.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.client import HTTPException
from typing import Callable, List, Optional

from volcano_tpu_torch.api import codec
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.cache.cluster import Cluster, ClusterSnapshot
from volcano_tpu_torch.cache.kinds import KINDS, key_for

log = logging.getLogger(__name__)

# ONE retry policy for every wire call (capped exponential backoff +
# FULL jitter + an overall deadline) instead of each caller hand-
# rolling its own: transient failures — connection refused/reset, a
# truncated response, a 5xx from a restarting server — are retried
# until the deadline; 4xx verdicts (auth, admission, conflict,
# missing) fail fast, every retry would get the same answer.  A 503
# carrying Retry-After (the server's read-only degrade) is HONOURED:
# the sleep is at least the server's ask, plus jitter — so a fleet of
# mirrors waits out a full-disk episode instead of hammering it in
# lockstep.
RETRY_BASE_S = 0.05
RETRY_CAP_S = 2.0
RETRY_DEADLINE_S = 30.0
# per-attempt budget the WATCH LOOP hands resync(): the loop's own
# exponential backoff owns the pacing between attempts — an unbounded
# resync would reset the deadline budget every iteration and turn a
# sick server's recovery into a retry storm
WATCH_RESYNC_BUDGET_S = 3.0

# POST routes a client fence never stamps: lease CAS and fence
# advances carry their terms explicitly, and traces are never fenced
_UNFENCED_POSTS = frozenset({"/lease", "/fence", "/trace"})


def _retry_sleep(delay: float, e: Exception, remain: float) -> float:
    """One backoff sleep under the shared policy: full jitter over the
    current delay, floored at the server's Retry-After when it sent
    one, capped by the remaining deadline."""
    retry_after = float(getattr(e, "retry_after", 0.0) or 0.0)
    return min(max(remain, 0.0),
               retry_after + random.uniform(0, delay))


def _transient(e: Exception) -> bool:
    """Worth retrying?  Connection failures (URLError IS an OSError),
    truncated/garbled responses (HTTPException), and server-side 5xx
    (a restarting or overloaded server).  4xx — including 401/403
    auth and 409/422 verdicts, already mapped to their own exception
    types — would fail identically forever."""
    return isinstance(e, (OSError, HTTPException)) or \
        (isinstance(e, RemoteError) and e.code >= 500)


class StaleReplicaError(RuntimeError):
    """A same-lineage full re-list came back OLDER than the mirror
    (lagging read replica): the rewind was refused and the sticky
    read endpoint rotated.  resync() swallows this (the mirror just
    stays put for a beat); it exists as a type so the refusal is
    never mistaken for a wire failure."""


class RemoteError(RuntimeError):
    def __init__(self, code: int, message: str,
                 retry_after: float = 0.0, leader: str = ""):
        super().__init__(message)
        self.code = code
        # parsed from the Retry-After header (seconds); 0 = none.
        # The read-only degrade's 503s carry it so clients pace their
        # retries to the server's heal cadence.
        self.retry_after = retry_after
        # a follower's 503 carries the current leader's URL: the
        # retry re-routes the write instead of hammering the replica
        self.leader = leader


class RemoteCluster(Cluster):
    def __init__(self, base_url: str, start_watch: bool = True,
                 timeout: float = 10.0, token: str = "",
                 ca_cert: str = "", insecure: bool = False,
                 tolerate_unreachable: bool = False,
                 retry_deadline: float = RETRY_DEADLINE_S):
        """tolerate_unreachable: a dead server at construction time
        leaves the mirror empty instead of raising — the watch loop's
        resync-on-reconnect self-heals once the server returns (the
        hub's member-cluster clients must survive a member outage).
        retry_deadline: overall per-call budget for the shared
        transient-retry policy (backoff + jitter).

        base_url may name a replica GROUP — a comma-separated URL
        list (or a list/tuple).  Writes route to the leader (tracked
        via the follower 503s' leader hints + /replication
        discovery, re-routing in-flight retries across a failover);
        reads stick to ONE randomly-chosen replica — sticky, so the
        watch revision stays on one rv timeline — rotating to the
        next replica on failure.  A fleet of mirrors thereby spreads
        its read load across the followers while every write still
        funnels through the single elected writer."""
        if isinstance(base_url, str):
            endpoints = [u for u in base_url.split(",") if u.strip()]
        else:
            endpoints = list(base_url)
        self.endpoints = [u.strip().rstrip("/") for u in endpoints]
        self.base_url = self.endpoints[0]      # current WRITE target
        # sticky read replica (random: a fleet self-spreads); single-
        # endpoint configs keep the exact legacy behavior
        self._read_idx = random.randrange(len(self.endpoints)) \
            if len(self.endpoints) > 1 else 0
        self.timeout = timeout
        self.token = token
        self._retry_deadline = retry_deadline
        # optional fencing token (set_fence): every mutating request
        # carries it so the server refuses this client once a newer
        # tenancy (higher term) has written — the deposed-router guard
        self._fence: Optional[tuple] = None   # (name, term)
        from volcano_tpu_torch.server.tlsutil import client_ssl_context
        self._ssl_ctx = client_ssl_context(ca_cert, insecure)
        self._mlock = threading.RLock()        # mirror + watchers
        self._watchers: List[Callable[[str, object], None]] = []
        self._rv = 0
        self._epoch = ""
        self._stop = threading.Event()
        # mirror stores, same attribute names as FakeCluster
        for spec in KINDS.values():
            setattr(self, spec.attr, {})
        self.commands: List[dict] = []
        self.events: List[tuple] = []          # local record only
        try:
            if tolerate_unreachable:
                # a dead member must not stall the hub's boot for the
                # whole retry budget: one attempt, the watch loop's
                # backoff owns the healing from here
                self.resync(_deadline=0.0)
            else:
                self.resync()
        except Exception as e:  # noqa: BLE001 — classified below
            # Tolerable: anything the watch loop could heal once the
            # server is back (the shared _transient classification).
            # NOT tolerable: 4xx auth/config errors — every retry
            # would 401 forever, so fail fast even in tolerant mode.
            if not tolerate_unreachable or not _transient(e):
                raise
            log.warning("state server %s unreachable at startup (%s); "
                        "mirror starts empty and the watch loop will "
                        "resync when it returns", self.base_url, e)
        self._watch_thread = None
        if start_watch:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="cluster-watch", daemon=True)
            self._watch_thread.start()

    # -- HTTP ----------------------------------------------------------

    def _request(self, method: str, path: str, payload=None,
                 timeout: Optional[float] = None,
                 deadline: Optional[float] = None, retries: bool = True,
                 idempotency_key: bool = False):
        """One wire call under the unified retry policy.

        idempotency_key stamps the payload with a per-REQUEST id
        (stable across this call's retries): the server records the
        response it committed for that id, so a retry after a crash-
        between-commit-and-ack replays the verdict instead of double-
        applying (e.g. a re-created vcjob minting a second uid, a
        duplicated Command, a drain losing its commands).  Mutations
        without a key are replay-safe by state-compare (re-bind to the
        same node, overwrite-put, repeated evict/delete)."""
        if idempotency_key and payload is not None:
            # stable across this call's retries AND across a leader
            # failover re-route: the new leader replayed the shipped
            # _req records, so a retried write that already committed
            # gets its recorded verdict, never a double-apply
            payload = dict(payload, _req_id=uuid.uuid4().hex)
        if self._fence is not None and method == "POST" and \
                isinstance(payload, dict) and \
                path.partition("?")[0] not in _UNFENCED_POSTS:
            payload = dict(payload, _fence={
                "name": self._fence[0], "term": self._fence[1]})
        budget = self._retry_deadline if deadline is None else deadline
        t_end = time.monotonic() + budget
        delay = RETRY_BASE_S
        is_read = method == "GET"
        while True:
            base = self.endpoints[self._read_idx] if is_read \
                else self.base_url
            try:
                return self._request_once(method, path, payload,
                                          timeout, base=base)
            except Exception as e:  # noqa: BLE001 — classified
                remain = t_end - time.monotonic()
                if not retries or not _transient(e) or remain <= 0 \
                        or self._stop.is_set():
                    # budget spent: surface the failure NOW — leader
                    # discovery probes would overshoot the caller's
                    # deadline by seconds
                    raise
                if len(self.endpoints) > 1:
                    self._reroute(is_read, e)
                from volcano_tpu_torch import metrics
                metrics.inc("client_retries_total",
                            route=path.partition("?")[0])
                log.debug("wire %s %s failed (%s); retrying",
                          method, path, e)
                # close() (a SIGTERM's handler among its callers) cuts
                # the back-off short and the next failure surfaces
                self._stop.wait(_retry_sleep(delay, e, remain))
                delay = min(delay * 2, RETRY_CAP_S)

    def _reroute(self, is_read: bool, e: Exception) -> None:
        """Failover routing on a transient error in a replica group:
        reads rotate to the next sticky replica; writes follow the
        follower 503's leader hint when one came, else re-discover
        the leader via GET /replication across the group."""
        if is_read:
            self._read_idx = (self._read_idx + 1) % len(self.endpoints)
            return
        hint = getattr(e, "leader", "")
        if hint and hint.rstrip("/") != self.base_url:
            self.base_url = hint.rstrip("/")
            log.debug("write path re-routed to hinted leader %s",
                      self.base_url)
            return
        self._discover_leader()

    def _discover_leader(self) -> None:
        best, best_term = "", -1
        for url in self.endpoints:
            try:
                doc = self._request_once("GET", "/replication",
                                         timeout=2.0, base=url)
            except Exception:  # noqa: BLE001 — candidate down
                # vtplint: disable=except-pass (leader-discovery scan: a dark endpoint cannot be the leader; the loop keeps probing)
                continue
            term = int(doc.get("term", 0) or 0)
            if doc.get("role") == "leader" and term > best_term:
                best, best_term = url, term
            elif doc.get("leader") and term > best_term:
                best, best_term = doc["leader"].rstrip("/"), term
        if best and best != self.base_url:
            self.base_url = best
            log.info("write path re-routed to discovered leader %s",
                     best)

    def _request_once(self, method: str, path: str, payload=None,
                      timeout: Optional[float] = None,
                      base: Optional[str] = None):
        data = None
        if payload is not None:
            data = json.dumps(payload, separators=(",", ":")).encode()
        headers = {"Content-Type": "application/json",
                   # big GET bodies (snapshot/watch/delta) come back
                   # gzip'd; the server leaves small ones plain
                   "Accept-Encoding": "gzip"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            (base or self.base_url) + path, data=data, method=method,
            headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout,
                    context=self._ssl_ctx) as resp:
                from volcano_tpu_torch.server.httputil import read_json_body
                return read_json_body(resp)
        except urllib.error.HTTPError as e:
            leader = ""
            try:
                doc = json.loads(e.read())
                msg = doc.get("error", str(e))
                leader = doc.get("leader") or ""
            except Exception:  # noqa: BLE001
                msg = str(e)
            if e.code == 422:
                from volcano_tpu_torch.webhooks.admission import AdmissionError
                raise AdmissionError(msg) from None
            if e.code == 409:
                raise ValueError(msg) from None
            if e.code == 404:
                raise KeyError(msg) from None
            try:
                retry_after = float(e.headers.get("Retry-After") or 0.0)
            except (TypeError, ValueError):
                retry_after = 0.0
            raise RemoteError(e.code, msg, retry_after=retry_after,
                              leader=leader) from None

    # -- mirror maintenance --------------------------------------------

    @staticmethod
    def _epoch_base(epoch: str) -> str:
        """Durable servers stamp "BASE.BOOT" epochs: the BASE survives
        restarts as long as the rv history is WAL-continuous, the BOOT
        half bumps each boot.  Legacy/non-durable epochs are opaque
        uuids (base == whole epoch), so any restart changes the
        base."""
        return epoch.rsplit(".", 1)[0]

    def resync(self, _deadline: Optional[float] = None) -> None:
        """Reconcile the mirror with the server, delta-first.

        A mirror that already holds a revision asks the watch endpoint
        (timeout=0: no long-poll, same payload shape, works against
        any server vintage) for the events since it: O(churn) work
        and bytes, not O(cluster) — at a few thousand hosts the full
        snapshot is megabytes while a churn window is a handful of
        events.  The delta is also taken ACROSS a server restart when
        the epoch BASE matches (a durable server replayed its WAL: the
        rv space is continuous and nothing any mirror ever saw was
        lost, since the server only releases fsync'd events) — that is
        the O(churn) recovery path after a kill -9.  Falls back to the
        full LIST when the mirror is empty (bootstrap), the revision
        fell off the server's compaction horizon (resync verdict), the
        server is a different incarnation lineage (epoch BASE change:
        its rv space is unrelated), the server's rv is BEHIND the
        mirror's (a restart that lost unacked tail events the snapshot
        briefly exposed), or the delta request itself fails."""
        # _epoch marks "bootstrapped at least once" — rv 0 is a valid
        # revision (a mirror synced before the first event), so gate on
        # the epoch, not the revision
        if self._epoch:
            try:
                payload = self._request(
                    "GET", f"/watch?since={self._rv}&timeout=0",
                    deadline=_deadline)
            except Exception as e:  # noqa: BLE001 — fall back to LIST
                log.debug("delta resync failed (%s); full re-list", e)
                payload = None
            epoch = payload.get("epoch", "") if payload else ""
            if payload is not None and not payload.get("resync") \
                    and payload["rv"] >= self._rv \
                    and (epoch == self._epoch or
                         (epoch and self._epoch_base(epoch) ==
                          self._epoch_base(self._epoch))):
                from volcano_tpu_torch import metrics
                metrics.inc("mirror_resync_total", mode="delta")
                # fold like a watch batch (copy-on-write swap) and
                # NOTIFY: these are real missed events, and watchers
                # (controllers) level-trigger off them exactly as if
                # the watch stream had delivered them
                for kind, obj in self._apply_batch(payload["events"]):
                    self._notify(kind, obj)
                with self._mlock:
                    self._rv = max(self._rv, payload["rv"])
                    self._epoch = epoch or self._epoch
                return
        try:
            self._full_resync(_deadline=_deadline)
        except StaleReplicaError as e:
            # the sticky replica lags the mirror: keep the mirror as
            # is (it is AHEAD — nothing stale about it), let the
            # rotated endpoint or the replica's catch-up win the next
            # round.  Swallowed here so bare resync() callers (tools,
            # tests) never crash on a routine failover transient.
            log.debug("full resync skipped: %s", e)
            time.sleep(0.2)

    def _full_resync(self, _deadline: Optional[float] = None) -> None:
        """Full LIST: replace the mirror (bootstrap + ring fall-off +
        server restart).  A snapshot from the SAME history lineage
        (epoch BASE) that is OLDER than the mirror is refused — with
        sticky reads rotating across replicas on failure, a re-list
        could otherwise land on a lagging follower and REWIND the
        mirror (deleted objects resurrected, phases rolled back);
        refusing makes the caller back off and retry, by which time
        the rotation found a caught-up replica or this one caught
        up.  A different BASE really is a new history: accepted."""
        from volcano_tpu_torch import metrics
        payload = self._request("GET", "/snapshot", deadline=_deadline)
        epoch = payload.get("epoch", "")
        if self._epoch and epoch and \
                self._epoch_base(epoch) == self._epoch_base(self._epoch) \
                and payload["rv"] < self._rv:
            metrics.inc("mirror_resync_total", mode="stale-refused")
            if len(self.endpoints) > 1:
                self._read_idx = (self._read_idx + 1) % \
                    len(self.endpoints)
            raise StaleReplicaError(
                f"replica snapshot rv {payload['rv']} is behind "
                f"the mirror's rv {self._rv} (lagging replica); "
                "refusing the rewind")
        metrics.inc("mirror_resync_total", mode="full")
        with self._mlock:
            self._rv = payload["rv"]
            self._epoch = payload.get("epoch", "")
            stores = payload["stores"]
            for kind, spec in KINDS.items():
                # whole-store swap, never in-place clear: readers on
                # other threads keep iterating their consistent copy
                setattr(self, spec.attr, {
                    k: codec.decode(enc)
                    for k, enc in stores.get(kind, {}).items()})
            self.commands = codec.decode(stores.get("_commands", [])) or []

    def _apply_batch(self, events) -> list:
        """Fold a watch batch into the mirror copy-on-write: each
        affected store is rebuilt as a fresh dict and swapped in, so a
        controller iterating `cluster.pods` on another thread never
        sees a dict mutate under it.  Returns (kind, obj) pairs for
        watcher notification."""
        decoded = []
        for ev in events:
            try:
                decoded.append((ev["kind"], codec.decode(ev["obj"])))
            except Exception:  # noqa: BLE001
                log.exception("watch event %s undecodable", ev["kind"])
        updated: dict = {}          # attr -> new dict
        new_commands = None
        notifications = []
        with self._mlock:           # copies + swap atomic vs local echo
            for kind, obj in decoded:
                deleted = kind.endswith("_deleted")
                base = kind[:-len("_deleted")] if deleted else kind
                spec = KINDS.get(base)
                if spec is not None:
                    key = obj["key"] if spec.key_of is None \
                        else spec.key_of(obj)
                    store = updated.get(spec.attr)
                    if store is None:
                        store = dict(getattr(self, spec.attr))
                        updated[spec.attr] = store
                    if deleted:
                        store.pop(key, None)
                    else:
                        store[key] = obj if spec.key_of else obj["obj"]
                elif base == "command":
                    if new_commands is None:
                        new_commands = list(self.commands)
                    new_commands.append(obj)
                notifications.append((kind, obj))
            for attr, store in updated.items():
                setattr(self, attr, store)
            if new_commands is not None:
                self.commands = new_commands
        return notifications

    def _watch_loop(self) -> None:
        delay = 0.2
        while not self._stop.is_set():
            try:
                # the loop IS the retry policy here (retries=False):
                # its backoff must keep ticking between long-polls,
                # not nest another backoff inside each one
                payload = self._request(
                    "GET", f"/watch?since={self._rv}&timeout=25",
                    timeout=60.0, retries=False)
            except Exception as e:  # noqa: BLE001 — classified
                if not _transient(e):
                    # same transient-vs-fatal split the startup path
                    # applies: a 4xx (revoked token, bad config) would
                    # 401 on every long-poll forever — stop loudly
                    # instead of burning a retry loop in the dark
                    log.error("watch stream got a non-transient error "
                              "(%s); stopping the watch loop — the "
                              "mirror will go stale until "
                              "reconfigured", e)
                    return
                if len(self.endpoints) > 1:
                    # the long-poll asks one replica; with retries off
                    # nothing else moves it, and a dead replica would
                    # hold the mirror stale for good: ask the next one
                    self._reroute(True, e)
                # FULL jitter, floored at any Retry-After the server
                # sent: a read-only (healing) server told every
                # mirror when to come back — spreading the retries
                # stops the whole fleet reconnecting in lockstep
                if self._stop.wait(_retry_sleep(delay, e,
                                                float("inf"))):
                    return
                delay = min(delay * 2, 5.0)
                continue
            epoch = payload.get("epoch", "")
            if payload.get("resync") or payload["rv"] < self._rv or \
                    (self._epoch and epoch and epoch != self._epoch):
                # ring fall-off, rv regression, or a NEW server
                # incarnation (epoch change — catches a restarted
                # server whose counter already passed ours).  resync()
                # recovers the stream: O(churn) delta when the epoch
                # BASE matches (durable restart), full re-list
                # otherwise.  The attempt budget is BOUNDED: an
                # unbounded resync would re-arm its own 30s retry
                # storm every loop iteration, so the loop's backoff —
                # not resync's — owns the pacing between attempts.
                try:
                    self.resync(_deadline=WATCH_RESYNC_BUDGET_S)
                except Exception as e:  # noqa: BLE001
                    log.debug("watch resync attempt failed (%s); "
                              "backing off", e)
                    if self._stop.wait(_retry_sleep(delay, e,
                                                    float("inf"))):
                        return
                    delay = min(delay * 2, 5.0)
                    continue
                delay = 0.2
                continue
            delay = 0.2
            for kind, obj in self._apply_batch(payload["events"]):
                self._notify(kind, obj)
            self._rv = max(self._rv, payload["rv"])

    def close(self) -> None:
        self._stop.set()

    def _notify(self, kind: str, obj) -> None:
        for w in list(self._watchers):
            try:
                w(kind, obj)
            except Exception:  # noqa: BLE001
                log.exception("watcher failed on %s", kind)

    # -- Cluster interface: reads --------------------------------------

    def list_all(self) -> ClusterSnapshot:
        with self._mlock:
            return ClusterSnapshot(
                pods=list(self.pods.values()),
                nodes=list(self.nodes.values()),
                podgroups=list(self.podgroups.values()),
                queues=list(self.queues.values()),
                hypernodes=list(self.hypernodes.values()),
                priority_classes=list(self.priority_classes.values()),
                vcjobs=list(self.vcjobs.values()),
            )

    def watch(self, fn) -> None:
        self._watchers.append(fn)

    def unwatch(self, fn) -> None:
        try:
            self._watchers.remove(fn)
        except ValueError:
            pass

    # -- Cluster interface: writes (server + local echo) ---------------

    def put_object(self, kind: str, obj, key: Optional[str] = None):
        # keyed: a retried CREATE must not re-run create-side effects
        # (a vcjob minting a fresh uid, admission mutations) after the
        # first attempt committed — the server replays the recorded
        # response instead
        resp = self._request("POST", f"/objects/{kind}",
                             {"obj": codec.encode(obj), "key": key},
                             idempotency_key=True)
        stored = codec.decode(resp["obj"])
        spec = KINDS[kind]
        k = key_for(kind, stored if spec.key_of else obj, key)
        with self._mlock:
            getattr(self, spec.attr)[k] = stored
        self._notify(kind, stored if spec.key_of
                     else {"key": k, "obj": stored})
        return stored

    def delete_object(self, kind: str, key: str) -> None:
        from urllib.parse import quote
        path = f"/objects/{kind}?key={quote(key, safe='')}"
        if self._fence is not None:
            # DELETE has no body: the fence rides as query params
            path += (f"&fence_name={quote(self._fence[0], safe='')}"
                     f"&fence_term={self._fence[1]}")
        self._request("DELETE", path)
        spec = KINDS[kind]
        with self._mlock:
            obj = getattr(self, spec.attr).pop(key, None)
        if obj is not None:
            self._notify(f"{kind}_deleted",
                         obj if spec.key_of else {"key": key, "obj": obj})

    # typed conveniences matching the FakeCluster surface ---------------

    def add_node(self, node):
        return self.put_object("node", node)

    def remove_node(self, name: str):
        self.delete_object("node", name)

    def add_pod(self, pod) -> None:
        self.put_object("pod", pod)

    def delete_pod(self, key: str) -> None:
        self.delete_object("pod", key)

    def add_podgroup(self, pg) -> None:
        self.put_object("podgroup", pg)

    def delete_podgroup(self, key: str) -> None:
        self.delete_object("podgroup", key)

    def add_queue(self, queue):
        return self.put_object("queue", queue)

    def add_hypernode(self, hn) -> None:
        self.put_object("hypernode", hn)

    def delete_hypernode(self, name: str) -> None:
        self.delete_object("hypernode", name)

    def add_numatopology(self, topo) -> None:
        self.put_object("numatopology", topo)

    def add_priority_class(self, pc) -> None:
        self.put_object("priority_class", pc)

    def add_vcjob(self, job):
        return self.put_object("vcjob", job)

    def update_vcjob(self, job) -> None:
        # explicit key marks this as an UPDATE: the server must not
        # re-run create admission on a status flush (e.g. a job whose
        # queue has closed since creation would 422 forever)
        self.put_object("vcjob", job, key=job.key)

    def delete_vcjob(self, key: str) -> None:
        self.delete_object("vcjob", key)

    # -- scheduler write path ------------------------------------------

    def bind_pod(self, namespace: str, name: str, node_name: str,
                 ts_alloc: Optional[float] = None) -> None:
        body = {"namespace": namespace, "name": name,
                "node_name": node_name}
        if ts_alloc is not None:
            # decision stamp for the `allocated` lifecycle phase;
            # servers that predate it ignore unknown body fields
            body["ts_alloc"] = ts_alloc
        # vtplint: disable=req-id (replay-safe by state-compare: a re-bind to the same node re-verdicts as success, never double-applies)
        self._request("POST", "/bind", body)
        with self._mlock:
            pod = self.pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.node_name = node_name
                pod.phase = TaskStatus.BOUND

    def bind_pods(self, binds) -> List[Optional[str]]:
        """A gang's binds as ONE /bind_batch request instead of N bind
        POSTs — the client half of the wire fast lane.  Per-item error
        strings mirror the per-pod path (Cluster.bind_pods contract);
        successes are echoed into the mirror under one lock.  A server
        that predates the route (rolling upgrade: 404s the path) or a
        transport failure falls back to the per-pod loop — bind_pod
        re-sent for an already-applied bind is idempotent (same-node
        rebind is accepted), so the fallback never double-faults."""
        binds = [tuple(b) + (None,) * (4 - len(b)) for b in binds]
        if not binds:
            return []
        try:
            # keyed: a batch whose ack died with the old leader must
            # replay its recorded per-item verdicts on the promoted
            # one (exactly-once commit across a failover), not re-run
            # the capacity checks against a half-applied world
            resp = self._request("POST", "/bind_batch", {"binds": [
                dict({"namespace": ns, "name": n, "node_name": node},
                     **({"ts_alloc": ts} if ts is not None else {}))
                for ns, n, node, ts in binds]}, idempotency_key=True)
            results = resp["results"]
            if len(results) != len(binds):
                raise RemoteError(500, "bind_batch result count "
                                  f"{len(results)} != {len(binds)}")
        except Exception as e:  # noqa: BLE001 — whole-batch failure
            log.warning("bind_batch unavailable (%s); falling back to "
                        "per-pod binds", e)
            return super().bind_pods(binds)
        errors: List[Optional[str]] = []
        with self._mlock:
            for (ns, n, node, _ts), r in zip(binds, results):
                if r.get("ok"):
                    pod = self.pods.get(f"{ns}/{n}")
                    if pod is not None:
                        pod.node_name = node
                        pod.phase = TaskStatus.BOUND
                    errors.append(None)
                else:
                    errors.append(r.get("error", "bind failed"))
        return errors

    def evict_pod(self, namespace: str, name: str, reason: str = "") -> None:
        # vtplint: disable=req-id (replay-safe by state-compare: re-evicting a Releasing/gone pod converges)
        self._request("POST", "/evict", {
            "namespace": namespace, "name": name, "reason": reason})
        with self._mlock:
            pod = self.pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.phase = TaskStatus.RELEASING
                pod.status_message = reason

    def nominate_pod(self, namespace: str, name: str,
                     node_name: str) -> None:
        # vtplint: disable=req-id (replay-safe overwrite: nominating the same node twice is the same state)
        self._request("POST", "/nominate", {
            "namespace": namespace, "name": name, "node_name": node_name})
        with self._mlock:
            pod = self.pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.nominated_node = node_name

    def update_podgroup_status(self, pg) -> None:
        # vtplint: disable=req-id (replay-safe overwrite-put of the full status object)
        self._request("POST", "/podgroup_status",
                      {"obj": codec.encode(pg)})
        with self._mlock:
            self.podgroups[pg.key] = pg

    def record_event(self, obj_key: str, reason: str,
                     message: str) -> None:
        self.events.append((obj_key, reason, message))
        try:
            # best-effort AND often on failure paths: a short budget,
            # never the full retry deadline
            # vtplint: disable=req-id (best-effort observability append; a rare duplicate event line is harmless)
            self._request("POST", "/record_event", {
                "obj_key": obj_key, "reason": reason,
                "message": message}, deadline=2.0)
        except Exception:  # noqa: BLE001 — events are best-effort
            log.debug("record_event failed", exc_info=True)

    # -- command bus ---------------------------------------------------

    def add_command(self, target_key: str, action: str) -> None:
        # keyed: a retried Command would otherwise double-queue (two
        # RestartJobs = two restarts)
        self._request("POST", "/command",
                      {"target": target_key, "action": action},
                      idempotency_key=True)

    def drain_commands(self, target_key: str):
        # keyed: a retried drain whose first attempt committed would
        # find an empty bus and LOSE the commands — the replayed
        # response carries what the first attempt drained
        resp = self._request("POST", "/drain_commands",
                             {"target": target_key},
                             idempotency_key=True)
        with self._mlock:
            self.commands = [c for c in self.commands
                             if c.get("target") != target_key]
        return resp["commands"]

    # -- test / simulation surface -------------------------------------

    def tick(self) -> None:
        # vtplint: disable=req-id (test/simulation surface: a duplicate kubelet tick only advances the simulated clock)
        self._request("POST", "/tick")

    def complete_pod(self, key: str, succeeded: bool = True,
                     exit_code=None) -> None:
        # vtplint: disable=req-id (replay-safe by state-compare: completing a completed pod is a no-op)
        self._request("POST", "/complete_pod", {
            "key": key, "succeeded": succeeded, "exit_code": exit_code})

    # -- leader election -----------------------------------------------

    def lease(self, name: str, holder: str, ttl: float = 15.0,
              release: bool = False,
              deadline: Optional[float] = None) -> dict:
        """deadline bounds the retry budget: a renewal must fail
        before the caller's next renewal slot, not block past the
        lease TTL and forfeit leadership to a slow wire."""
        # vtplint: disable=req-id (lease CAS is idempotent for the same holder; a replayed acquire/renew returns the same verdict)
        return self._request("POST", "/lease", {
            "name": name, "holder": holder, "ttl": ttl,
            "release": release}, deadline=deadline)

    def leases(self) -> dict:
        """{name: {holder, expires_in, term}} — the election surface
        `vtpctl routers` and the chaos conductor render."""
        return self._request("GET", "/leases")

    # -- fencing tokens ------------------------------------------------

    def set_fence(self, name: str, term: int) -> None:
        """Stamp every subsequent mutation with (name, term): once a
        newer term has written to the server, this client's writes are
        atomically refused (409) — the deposed-holder guard.  name=""
        clears the fence."""
        self._fence = (name, int(term)) if name else None

    def advance_fence(self, name: str, term: int,
                      deadline: Optional[float] = None) -> dict:
        """Raise the server's fence floor explicitly (a promoted
        holder calls this on every plane BEFORE its first write, so
        the predecessor's in-flight writes are already refusable)."""
        # vtplint: disable=req-id (fence advance is monotonic max(): any replay converges)
        return self._request("POST", "/fence", {
            "name": name, "term": int(term)}, deadline=deadline)

    def fences(self) -> dict:
        """{name: {term, refused}} — fence floors + refusal counts."""
        return self._request("GET", "/fences")

"""RegionMirror: the WAL-shipping machinery reused as an async object
mirror.

The federation router needs to READ remote regions cheaply and
constantly — regional capacity for scoring, podgroup phase folding,
drain progress and checkpoint/resume metadata before a migration
cutover.  Polling every region's /objects per reconcile round is
O(objects) per round; the replication tier already solved the "follow
one store's history" problem with CRC-framed WAL shipping, so
the mirror reuses that exact stream over the NON-QUORUM lane
(`GET /wal?mirror=1`, StateServer.mirror_ship):

  * bootstrap from `/replica_snapshot` (stores + wal_seq horizon),
    then tail framed records and fold the object events into a local
    FakeCluster — the same parse_record CRC + sequence verification
    the replica tail runs, refusing a corrupt or gapped batch
    WHOLESALE (never a partial apply);
  * private record kinds (`_probe`/`_lease`/`_req`/`_drain`) are the
    source region's internals — skipped, like the follower apply path
    skips them for visibility;
  * the mirror is NEVER part of the source's commit quorum and keeps
    no WAL of its own: it is a read cache whose staleness is
    ADVERTISED (`age_s`), not negotiated.  `read_checked()` is the
    enforcement point — a cutover reading checkpoint metadata through
    a mirror older than the bound gets MirrorStaleError, not stale
    state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import codec
from volcano_tpu_torch.api.federation import MIRROR_MAX_AGE_S
from volcano_tpu_torch.cache.fake_cluster import FakeCluster

log = logging.getLogger(__name__)

# tail long-poll ceiling; also the freshness heartbeat — an idle
# source returns one empty batch per poll, which still PROVES the
# mirror is current up to the source's horizon
MIRROR_POLL_S = 5.0
# private WAL record kinds: source-internal, never object state
PRIVATE_KINDS = ("_probe", "_lease", "_req", "_drain")


class MirrorStaleError(RuntimeError):
    """A read through the mirror exceeded its advertised staleness
    bound: the caller must NOT act on the cached state (a migration
    cutover retries / re-verifies against the source instead)."""

    def __init__(self, region: str, age_s: float, bound_s: float):
        super().__init__(
            f"mirror of region {region!r} is {age_s:.1f}s stale "
            f"(bound {bound_s:.1f}s)")
        self.region = region
        self.age_s = age_s
        self.bound_s = bound_s


class RegionMirror:
    """Async read mirror of one region's state server."""

    def __init__(self, name: str, url: str, token: str = "",
                 max_age_s: float = MIRROR_MAX_AGE_S,
                 now=time.monotonic):
        self.name = name
        self.url = url.rstrip("/")
        self.token = token
        self.max_age_s = float(max_age_s)
        self._now = now
        self.cluster = FakeCluster()
        self.applied_seq = 0
        self.applied_rv = 0
        self.epoch = ""
        self._snapshot_rv = 0
        self._fresh_ts: Optional[float] = None
        self._bootstrapped = False
        self.resyncs = 0
        self.delta_resyncs = 0
        self.refused_batches = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wire ----------------------------------------------------------

    def _get(self, path: str, timeout: float):
        from volcano_tpu_torch.server.replication import http_json
        return http_json("GET", f"{self.url}{path}", timeout=timeout,
                         token=self.token)

    def bootstrap(self) -> None:
        """Full re-sync: install the source's replica snapshot and
        resume the tail at its wal_seq horizon."""
        doc = self._get("/replica_snapshot", timeout=30.0)
        from volcano_tpu_torch.server.durability import decode_stores_into
        cluster = FakeCluster()
        decode_stores_into(cluster, doc.get("stores", {}))
        with self._lock:
            self.cluster = cluster
            self.applied_seq = int(doc.get("wal_seq", 0))
            self.applied_rv = int(doc.get("rv", 0))
            self._snapshot_rv = int(doc.get("rv", 0))
            self.epoch = doc.get("epoch", "")
            self._fresh_ts = self._now()
            self._bootstrapped = True
        self.resyncs += 1
        metrics.inc("federation_mirror_resyncs_total",
                    region=self.name)
        log.info("mirror[%s]: bootstrapped at seq=%d rv=%d",
                 self.name, self.applied_seq, self.applied_rv)

    def poll(self, timeout: float = 0.0) -> int:
        """One tail round: bootstrap if needed, fetch records past the
        applied seq, fold them in.  Returns the number of records
        applied; raises OSError on wire failure (the caller owns the
        retry — age_s keeps growing truthfully meanwhile)."""
        if not self._bootstrapped:
            self.bootstrap()
        resp = self._get(
            f"/wal?mirror=1&since_seq={self.applied_seq}"
            f"&timeout={timeout:g}", timeout=timeout + 10.0)
        if resp.get("resync"):
            # fell off the source's ship ring (compaction, a restart
            # emptying the volatile ring, a heal).  A same-lineage
            # mirror first tries the DELTA lane — the events since
            # its rv, O(churn missed) instead of O(store); the full
            # snapshot bootstrap is the fallback for true lineage
            # breaks (epoch base change / rv fell off the event ring)
            if self._delta_resync(resp):
                return 0
            self._bootstrapped = False
            self.bootstrap()
            return 0
        applied = self._apply(resp.get("records") or [])
        with self._lock:
            self._fresh_ts = self._now()
            self.epoch = resp.get("epoch", self.epoch)
        return applied

    def _same_lineage(self, epoch: str) -> bool:
        """Epochs are BASE.BOOT: the BASE survives durable restarts
        (same store, new boot), so a delta catch-up across a restart
        is sound; a BASE change means a different history — only a
        full bootstrap is safe."""
        return bool(self.epoch) and bool(epoch) and \
            self.epoch.split(".")[0] == epoch.split(".")[0]

    def _delta_resync(self, ship_resp: dict) -> bool:
        """Incremental re-sync off the source's /watch delta lane:
        ask for the events since our applied rv (timeout=0 returns
        immediately), fold them in, and re-align the WAL cursor to
        the seq horizon the ship response advertised.  Returns False
        — caller falls back to the full snapshot bootstrap — when the
        lineage broke or our rv fell off the source's event ring."""
        if self.applied_rv <= 0 or \
                not self._same_lineage(ship_resp.get("epoch", "")):
            return False
        try:
            resp = self._get(f"/watch?since={self.applied_rv}"
                             f"&timeout=0", timeout=10.0)
        except (OSError, ValueError) as e:
            log.debug("mirror[%s]: delta resync probe failed: %s",
                      self.name, e)
            return False
        if resp.get("resync") or \
                not self._same_lineage(resp.get("epoch", "")):
            return False
        from volcano_tpu_torch.server.durability import apply_event_obj
        events = resp.get("events") or []
        rv = int(resp.get("rv", 0))
        with self._lock:
            for ev in events:
                apply_event_obj(self.cluster, ev.get("kind", ""),
                                codec.decode(ev["obj"]))
            self.applied_rv = max(self.applied_rv, rv)
            # bootstrap-equivalent dedup point: the next shipped
            # batches may overlap records already inside this delta —
            # the erv <= _snapshot_rv guard in _apply skips them
            self._snapshot_rv = self.applied_rv
            # seq horizon captured BEFORE the delta fetch: every
            # object record at or below it has rv <= the delta's rv
            # (WAL order == rv order), so nothing between the two
            # cursors can be missed
            self.applied_seq = int(ship_resp.get("last_seq",
                                                 self.applied_seq))
            self.epoch = resp.get("epoch", self.epoch)
            self._fresh_ts = self._now()
        self.resyncs += 1
        self.delta_resyncs += 1
        metrics.inc("federation_mirror_delta_resyncs_total",
                    region=self.name)
        log.info("mirror[%s]: delta resync applied %d events -> "
                 "rv=%d seq=%d", self.name, len(events),
                 self.applied_rv, self.applied_seq)
        return True

    def _apply(self, lines) -> int:
        """Fold one shipped batch: verify EVERY record's CRC and
        sequence first — a corrupt or gapped batch is refused
        wholesale and re-requested from the durable source (applying
        a prefix would desync this mirror from the seq stream)."""
        from volcano_tpu_torch.server.durability import (apply_event_obj,
                                                   parse_record)
        from volcano_tpu_torch.server.replication import \
            ShippedCorruptionError
        parsed = []
        seq = self.applied_seq
        for line in lines:
            rec, bad = parse_record(line.rstrip("\n"))
            if rec is None:
                self.refused_batches += 1
                metrics.inc("federation_mirror_refused_batches_total",
                            region=self.name)
                raise ShippedCorruptionError(
                    f"mirror[{self.name}]: record after seq {seq}: "
                    f"{bad}")
            q = int(rec.get("q", 0))
            if q <= seq:
                continue                    # overlap re-ship: skip
            if q != seq + 1:
                self.refused_batches += 1
                metrics.inc("federation_mirror_refused_batches_total",
                            region=self.name)
                raise ShippedCorruptionError(
                    f"mirror[{self.name}]: sequence gap {seq}->{q}")
            seq = q
            parsed.append((q, rec))
        if not parsed:
            return 0
        with self._lock:
            for q, rec in parsed:
                kind = rec.get("k", "")
                self.applied_seq = q
                if kind in PRIVATE_KINDS or kind.startswith("_"):
                    continue
                erv = int(rec.get("rv", 0))
                if erv and erv <= self._snapshot_rv:
                    continue    # already inside the bootstrap snapshot
                apply_event_obj(self.cluster, kind,
                                codec.decode(rec["o"]))
                if erv:
                    self.applied_rv = max(self.applied_rv, erv)
        metrics.inc("federation_mirror_records_total",
                    region=self.name, value=float(len(parsed)))
        return len(parsed)

    # -- staleness contract --------------------------------------------

    def age_s(self) -> float:
        """Seconds since the mirror last PROVED itself current (a
        successful poll — empty batches count: they carry the source's
        horizon).  Infinite before the first bootstrap."""
        with self._lock:
            if self._fresh_ts is None:
                return float("inf")
            return max(0.0, self._now() - self._fresh_ts)

    def read_checked(self, max_age_s: Optional[float] = None
                     ) -> FakeCluster:
        """The mirror's store, IF within the staleness bound — the
        gate every cutover-critical read goes through."""
        bound = self.max_age_s if max_age_s is None else max_age_s
        age = self.age_s()
        if age > bound:
            raise MirrorStaleError(self.name, age, bound)
        return self.cluster

    def status(self) -> dict:
        age = self.age_s()
        return {"region": self.name, "url": self.url,
                "applied_seq": self.applied_seq,
                "applied_rv": self.applied_rv,
                "epoch": self.epoch,
                "age_s": (None if age == float("inf")
                          else round(age, 3)),
                # operator-facing alias of age_s: the value the router
                # exports as federation_mirror_staleness_seconds and
                # folds into the region registry (`vtpctl regions`)
                "staleness_s": (None if age == float("inf")
                                else round(age, 3)),
                "resyncs": self.resyncs,
                "delta_resyncs": self.delta_resyncs,
                "refused_batches": self.refused_batches}

    # -- background tail -----------------------------------------------

    def start(self, poll_s: float = MIRROR_POLL_S) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            from volcano_tpu_torch.federation.retry import backoff_delay
            from volcano_tpu_torch.server.replication import \
                ShippedCorruptionError
            failures = 0
            while not self._stop.is_set():
                try:
                    self.poll(timeout=poll_s)
                    failures = 0
                except ShippedCorruptionError as e:
                    # refuse-and-re-request: the durable source serves
                    # the same records again, clean — but a source
                    # that KEEPS shipping corrupt batches backs off
                    # like any other failure
                    failures += 1
                    log.warning("%s (re-requesting)", e)
                    self._stop.wait(backoff_delay(
                        failures, f"mirror:{self.name}",
                        base=0.2, cap=5.0))
                except (OSError, ValueError) as e:
                    # the shared federation backoff policy (capped
                    # exponential, deterministic jitter) — age_s keeps
                    # growing truthfully while the source is away
                    failures += 1
                    delay = backoff_delay(
                        failures, f"mirror:{self.name}",
                        base=0.2, cap=5.0)
                    log.debug("mirror[%s]: poll failed: %s (retry "
                              "in %.1fs)", self.name, e, delay)
                    self._stop.wait(delay)

        self._thread = threading.Thread(
            target=_loop, name=f"mirror-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

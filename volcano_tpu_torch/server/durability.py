"""Crash-safe persistence for the state server: WAL + snapshots.

The authoritative store used to be an in-memory FakeCluster whose only
durability was a pickle written on graceful shutdown — a SIGKILL/OOM
lost every acked bind, podgroup phase, quarantine TTL and lease, and
restarted the event log so every mirror's delta resync silently
desynced.  The reference keeps all truth behind an apiserver/etcd that
journals before acking; this module gives volcano-tpu the same
contract (docs/design/durability.md):

  * every store mutation appends ONE record to a write-ahead log and
    is fsync'd before the HTTP ack (group commit: concurrent handler
    threads share one fsync barrier, so a 256-bind burst pays ~1
    fsync, not 256);
  * a periodic snapshot (write-temp + atomic rename + dir fsync)
    compacts the log: snapshot = full store dump + last rv + epoch;
    WAL segments wholly covered by a durable snapshot are deleted;
  * boot replays snapshot-then-WAL-tail, resumes the rv counter
    monotonically, reseeds the watch event ring from the tail, and
    bumps the boot half of the epoch ("BASE.BOOT") so mirrors KNOW a
    restart happened — same BASE means the history is WAL-continuous
    and a delta resync across the restart is exact; a different BASE
    (fresh dir, legacy pickle boot) forces a full re-list.

Record format — one line per record, self-delimiting and
self-verifying:

    crc32hex {"q": seq, "rv": N, "k": kind, "o": <codec payload>}

The 8-hex-char CRC32 covers the JSON body; ``q`` is a per-store
monotonic sequence number.  Together they close the two gray-failure
holes a bare JSON-lines journal has: a bit-flipped record that still
PARSES as JSON (replayed silently before; now a CRC mismatch), and a
duplicated or gapped record stream after an operator copy-restore
(now detected by ``q``).  Replay policy (docs/design/chaos.md):

  * torn FINAL record of the FINAL segment — a crash mid-append —
    is dropped quietly, as before;
  * corruption anywhere else (CRC mismatch, unparseable line,
    sequence gap) REFUSES TO BOOT with ``WALCorruptionError`` — a
    silent partial replay is how acked state quietly vanishes; the
    operator accepts the loss explicitly with ``--wal-force-truncate``
    which cuts the log at the corrupt record and discards the rest;
  * duplicated records (``q`` already applied) are skipped idempotently
    — a copy-restored segment replays to the same state.

Record kinds besides store events (only those carry rv — they are the
watch stream; private records replay in file order):

    {"k": "_lease", "o": {name, holder, expires_wall, term}} lease CAS
    {"k": "_fence", "o": {"name":.., "term":..}}       fence floor raise
    {"k": "_drain", "o": {"target": key}}              command drain
    {"k": "_req",  "o": {"id":..,"code":..,"resp":..}} idempotency key
    {"k": "_probe"}                                    heal probe

Leases persist wall-clock expiry and are rebased onto the monotonic
clock at boot, so a restarted server refuses a second leader inside an
old holder's TTL while a wall-clock jump can never mass-expire (or
immortalize) live leases.

Gray-failure degrade (the fsyncgate lesson): an ENOSPC on append or
an EIO from fsync POISONS the store for writes — fsync is never
retried (a failed fsync may clear the kernel's dirty-page error bit,
so a retry can falsely succeed over lost data).  The server degrades
to READ-ONLY (writes 503 + Retry-After, reads and leases still
served) instead of acking un-durable state, and heals by rotating to
a fresh segment, probing it with a real fsync, and writing a full
snapshot that recaptures the in-memory state wholesale — rv stays
monotonic across the whole episode.  File ops route through a
``faults.VFS`` seam so the chaos engine can inject exactly these
failures deterministically.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
import uuid
import zlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

log = logging.getLogger(__name__)

SNAPSHOT_FILE = "snapshot.json"
EPOCH_FILE = "epoch.json"
WAL_PREFIX = "wal-"
SNAPSHOT_FORMAT = "volcano-tpu-snapshot-v1"
# compaction thresholds: snapshot once the live WAL holds this many
# records or bytes (whichever first) — bounds both replay time and
# disk growth without paying a full store dump per mutation
SNAPSHOT_EVERY_RECORDS = 20_000
SNAPSHOT_EVERY_BYTES = 64 * 1024 * 1024
# replayed idempotency keys retained (snapshot + memory): a retried
# mutation whose first attempt committed before a crash must find its
# recorded response, not double-apply
REQ_CACHE = 2048
# fsync'd records kept in memory for WAL shipping (server/replication
# .py): a follower inside the ring tails in O(new records); one that
# fell off (or a fresh boot — the ring is volatile) bootstraps from
# the replica snapshot instead
SHIP_RING = 50_000


class WALCorruptionError(RuntimeError):
    """Mid-WAL corruption found at boot: the log cannot be replayed
    without silently dropping acked state.  Refuse to start; the
    operator accepts the loss explicitly with --wal-force-truncate."""

    def __init__(self, path: str, lineno: int, reason: str):
        super().__init__(
            f"WAL {path} corrupt at record {lineno} ({reason}); "
            "refusing to boot — a partial replay would silently drop "
            "every later acked write.  Restore the segment from a "
            "copy, or re-run with --wal-force-truncate to cut the log "
            "here and accept the data loss.")
        self.path = path
        self.lineno = lineno
        self.reason = reason


class ReadOnlyError(RuntimeError):
    """The store is poisoned for writes (failed fsync / full disk):
    nothing can be made durable, so nothing may be acked."""

    def __init__(self, reason: str):
        super().__init__(f"store is read-only: {reason}")
        self.reason = reason


class Recovery(NamedTuple):
    cluster: Optional[object]      # FakeCluster, or None (nothing on disk)
    rv: int                        # resume point for the event counter
    events: List[Tuple[int, str, object]]   # ring tail [(rv, kind, payload)]
    leases: Dict[str, Tuple[str, float]]    # name -> (holder, expires_wall)
    req_cache: "Dict[str, Tuple[int, object]]"  # req id -> (code, payload)
    epoch: str                     # bumped incarnation id "BASE.BOOT"
    replay_records: int
    replay_seconds: float
    # per-name MONOTONIC lease term counters (fencing tokens): survive
    # lease expiry/release — a term, once issued, is never reissued,
    # even across a reboot (or a deposed holder could fence as current)
    lease_terms: Dict[str, int] = {}
    # per-name fence floors: the highest term whose writes were ever
    # accepted — a recovering plane must keep refusing staler terms
    fences: Dict[str, int] = {}


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:            # platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, doc: dict) -> None:
    """write-temp + fsync + atomic rename + dir fsync — the one
    snapshot writer every save path routes through (including the
    legacy --state graceful save), so a crash mid-save can never
    leave a torn file where the last good state was."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")


def frame_record(rec: dict, seq: int) -> str:
    """One WAL line: crc32hex SP json-body NL.  The CRC covers the
    body bytes; the body carries the sequence number."""
    body = json.dumps(dict(rec, q=seq), separators=(",", ":"))
    return f"{zlib.crc32(body.encode('utf-8')) & 0xffffffff:08x} {body}\n"


def parse_record(line: str) -> Tuple[Optional[dict], str]:
    """(record, "") on success, (None, reason) on a bad line.
    Legacy lines (bare JSON, pre-CRC vintage) still load — they just
    can't prove their own integrity."""
    line = line.strip()
    if not line:
        return None, "blank"
    if line.startswith("{"):
        try:
            return json.loads(line), ""
        except ValueError:
            return None, "unparseable"
    crc_hex, _, body = line.partition(" ")
    if len(crc_hex) != 8 or not body:
        return None, "unframed"
    try:
        want = int(crc_hex, 16)
    except ValueError:
        return None, "unframed"
    if zlib.crc32(body.encode("utf-8")) & 0xffffffff != want:
        return None, "crc-mismatch"
    try:
        return json.loads(body), ""
    except ValueError:
        return None, "unparseable"


def decode_stores_into(cluster, stores: dict) -> None:
    """Fold an encoded snapshot `stores` dict (the /snapshot payload
    shape) into a FakeCluster's attribute stores."""
    from volcano_tpu_torch.api import codec
    from volcano_tpu_torch.cache.kinds import KINDS
    for kind, spec in KINDS.items():
        store = {k: codec.decode(enc)
                 for k, enc in stores.get(kind, {}).items()}
        if store or not getattr(cluster, spec.attr, None):
            # merge over construction defaults (e.g. the default
            # queue) only when the snapshot actually carried the kind
            getattr(cluster, spec.attr).update(store)
    cmds = codec.decode(stores.get("_commands", [])) or []
    cluster.commands = list(cmds)


def apply_event(cluster, kind: str, payload) -> None:
    """Replay ONE WAL store event onto the authoritative store —
    the server-side twin of RemoteCluster._apply_batch: no admission
    (it already ran before the event was logged), no watchers (none
    are attached at boot)."""
    from volcano_tpu_torch.api import codec
    apply_event_obj(cluster, kind, codec.decode(payload))


def apply_event_obj(cluster, kind: str, obj) -> None:
    """apply_event with the payload already decoded — the follower
    apply path decodes once and shares the object with its own
    bookkeeping (chip maps, watch ring)."""
    from volcano_tpu_torch.cache.kinds import KINDS
    deleted = kind.endswith("_deleted")
    base = kind[:-len("_deleted")] if deleted else kind
    spec = KINDS.get(base)
    if spec is not None:
        key = obj["key"] if spec.key_of is None else spec.key_of(obj)
        store = getattr(cluster, spec.attr)
        if deleted:
            store.pop(key, None)
        else:
            store[key] = obj if spec.key_of else obj["obj"]
    elif base == "command":
        cluster.commands.append(obj)
    # unknown kinds (a future version's events) replay as no-ops: the
    # snapshot that follows them will carry whatever they meant


def load_cluster_file(path: str):
    """Load a cluster state file in EITHER format: the legacy pickle
    or the snapshot JSON the graceful save now writes (--state stays
    working as an alias across the format change).  Returns a
    FakeCluster with no admission chain attached."""
    import pickle
    with open(path, "rb") as f:
        head = f.read(1)
        f.seek(0)
        if head != b"{":
            return pickle.load(f)
        doc = json.load(io.TextIOWrapper(f, encoding="utf-8"))
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    cluster = FakeCluster()
    decode_stores_into(cluster, doc.get("stores", {}))
    return cluster


class DurableStore:
    """Owns the WAL segments + snapshot of one state-server data dir."""

    def __init__(self, data_dir: str,
                 snapshot_every_records: int = SNAPSHOT_EVERY_RECORDS,
                 snapshot_every_bytes: int = SNAPSHOT_EVERY_BYTES,
                 vfs=None, force_truncate: bool = False):
        from volcano_tpu_torch import faults
        self.dir = os.path.abspath(data_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.snapshot_every_records = snapshot_every_records
        self.snapshot_every_bytes = snapshot_every_bytes
        self.vfs = vfs if vfs is not None else faults.VFS()
        self.force_truncate = force_truncate
        self._lock = threading.Lock()     # file handle + counters
        # serializes whole snapshot() sequences: the background
        # compactor and the graceful-save path must never interleave
        # rotate/capture/rename/delete (a slower older capture could
        # overwrite a newer snapshot AFTER the newer call deleted the
        # WAL segments covering the difference)
        self._snap_lock = threading.Lock()
        self._file: Optional[io.TextIOBase] = None
        self._seg_seq = 0
        self._seq = 0                     # last record sequence written
        self._appended = 0                # records since last fsync mark
        self._synced_marker = 0
        self._tail_rv = 0                 # last store-event rv appended
        self.synced_rv = 0                # last store-event rv fsync'd
        self.synced_seq = 0               # last record seq fsync'd
        # shipping ring: (seq, line) of recent records, served to
        # follower replicas up to the fsync horizon (ship_since)
        import collections
        self._ship: "collections.deque" = collections.deque(
            maxlen=SHIP_RING)
        self.wal_records = 0              # records in live segments
        self.wal_bytes = 0
        self.snapshot_rv = 0
        self.snapshot_at = 0.0            # wall time of last snapshot
        self.last_fsync_s = 0.0
        self.replay_records = 0
        self.replay_seconds = 0.0
        self.recovery: Optional[Recovery] = None
        # read-only poison: set by the FIRST append/fsync failure,
        # cleared only by a successful heal().  While set, appends are
        # dropped (counted) and commit() raises ReadOnlyError — the
        # server above must 503 writes instead of acking them.
        self.poisoned = ""

    # -- boot ----------------------------------------------------------

    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith(WAL_PREFIX)
                           and n.endswith(".log"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _bump_epoch(self, continuous: bool) -> str:
        """Read/advance the incarnation id.  BASE survives as long as
        the WAL history is continuous (mirrors may delta-resync across
        the restart); a dir with no durable state mints a fresh BASE
        (mirrors must full re-list — their rv space is meaningless
        here)."""
        path = os.path.join(self.dir, EPOCH_FILE)
        base, boot = "", 0
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            base, boot = doc.get("base", ""), int(doc.get("boot", 0))
        except (OSError, ValueError):
            # vtplint: disable=except-pass (first boot or corrupt epoch doc: fall through to a fresh base below)
            pass
        if not base or not continuous:
            base = uuid.uuid4().hex[:12]
        boot += 1
        atomic_write_json(path, {"base": base, "boot": boot})
        return f"{base}.{boot}"

    @staticmethod
    def _scan_segment(path: str) -> List[Tuple[int, int, bytes, bool]]:
        """[(lineno, byte_offset, raw_line, ended_with_newline)] —
        offsets let force-truncate cut the file at the exact corrupt
        record."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            log.exception("WAL segment %s unreadable", path)
            return []
        out = []
        off = 0
        lineno = 0
        for chunk in raw.split(b"\n"):
            complete = off + len(chunk) < len(raw)   # had its newline
            if chunk.strip():
                lineno += 1
                out.append((lineno, off, chunk, complete))
            off += len(chunk) + 1
        return out

    def _handle_corruption(self, path: str, lineno: int, offset: int,
                           reason: str) -> None:
        """Mid-WAL corruption: refuse to boot, or — with the explicit
        operator override — truncate the log at the corrupt record
        (and drop every later segment) so the surviving prefix is the
        whole story."""
        from volcano_tpu_torch import metrics
        if not self.force_truncate:
            raise WALCorruptionError(path, lineno, reason)
        dropped_bytes = os.path.getsize(path) - offset
        with open(path, "r+b") as f:
            f.truncate(offset)
        later = [s for s in self._segments() if s > path]
        for seg in later:
            try:
                os.remove(seg)
            except OSError:
                log.warning("could not remove post-corruption WAL %s",
                            seg)
        metrics.inc("server_wal_dropped_records_total",
                    reason="force-truncate")
        log.error("WAL %s corrupt at record %d (%s): "
                  "--wal-force-truncate cut %d bytes here and dropped "
                  "%d later segment(s) — ACKED STATE MAY BE LOST",
                  path, lineno, reason, dropped_bytes, len(later))

    def recover(self, event_ring: int = 100_000) -> Recovery:
        """Snapshot + WAL-tail replay; opens a fresh live segment.
        Returns cluster=None when the dir held no durable state (the
        caller seeds it and writes the initial snapshot).

        Raises WALCorruptionError on mid-WAL corruption (CRC mismatch,
        unparseable record, sequence gap) unless force_truncate was
        set; only a torn final record of the final segment — the
        crash-mid-append shape — is dropped quietly."""
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.cache.fake_cluster import FakeCluster

        t0 = time.perf_counter()
        snap_path = os.path.join(self.dir, SNAPSHOT_FILE)
        doc = None
        if os.path.exists(snap_path):
            try:
                with open(snap_path, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                log.exception("snapshot %s unreadable; replaying WAL "
                              "from scratch", snap_path)
        segments = self._segments()
        had_state = doc is not None or bool(segments)

        cluster = None
        rv = 0
        last_seq = 0
        leases: Dict[str, Tuple[str, float]] = {}
        req_cache: Dict[str, Tuple[int, object]] = {}
        lease_terms: Dict[str, int] = {}
        fences: Dict[str, int] = {}
        if doc is not None:
            cluster = FakeCluster()
            decode_stores_into(cluster, doc.get("stores", {}))
            rv = int(doc.get("rv", 0))
            last_seq = int(doc.get("wal_seq", 0))
            for name, rec in (doc.get("leases") or {}).items():
                leases[name] = (rec["holder"], float(rec["expires_wall"]))
                if rec.get("term"):
                    lease_terms[name] = int(rec["term"])
            for name, t in (doc.get("lease_terms") or {}).items():
                lease_terms[name] = max(lease_terms.get(name, 0), int(t))
            for name, t in (doc.get("fences") or {}).items():
                fences[name] = max(fences.get(name, 0), int(t))
            for rec in (doc.get("req_cache") or []):
                req_cache[rec["id"]] = (int(rec["code"]), rec["resp"])
        self.snapshot_rv = rv

        import collections
        tail: collections.deque = collections.deque(maxlen=event_ring)
        replayed = 0
        duplicates = 0
        drained_cids: set = set()
        if segments and cluster is None:
            cluster = FakeCluster()
        stop_replay = False
        for si, seg in enumerate(segments):
            if stop_replay:
                break
            last_segment = si == len(segments) - 1
            entries = self._scan_segment(seg)
            for ei, (lineno, offset, raw, complete) in enumerate(entries):
                rec, bad = parse_record(
                    raw.decode("utf-8", errors="replace"))
                if rec is None:
                    if bad == "blank":
                        continue
                    if last_segment and ei == len(entries) - 1 \
                            and not complete:
                        # the ONE tolerated shape: the final record of
                        # the final segment, missing its newline — a
                        # crash tore the append mid-write, so nothing
                        # after it was acked.  A final record WITH its
                        # newline was a complete append: a bad CRC
                        # there is bit rot on (possibly acked) state,
                        # which must refuse like any other corruption.
                        log.info("WAL %s torn tail at record %d "
                                 "(crash mid-append, %s); dropped",
                                 seg, lineno, bad)
                        break
                    self._handle_corruption(seg, lineno, offset, bad)
                    stop_replay = True
                    break
                seq = rec.get("q")
                if seq is not None:
                    seq = int(seq)
                    if seq <= last_seq:
                        # copy-restored / rotated-then-snapshotted
                        # duplicate: replay is idempotent by skipping
                        duplicates += 1
                        continue
                    if seq > last_seq + 1 and (last_seq or seq > 1):
                        # records are MISSING mid-stream — replaying
                        # past the hole would apply later state onto
                        # a base that never existed.  last_seq == 0
                        # with a first record past q=1 is the same
                        # hole (a lost first segment / deleted
                        # snapshot), not a fresh history.
                        self._handle_corruption(
                            seg, lineno, offset,
                            f"sequence gap {last_seq}->{seq}")
                        stop_replay = True
                        break
                    last_seq = seq
                kind = rec.get("k")
                if kind == "_probe":
                    continue            # heal liveness marker, no state
                if kind == "_lease":
                    o = rec["o"]
                    if o.get("term"):
                        lease_terms[o["name"]] = max(
                            lease_terms.get(o["name"], 0),
                            int(o["term"]))
                    if o.get("holder"):
                        leases[o["name"]] = (o["holder"],
                                             float(o["expires_wall"]))
                    else:
                        leases.pop(o["name"], None)
                elif kind == "_fence":
                    o = rec["o"]
                    fences[o["name"]] = max(
                        fences.get(o["name"], 0), int(o.get("term", 0)))
                elif kind == "_drain":
                    # collected, applied AFTER the loop: a drained
                    # command's add event may appear on either side
                    # of this record in the file (the add's journal
                    # write races the drain's), and cid filtering is
                    # order-independent
                    drained_cids.update(rec["o"].get("cids") or [])
                elif kind == "_req":
                    o = rec["o"]
                    req_cache[o["id"]] = (int(o["code"]), o["resp"])
                    while len(req_cache) > REQ_CACHE:
                        req_cache.pop(next(iter(req_cache)))
                else:
                    erv = int(rec.get("rv", 0))
                    if erv <= self.snapshot_rv:
                        continue    # rotated-then-snapshotted duplicate
                    apply_event(cluster, kind, rec["o"])
                    rv = max(rv, erv)
                    tail.append((erv, kind, rec["o"]))
                replayed += 1
        if duplicates:
            metrics.inc("server_wal_dropped_records_total",
                        value=float(duplicates), reason="duplicate-seq")
            log.warning("WAL replay skipped %d duplicate record(s) "
                        "(copy-restored segment?)", duplicates)
        if drained_cids:
            cluster.commands = [
                c for c in cluster.commands
                if not (isinstance(c, dict)
                        and c.get("cid") in drained_cids)]
        # drop expired leases now so the boot doesn't resurrect stale
        # holders (live ones rebase onto the monotonic clock upstairs)
        # vtplint: disable=wall-clock (the DISK carries wall expiries by contract; live ones rebase onto monotonic at boot)
        now = time.time()
        leases = {n: (h, exp) for n, (h, exp) in leases.items()
                  if exp > now}

        self._seq = last_seq
        # everything replayed is durable; the ship ring starts empty
        # (a follower past this seq tails, an older one bootstraps)
        self.synced_seq = last_seq
        self.replay_records = replayed
        self.replay_seconds = time.perf_counter() - t0
        if had_state:
            metrics.observe("server_replay_seconds", self.replay_seconds)
            metrics.set_gauge("server_replay_records", replayed)
        epoch = self._bump_epoch(continuous=had_state)
        # everything replayed IS durable: the new incarnation's synced
        # horizon starts at the recovered rv
        self._tail_rv = self.synced_rv = rv
        self._open_new_segment()
        self.recovery = Recovery(cluster, rv, list(tail), leases,
                                 req_cache, epoch, replayed,
                                 self.replay_seconds,
                                 lease_terms=lease_terms, fences=fences)
        return self.recovery

    def _open_new_segment(self) -> None:
        with self._lock:
            self._open_segment_locked()

    def _open_segment_locked(self) -> None:
        if self._file is not None:
            self._file.close()
        self._seg_seq += 1
        existing = self._segments()
        if existing:
            last = os.path.basename(existing[-1])
            try:
                self._seg_seq = int(
                    last[len(WAL_PREFIX):-len(".log")]) + 1
            except ValueError:
                pass
        path = os.path.join(self.dir,
                            f"{WAL_PREFIX}{self._seg_seq:08d}.log")
        self._file = self.vfs.open_append(path)

    # -- hot path ------------------------------------------------------

    def _poison(self, reason: str) -> None:
        from volcano_tpu_torch import metrics
        if not self.poisoned:
            self.poisoned = reason
            metrics.set_gauge("server_readonly", 1.0)
            log.error("store POISONED for writes (%s): degrading to "
                      "read-only — writes 503 until heal() succeeds; "
                      "the failed fsync/append is NOT retried "
                      "(fsyncgate: a retried fsync can falsely "
                      "succeed over lost data)", reason)

    def append(self, rec: dict) -> None:
        """Buffer one record onto the live segment (no fsync here —
        commit() is the durability barrier the ack path calls).

        Never raises: a write failure (ENOSPC, injected torn write)
        poisons the store instead — the caller's commit() then fails
        the ack.  Poisoned appends are dropped and counted; the heal
        snapshot recaptures the in-memory state wholesale, so nothing
        acked is ever built on a dropped record."""
        from volcano_tpu_torch import metrics
        with self._lock:
            if self.poisoned:
                metrics.inc("server_wal_dropped_records_total",
                            reason="readonly")
                return
            seq = self._seq + 1
            line = frame_record(rec, seq)
            try:
                self.vfs.write(self._file, line)
            except OSError as e:
                self._poison(f"append:{getattr(e, 'strerror', e)}")
                metrics.inc("server_wal_dropped_records_total",
                            reason="append-error")
                return
            self._seq = seq
            self._appended += 1
            self.wal_records += 1
            self.wal_bytes += len(line)
            self._ship.append((seq, line))
            if "rv" in rec:
                self._tail_rv = max(self._tail_rv, rec["rv"])

    def append_event(self, rv: int, kind: str, payload) -> None:
        self.append({"rv": rv, "k": kind, "o": payload})

    def append_shipped(self, line: str, seq: int, rv: int) -> None:
        """Append one leader-framed WAL line verbatim (follower path):
        the record keeps the LEADER's sequence number, so a promoted
        follower's log is seq-continuous with the group history and
        its own recover()/shipping work unchanged.  The caller
        (StateServer.apply_shipped) has already CRC-verified the line
        and checked seq continuity against synced_seq.

        Raises ReadOnlyError when this replica's own disk is poisoned:
        a follower that cannot durably apply must NOT advance its
        position — its advertised lag grows truthfully instead."""
        if not line.endswith("\n"):
            line += "\n"
        with self._lock:
            if self.poisoned:
                raise ReadOnlyError(self.poisoned)
            try:
                self.vfs.write(self._file, line)
            except OSError as e:
                self._poison(f"append:{getattr(e, 'strerror', e)}")
                raise ReadOnlyError(self.poisoned) from None
            self._seq = seq
            self._appended += 1
            self.wal_records += 1
            self.wal_bytes += len(line)
            self._ship.append((seq, line))
            if rv:
                self._tail_rv = max(self._tail_rv, rv)

    def ship_since(self, since_seq: int, limit: int = 2048) -> dict:
        """Framed records with since_seq < seq <= synced_seq for a
        follower long-poll.  resync=True when the follower's position
        fell off the (volatile) ship ring or is ahead of this store's
        history — only a replica-snapshot bootstrap recovers."""
        import itertools
        with self._lock:
            synced = self.synced_seq
            if since_seq > synced:
                return {"records": [], "last_seq": synced,
                        "resync": True}
            earliest = self._ship[0][0] if self._ship else synced + 1
            if since_seq + 1 < earliest:
                return {"records": [], "last_seq": synced,
                        "resync": True}
            # ring seqs are contiguous: the suffix starts at a known
            # offset — never scan the whole (up to 50k) ring per poll
            start = max(0, since_seq - earliest + 1)
            records = []
            for seq, line in itertools.islice(self._ship, start,
                                              start + limit):
                if seq > synced:
                    break
                records.append(line)
            return {"records": records, "last_seq": synced,
                    "resync": False}

    def snapshot_gate(self):
        """The compaction lock as a context manager, for callers that
        must pin the LOCK HIERARCHY from outside: _snap_lock is the
        OUTERMOST lock (snapshot()/heal() hold it while capturing
        state under the server lock), so any path that reaches this
        store while already holding the server lock must take the
        gate FIRST.  install_replica_snapshot is that path — taking
        _snap_lock inside the server lock deadlocked against a
        concurrent compaction (found by analysis/lockaudit.py: the
        wal-compactor thread holds _snap_lock wanting the server
        lock for capture while the follower tail thread holds the
        server lock wanting _snap_lock)."""
        return self._snap_lock

    def reset_from_snapshot(self, doc: dict, epoch: str) -> dict:
        """Install a replica snapshot wholesale (follower bootstrap /
        epoch-term-mismatch full re-sync): local WAL segments are
        DISCARDED (the leader's history supersedes them), the doc
        lands as the local snapshot atomically, and the seq/rv
        counters jump to the leader's horizon.  Returns the doc.

        Caller MUST hold snapshot_gate() (the lock-hierarchy contract
        above); only the store's inner lock is taken here."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            for seg in self._segments():
                try:
                    os.remove(seg)
                except OSError:
                    log.warning("could not remove superseded WAL "
                                "%s", seg)
            doc = dict(doc)
            doc["format"] = SNAPSHOT_FORMAT
            # vtplint: disable=wall-clock (operator-facing snapshot stamp, never a deadline)
            doc["saved_at"] = time.time()
            atomic_write_json(
                os.path.join(self.dir, SNAPSHOT_FILE), doc)
            base, _, boot = epoch.rpartition(".")
            try:
                boot_n = int(boot)
            except ValueError:
                base, boot_n = epoch, 0
            atomic_write_json(os.path.join(self.dir, EPOCH_FILE),
                              {"base": base or epoch,
                               "boot": boot_n})
            self._seq = self.synced_seq = int(doc.get("wal_seq", 0))
            rv = int(doc.get("rv", 0))
            self._tail_rv = self.synced_rv = rv
            self.snapshot_rv = rv
            self.snapshot_at = doc["saved_at"]
            self._appended = self._synced_marker = 0
            self.wal_records = 0
            self.wal_bytes = 0
            self._ship.clear()
            self.poisoned = ""
            self._open_segment_locked()
        return doc

    def commit(self) -> int:
        """Make every appended record durable; returns the new synced
        rv horizon.  Group commit: the fsync that one thread pays
        covers every record appended before it, so concurrent callers
        mostly return on the marker check without syncing again.

        Raises ReadOnlyError when the store is (or just became)
        poisoned: a failed fsync is NEVER retried — the records it
        covered are in an unknown state, and only heal()'s fresh
        segment + full snapshot restores durability."""
        from volcano_tpu_torch import metrics
        with self._lock:
            if self.poisoned:
                raise ReadOnlyError(self.poisoned)
            target = self._appended
            if self._synced_marker >= target:
                return self.synced_rv
            t0 = time.perf_counter()
            try:
                self.vfs.fsync(self._file)
            except OSError as e:
                self._poison(f"fsync:{getattr(e, 'strerror', e)}")
                raise ReadOnlyError(self.poisoned) from None
            # marker/tail re-read under the SAME lock hold: anything
            # appended while we blocked in fsync hit the file before
            # this flush? no — but it will be covered by ITS caller's
            # commit; only what was appended at flush time is synced
            self._synced_marker = target
            self.synced_rv = self._tail_rv
            self.synced_seq = self._seq
            self.last_fsync_s = time.perf_counter() - t0
            metrics.observe("server_wal_fsync_seconds", self.last_fsync_s)
            return self.synced_rv

    def should_snapshot(self) -> bool:
        with self._lock:
            return (self.wal_records >= self.snapshot_every_records or
                    self.wal_bytes >= self.snapshot_every_bytes)

    # -- read-only degrade + heal --------------------------------------

    def heal(self, capture: Callable[[], dict]) -> bool:
        """Attempt to leave read-only mode.  Protocol:

          1. rotate to a FRESH segment (the poisoned file's contents
             are presumed lost — never fsync it again);
          2. probe the new segment with a real append + fsync through
             the same VFS seam (a still-sick disk fails here and we
             stay read-only);
          3. capture() + atomically write a FULL snapshot — the
             in-memory state (including mutations whose journal
             records were dropped while poisoned; none were acked)
             becomes durable wholesale;
          4. delete the frozen segments, clear the poison.

        Returns True when writable again; rv is untouched throughout,
        so the counter stays monotonic across the whole episode."""
        from volcano_tpu_torch import metrics
        with self._snap_lock:
            if not self.poisoned:
                return True
            with self._lock:
                try:
                    self._open_segment_locked()
                    seq = self._seq + 1
                    self.vfs.write(self._file, frame_record(
                        {"k": "_probe"}, seq))
                    self.vfs.fsync(self._file)
                    self._seq = seq
                except OSError as e:
                    log.info("heal probe failed (%s); staying "
                             "read-only", e)
                    return False
                frozen = [s for s in self._segments()
                          if s != self._file.name]
                self._appended = self._synced_marker = 0
                self.wal_records = 0
                self.wal_bytes = 0
                # the poisoned segments' records are presumed lost and
                # the heal snapshot recaptures state wholesale: a
                # follower mid-tail cannot prove continuity across the
                # episode, so clear the ship ring — its next poll
                # falls off and bootstraps from the heal snapshot
                self._ship.clear()
                self.synced_seq = self._seq
                # while poisoned, appends drop without consuming seq,
                # so the probe's is the horizon (same freeze-time rule
                # as snapshot()).  Stamp the snapshot one BELOW it:
                # the probe record itself stays in the live segment,
                # and a wal_seq equal to its q would make the next
                # boot flag it as a copy-restored duplicate — false
                # corruption noise on exactly the post-incident
                # forensics path.  At wal_seq = probe_seq - 1 the
                # probe replays in-sequence and is skipped by kind.
                probe_seq = self._seq
            try:
                doc = capture()
                doc["format"] = SNAPSHOT_FORMAT
                # vtplint: disable=wall-clock (operator-facing snapshot stamp, never a deadline)
                doc["saved_at"] = time.time()
                doc["wal_seq"] = probe_seq - 1
                atomic_write_json(os.path.join(self.dir, SNAPSHOT_FILE),
                                  doc)
            except OSError as e:
                log.info("heal snapshot failed (%s); staying "
                         "read-only", e)
                return False
            with self._lock:
                self.snapshot_rv = int(doc.get("rv", 0))
                self.snapshot_at = doc["saved_at"]
                # the snapshot covers every event up to its rv: the
                # durable horizon jumps there, releasing the events
                # that were stuck behind the poisoned WAL
                self._tail_rv = max(self._tail_rv, self.snapshot_rv)
                self.synced_rv = self._tail_rv
                was = self.poisoned
                self.poisoned = ""
            for seg in frozen:
                try:
                    os.remove(seg)
                except OSError:
                    log.warning("could not remove poisoned WAL %s", seg)
            metrics.set_gauge("server_readonly", 0.0)
            metrics.inc("server_snapshot_total")
            log.warning("store HEALED (was read-only: %s): fresh "
                        "segment probed, full snapshot at rv %d, "
                        "writable again", was, self.snapshot_rv)
            return True

    # -- compaction ----------------------------------------------------

    def snapshot(self, capture: Callable[[], dict]) -> dict:
        """Write a snapshot and compact the WAL.

        Order of operations is the crash-safety argument:
          1. rotate to a fresh segment (old ones frozen, still on disk)
          2. capture() the store state — at a rv >= everything in the
             frozen segments, because rotation happened first
          3. atomic-write the snapshot
          4. delete the frozen segments
        A crash after any step replays to the same state: old snapshot
        + all segments (1-3), or new snapshot + live segment with the
        pre-capture records skipped by their rv (after 3).

        The freeze (fsync old segment → rotate → reset the commit
        markers) happens under ONE continuous lock hold: an append
        sneaking in between the fsync and the marker reset would land
        un-fsync'd in the frozen segment while its commit() no-ops on
        the zeroed marker — an acked-but-volatile write, exactly what
        this module exists to forbid."""
        from volcano_tpu_torch import metrics
        with self._snap_lock:
            t0 = time.perf_counter()
            with self._lock:
                if self.poisoned:
                    # no compaction while read-only: heal() owns the
                    # recovery snapshot (fsyncing the poisoned file
                    # here would be exactly the forbidden retry)
                    raise ReadOnlyError(self.poisoned)
                try:
                    self.vfs.fsync(self._file)
                except OSError as e:
                    self._poison(f"fsync:{getattr(e, 'strerror', e)}")
                    raise ReadOnlyError(self.poisoned) from None
                self.synced_rv = self._tail_rv
                self.synced_seq = self._seq
                frozen = self._segments()
                self._open_segment_locked()
                self._appended = self._synced_marker = 0
                self.wal_records = 0
                self.wal_bytes = 0
                # seq horizon AT THE FREEZE, under the same lock hold:
                # everything <= frozen_seq is in the frozen segments
                # the capture() below covers.  Reading self._seq after
                # capture would fold in records appended to the NEW
                # live segment in the meantime — recovery would then
                # skip them as "covered" while the snapshot lacks
                # them: a silently lost acked write.
                frozen_seq = self._seq

            doc = capture()
            doc["format"] = SNAPSHOT_FORMAT
            # vtplint: disable=wall-clock (operator-facing snapshot stamp, never a deadline)
            doc["saved_at"] = time.time()
            doc["wal_seq"] = frozen_seq
            atomic_write_json(os.path.join(self.dir, SNAPSHOT_FILE),
                              doc)
            with self._lock:
                self.snapshot_rv = int(doc.get("rv", 0))
                self.snapshot_at = doc["saved_at"]
            for seg in frozen:
                try:
                    os.remove(seg)
                except OSError:
                    log.warning("could not remove compacted WAL %s",
                                seg)
            dt = time.perf_counter() - t0
        metrics.observe("server_snapshot_seconds", dt)
        metrics.inc("server_snapshot_total")
        metrics.set_gauge("server_snapshot_rv", self.snapshot_rv)
        return doc

    # -- status --------------------------------------------------------

    def status(self) -> dict:
        from volcano_tpu_torch import metrics
        with self._lock:
            st = {
                "dir": self.dir,
                "wal_records": self.wal_records,
                "wal_bytes": self.wal_bytes,
                "wal_seq": self._seq,
                "synced_rv": self.synced_rv,
                "snapshot_rv": self.snapshot_rv,
                # vtplint: disable=wall-clock (status display only; snapshot_at is a wall stamp)
                "snapshot_age_s": (round(time.time() - self.snapshot_at, 3)
                                   if self.snapshot_at else None),
                "last_fsync_s": round(self.last_fsync_s, 6),
                "replay_records": self.replay_records,
                "replay_seconds": round(self.replay_seconds, 4),
                "readonly": self.poisoned,
            }
        metrics.set_gauge("server_wal_records", st["wal_records"])
        metrics.set_gauge("server_wal_bytes", st["wal_bytes"])
        return st

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                if not self.poisoned:
                    try:
                        self.vfs.fsync(self._file)
                    except OSError as e:
                        self._poison(
                            f"fsync:{getattr(e, 'strerror', e)}")
                self._file.close()
                self._file = None

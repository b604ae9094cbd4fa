"""Process-pool sweep backend — long-lived snapshot MIRRORS in worker
OS processes (ROADMAP item 3: the GIL-bound thread pilot's successor).

The thread backend (actions/sweep.py) proved the batched
prepared-form sweep bit-identical to the serial dispatch, but CPython
threads share one interpreter lock: on a multi-core host the fan-out
serializes.  This module fans the same sweep across real OS processes
without paying the obvious tax — pickling a 100k-node snapshot per
sweep — by giving every worker a PERSISTENT mirror of the session
snapshot, kept current by three message kinds:

  full     the whole model (nodes/jobs/queues/priority classes/
           hypernodes/conf/cluster maps), shipped once per worker
           lifetime or whenever the generation chain breaks (worker
           restart, cache full rebuild, delta ring exhausted).
  delta    per-cycle changes keyed by the scheduler cache's existing
           event stream (cache.SnapshotDelta): only the rebuilt
           NodeInfo/JobInfo objects cross the boundary — on a steady
           fleet that is nothing at all.
  ops      the within-cycle mutation journal (Session.mirror_log):
           the owner's 5 state primitives replayed through the
           worker session's OWN primitives, so a sweep fanned out
           mid-cycle sees exactly the in-session view the owner does.

Staleness contract: every sweep request is stamped (generation,
ops-applied); a worker whose mirror does not match answers ``stale``
and the owner REFUSES the rows and re-sweeps those shards serially —
rows computed against the wrong world never merge.  A crashed worker
(SIGKILL, OOM) degrades the same way: its shards re-sweep serially,
the pool respawns it (counted in ``sweep_worker_restarts_total``) and
the newborn full-syncs on the next cycle.

Purity contract: nothing callable ever crosses the boundary.  ALL
sends funnel through :func:`post` → :func:`ship`, whose pickler
REFUSES functions/methods/lambdas/partials outright; workers resolve
the prepared PreFilter/PreScore plugin forms themselves, from shipped
data, via framework.open_mirror_session.  The vtplint rule
``process-ship-purity`` pins the funnel statically; the armed freeze
auditor compares per-worker mirror digests against the owner snapshot
every fan-out (mirror-divergence audit) at runtime.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import threading
import time
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics, trace

# owner -> worker cluster-map attributes plugins consult at session
# open (volumebinding, dra, numaaware, resourcequota, datalocality);
# shipped with every sync so mirror sessions resolve the same
# predicate state the owner session did
MIRROR_CLUSTER_ATTRS = (
    "pvs", "pvcs", "datasources", "numatopologies", "config_maps",
    "resource_slices", "resource_claims", "admin_namespaces",
)

REQ_TIMEOUT_S = 120.0      # per-worker sweep reply budget


class PicklePurityError(TypeError):
    """A callable tried to cross the process boundary."""


class _PurePickler(pickle.Pickler):
    """Data-only pickler for the ship seam: functions, methods,
    lambdas and partials are refused outright — worker-side behavior
    must come from worker-side resolution, never from shipped code."""

    def reducer_override(self, obj):
        import functools
        import types
        if isinstance(obj, (types.FunctionType, types.MethodType,
                            types.BuiltinFunctionType,
                            types.BuiltinMethodType,
                            functools.partial)):
            raise PicklePurityError(
                f"refusing to ship callable {obj!r} across the "
                f"process boundary (pickled-callback purity)")
        return NotImplemented


def ship(obj) -> bytes:
    """THE serialization seam: every cross-process payload is built
    here (vtplint: process-ship-purity pins all conn sends to
    :func:`post`, which calls this)."""
    buf = io.BytesIO()
    _PurePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def unship(data: bytes):
    return pickle.loads(data)


def post(conn, obj) -> int:
    """THE wire seam: every pipe send happens here or in post_bytes —
    nowhere else (vtplint rule process-ship-purity pins this
    statically).  Returns bytes shipped (the delta-bytes metric's
    source)."""
    return post_bytes(conn, ship(obj))


def post_bytes(conn, data: bytes) -> int:
    """Raw half of the wire seam for payloads shipped once and sent
    to several workers (the full-sync broadcast): *data* MUST come
    from :func:`ship`."""
    conn.send_bytes(data)
    return len(data)


# -- worker side -------------------------------------------------------

class MirrorCache:
    """The cache stub a mirror session sees: shipped read-only
    cluster maps, no-op mutation routes (workers only predicate and
    score — anything that would need these seams is an owner-side
    duty by contract)."""

    class _Cluster:
        def __init__(self, maps: dict):
            for attr in MIRROR_CLUSTER_ATTRS:
                setattr(self, attr, maps.get(attr, {}))

        def watch(self, fn):
            pass

        def unwatch(self, fn):
            pass

        def put_object(self, kind, obj, key=None):
            pass

    def __init__(self, maps: dict, scheduler_name: str):
        self.cluster = MirrorCache._Cluster(maps)
        self.scheduler_name = scheduler_name
        self.plugin_state: Dict[str, dict] = {}

    def record_event(self, obj_key, reason, message):
        pass


class _Mirror:
    """One worker's long-lived model + per-generation session."""

    def __init__(self):
        from volcano_tpu_torch.cache.cache import Snapshot
        self.snap = Snapshot()
        self.gen = -1
        self.ops = 0
        self.conf = None
        self.maps: dict = {}
        self.scheduler_name = "volcano-tpu"
        self.session = None

    def retire_session(self):
        if self.session is not None:
            from volcano_tpu_torch.framework.framework import \
                close_mirror_session
            close_mirror_session(self.session)
            self.session = None

    def apply_full(self, payload: dict) -> None:
        from volcano_tpu_torch.cache.cache import Snapshot
        self.retire_session()
        snap = Snapshot()
        snap.nodes = payload["nodes"]
        snap.jobs = payload["jobs"]
        snap.queues = payload["queues"]
        snap.priority_classes = payload["priority_classes"]
        snap.hypernodes = payload["hypernodes"]
        snap._total = payload["total"]
        snap.gen = payload["gen"]
        self.snap = snap
        self._common(payload)
        self.gen = payload["gen"]
        # a full payload is a point-in-time copy of LIVE session
        # state: it already embodies every journaled op up to
        # ops_base — replaying those would double-apply (a respawned
        # worker mid-cycle crash-looped on node.add_task KeyError)
        self.ops = payload.get("ops_base", 0)

    def apply_delta(self, payload: dict) -> bool:
        """Returns False (mirror marked stale) when the delta's base
        generation is not the mirror's — the owner finds out through
        the next sweep's stale reply and full-syncs."""
        if payload["from_gen"] != self.gen:
            self.gen = -1
            return False
        self.retire_session()
        snap = self.snap
        for name, ni in payload["nodes"].items():
            snap.nodes[name] = ni
        for key, job in payload["jobs"].items():
            snap.jobs[key] = job
        for key in payload["removed_jobs"]:
            snap.jobs.pop(key, None)
        snap.queues = payload["queues"]
        snap.priority_classes = payload["priority_classes"]
        if payload["hypernodes"] is not None:
            snap.hypernodes = payload["hypernodes"]
        snap._total = payload["total"]
        snap.gen = payload["gen"]
        self._common(payload)
        self.gen = payload["gen"]
        self.ops = 0
        return True

    def _common(self, payload: dict) -> None:
        self.conf = payload["conf"]
        self.maps = payload["maps"]
        self.scheduler_name = payload["scheduler_name"]

    def ensure_session(self):
        if self.session is None:
            from volcano_tpu_torch.framework.framework import \
                open_mirror_session
            self.session = open_mirror_session(
                MirrorCache(self.maps, self.scheduler_name),
                self.snap, self.conf)
        return self.session

    def replay(self, ops) -> None:
        """Apply the owner's mutation journal through this mirror
        session's OWN primitives: same code, same order, same state."""
        ssn = self.ensure_session()
        for op in ops:
            kind, job_uid, task_uid = op[0], op[1], op[2]
            job = ssn.jobs.get(job_uid)
            task = job.tasks.get(task_uid) if job is not None else None
            if task is None:
                # the owner mutated a job this mirror doesn't hold —
                # impossible while the sync protocol holds; poison the
                # mirror rather than sweep against a diverged world
                self.gen = -1
                return
            if kind == "alloc":
                ssn.allocate(task, ssn.nodes[op[3]])
            elif kind == "pipe":
                ssn.pipeline(task, ssn.nodes[op[3]])
            elif kind == "evict":
                ssn.evict(task)
            elif kind == "dealloc":
                ssn.deallocate(task)
            elif kind == "unevict":
                ssn.unevict(task, op[3])
            self.ops += 1


def snapshot_digest(nodes: dict, names=None) -> str:
    """Order-independent fingerprint of scheduling-relevant node
    state, comparable across the process boundary (the mirror-
    divergence audit): per-node idle/used/releasing resources, task
    census and readiness."""
    h = 0
    sha = hashlib.sha1
    items = ((n, nodes[n]) for n in names if n in nodes) \
        if names is not None else nodes.items()
    for name, ni in items:
        row = (name, sorted(ni.idle.res.items()),
               sorted(ni.used.res.items()),
               sorted(ni.releasing.res.items()),
               sorted(ni.tasks.keys()), ni.ready)
        h ^= int.from_bytes(sha(repr(row).encode()).digest()[:8],
                            "big")
    return format(h, "016x")


def serve_fd(fd: int, worker_id: int) -> None:
    """Worker entry: wrap the inherited socket fd and serve.  Workers
    are plain ``python -c`` subprocesses, NOT multiprocessing spawn
    children — no re-import of the parent's __main__, no fork of a
    threaded owner; volcano_tpu_torch imports fresh, audits arm from the
    inherited environment exactly as any process in the plane does
    and flush their own per-pid reports."""
    from multiprocessing.connection import Connection
    _worker_main(Connection(fd), worker_id)


def _worker_main(conn, worker_id: int) -> None:
    """Serve sync/sweep/digest requests until the pipe closes."""
    mirror = _Mirror()
    prepared: dict = {}        # task_spec -> (pred_fns, score_fns)
    while True:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            break
        # an undecodable stream dies loudly (the owner retires on
        # EOF immediately); anything that raises while HANDLING a
        # decoded message degrades instead — see the except below
        msg = unship(data)
        kind = msg[0]
        try:
            _worker_handle(conn, mirror, prepared, msg)
        except _WorkerExit:
            break
        except Exception:  # noqa: BLE001
            # a deterministic poison (a plugin raising in the mirror,
            # replay divergence, a malformed payload) must degrade
            # ONCE — not kill the worker into a respawn + full-sync
            # + same-request crash loop.  Poison the mirror, answer
            # stale so the owner re-sweeps serially and full-syncs
            # next cycle, and surface the traceback on stderr.
            import traceback
            traceback.print_exc()
            mirror.gen = -1
            try:
                mirror.retire_session()
            except Exception:  # noqa: BLE001
                mirror.session = None   # thaw failed: drop the wreck
            if kind in ("sweep", "digest", "ping") and len(msg) > 1:
                try:
                    post(conn, ("stale", msg[1], -1, -1))
                except OSError:
                    break
    try:
        conn.close()
    except OSError:
        # vtplint: disable=except-pass (worker teardown; the pipe may already be gone)
        pass


class _WorkerExit(Exception):
    """Internal: the owner asked this worker to exit."""


def _worker_handle(conn, mirror: "_Mirror", prepared: dict,
                   msg) -> None:
    from volcano_tpu_torch.actions import sweep as sweep_mod
    kind = msg[0]
    if kind == "exit":
        raise _WorkerExit
    elif kind == "full":
        mirror.apply_full(msg[1])
        prepared.clear()
    elif kind == "delta":
        mirror.apply_delta(msg[1])
        prepared.clear()
    elif kind == "ops":
        _, gen, start, ops = msg
        if gen != mirror.gen or start != mirror.ops:
            mirror.gen = -1          # journal gap: poison
        else:
            mirror.replay(ops)
    elif kind == "sweep":
        (_, req_id, gen, op_seq, job_uid, task_uid, spec,
         shards, need_class) = msg
        if gen != mirror.gen or op_seq != mirror.ops:
            post(conn, ("stale", req_id, mirror.gen, mirror.ops))
            return
        ssn = mirror.ensure_session()
        # the task is addressed BY REFERENCE into the mirror (the
        # sync protocol already shipped its job): re-shipping the
        # owner's task object would drag the whole job graph —
        # every sibling TaskInfo — across the pipe per request
        job = ssn.jobs.get(job_uid)
        task = job.tasks.get(task_uid) if job is not None else None
        if task is None or task.task_spec != spec:
            post(conn, ("stale", req_id, mirror.gen, mirror.ops))
            return
        forms = prepared.get(spec)
        if forms is None or forms[0] != (gen, op_seq):
            forms = ((gen, op_seq),
                     sweep_mod.prepared_fns(
                         ssn, "predicate", "predicatePrepare",
                         task),
                     sweep_mod.prepared_fns(
                         ssn, "nodeOrder", "nodeOrderPrepare",
                         task))
            prepared[spec] = forms
        _, pred_fns, score_fns = forms
        rows = []          # one (fits, fails) pair PER SHARD so
        nodes = mirror.snap.nodes   # the owner can merge in
        for shard in shards:        # global shard order
            shard_nodes = [nodes[n] for n in shard if n in nodes]
            f, e = sweep_mod.sweep_shard(
                task, shard_nodes, pred_fns, score_fns,
                need_class)
            rows.append(
                ([(n.name, score, cls) for n, score, cls in f],
                 [(n.name, st) for n, st in e]))
        post(conn, ("rows", req_id, gen, op_seq, rows))
    elif kind == "digest":
        _, req_id, names = msg
        post(conn, ("digest", req_id, mirror.gen, mirror.ops,
                    snapshot_digest(mirror.snap.nodes, names)))
    elif kind == "ping":
        post(conn, ("pong", msg[1], os.getpid(), mirror.gen,
                    mirror.ops))


# -- owner side --------------------------------------------------------

class _Worker:
    __slots__ = ("id", "proc", "conn", "gen", "ops")

    def __init__(self, wid, proc, conn):
        self.id = wid
        self.proc = proc
        self.conn = conn
        self.gen = -1
        self.ops = 0


class ProcSweepPool:
    """Owner handle: spawns/heals workers, keeps their mirrors in
    sync, fans sweep requests and merges the stamped rows."""

    def __init__(self, workers: int):
        self._next_id = 0
        self.workers: List[_Worker] = []
        self.restarts = 0
        self.stale_refusals = 0
        for _ in range(workers):
            self.workers.append(self._spawn())

    def _spawn(self) -> _Worker:
        import socket
        import subprocess
        import sys
        from multiprocessing.connection import Connection
        import volcano_tpu_torch
        wid = self._next_id
        # vtplint: disable=shared-cache-unkeyed (pool bookkeeping is confined to the session owner thread — every fan-out originates there; workers are separate processes)
        self._next_id += 1
        parent_sock, child_sock = socket.socketpair()
        child_fd = child_sock.fileno()
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(volcano_tpu_torch.__file__))))
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(volcano_tpu_torch.__file__)))
        extra = os.pathsep.join(p for p in (pkg_root, repo_root) if p)
        env["PYTHONPATH"] = extra + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "from volcano_tpu_torch.actions.procpool import serve_fd; "
             f"serve_fd({child_fd}, {wid})"],
            pass_fds=(child_fd,), env=env, close_fds=True)
        child_sock.close()
        return _Worker(wid, proc, Connection(parent_sock.detach()))

    def size(self) -> int:
        return len(self.workers)

    def grow(self, workers: int) -> None:
        """Add workers up to *workers* total.  Existing workers keep
        their mirrors — growth never abandons in-flight state (the
        thread pool's old grow path did; see sweep.sweep_pool)."""
        while len(self.workers) < workers:
            # vtplint: disable=shared-cache-unkeyed (pool bookkeeping on the session owner thread; growth never tears down live workers)
            self.workers.append(self._spawn())

    def _retire(self, w: _Worker, reason: str) -> None:
        """A worker failed (crash, pipe loss, timeout): respawn in
        place.  The newborn full-syncs on the next ensure_sync."""
        try:
            w.conn.close()
        except OSError:
            # vtplint: disable=except-pass (the pipe is already broken; respawn is the remedy)
            pass
        if w.proc.poll() is None:
            w.proc.kill()
        try:
            w.proc.wait(timeout=5)
        except Exception:  # noqa: BLE001
            # vtplint: disable=except-pass (kill already sent; a zombie is reaped by the next wait or interpreter exit)
            pass
        fresh = self._spawn()
        # vtplint: disable=shared-cache-unkeyed (pool bookkeeping on the session owner thread — retire/respawn happens inside the fan-out that observed the failure)
        self.workers[self.workers.index(w)] = fresh
        # vtplint: disable=shared-cache-unkeyed (owner-thread counter; the metrics registry sink is lock-guarded)
        self.restarts += 1
        metrics.inc("sweep_worker_restarts_total", reason=reason)

    # -- sync ----------------------------------------------------------

    def ensure_sync(self, ssn) -> None:
        """Bring every worker's mirror to (ssn.snapshot_gen, len(log))
        before a fan-out: per-cycle delta (or full) plus the unsent
        ops suffix.  Sends are pipelined — the pipe's ordering IS the
        barrier, and the staleness stamp catches anything that slips
        (a worker that restarted underneath us)."""
        with trace.span("delta_ship", kind="action"):
            self._ensure_sync(ssn)

    def _ensure_sync(self, ssn) -> None:
        gen = ssn.snapshot_gen
        log = ssn.mirror_log
        # payloads are pickled ONCE per sync pass and the bytes sent
        # to every worker that needs them (workers at the same
        # generation need identical deltas; re-pickling a 100k-node
        # payload per worker multiplied the owner's serialization
        # cost by the pool size)
        full_bytes: Optional[bytes] = None
        delta_bytes: Dict[int, Optional[bytes]] = {}
        ops_bytes: Dict[int, bytes] = {}
        for w in list(self.workers):
            try:
                if w.gen != gen:
                    payload_bytes = None
                    # deltas describe PRISTINE between-cycle state;
                    # once this session has journaled ops, its node/
                    # job objects are already mutated, so a catching-
                    # up worker must take the point-in-time full copy
                    # (delta + whole-journal replay double-applies on
                    # the shipped changed objects)
                    if w.gen >= 0 and not log:
                        if w.gen not in delta_bytes:
                            p = self._delta_payload(ssn, w.gen)
                            delta_bytes[w.gen] = (
                                ship(("delta", p))
                                if p is not None else None)
                        payload_bytes = delta_bytes[w.gen]
                    if payload_bytes is not None:
                        n = post_bytes(w.conn, payload_bytes)
                        metrics.inc("sweep_snapshot_delta_bytes_total",
                                    n, kind="delta")
                        w.ops = 0
                    else:
                        if full_bytes is None:
                            full_bytes = ship(
                                ("full", self._full_payload(ssn)))
                        n = post_bytes(w.conn, full_bytes)
                        metrics.inc("sweep_snapshot_delta_bytes_total",
                                    n, kind="full")
                        w.ops = len(log)
                    w.gen = gen
                if w.ops < len(log):
                    ob = ops_bytes.get(w.ops)
                    if ob is None:
                        ob = ops_bytes[w.ops] = ship(
                            ("ops", gen, w.ops, log[w.ops:]))
                    n = post_bytes(w.conn, ob)
                    metrics.inc("sweep_snapshot_delta_bytes_total",
                                n, kind="ops")
                    w.ops = len(log)
            except (BrokenPipeError, OSError):
                self._retire(w, "crash")

    def _common_payload(self, ssn) -> dict:
        cluster = getattr(ssn.cache, "cluster", None)
        maps = {}
        for attr in MIRROR_CLUSTER_ATTRS:
            m = getattr(cluster, attr, None)
            if m:
                maps[attr] = dict(m)
        return {
            "gen": ssn.snapshot_gen,
            "ops_base": len(ssn.mirror_log),
            "conf": ssn.conf,
            "maps": maps,
            "scheduler_name": getattr(ssn.cache, "scheduler_name",
                                      "volcano-tpu"),
            "queues": dict(ssn.queues),
            "priority_classes": dict(ssn.priority_classes),
            "total": ssn.total_resource,
        }

    def _full_payload(self, ssn) -> dict:
        payload = self._common_payload(ssn)
        payload["nodes"] = dict(ssn.nodes)
        payload["jobs"] = dict(ssn.jobs)
        payload["hypernodes"] = ssn.hypernodes
        return payload

    def _delta_payload(self, ssn, from_gen: int) -> Optional[dict]:
        delta_since = getattr(ssn.cache, "delta_since", None)
        if delta_since is None:
            return None
        if getattr(ssn.cache, "_gen", None) != ssn.snapshot_gen:
            # the cache snapshotted again since this session opened
            # (harness pattern): the ring composes to a world this
            # session isn't looking at — full-sync from session state
            return None
        composed = delta_since(from_gen)
        if composed is None:
            return None
        changed_nodes, changed_jobs, removed_jobs, hn_changed = composed
        payload = self._common_payload(ssn)
        payload["from_gen"] = from_gen
        payload["nodes"] = {n: ssn.nodes[n] for n in changed_nodes
                            if n in ssn.nodes}
        payload["jobs"] = {k: ssn.jobs[k] for k in changed_jobs
                           if k in ssn.jobs}
        payload["removed_jobs"] = sorted(removed_jobs)
        payload["hypernodes"] = ssn.hypernodes if hn_changed else None
        return payload

    # -- fan-out -------------------------------------------------------

    def sweep(self, ssn, task, shards: List[list], need_class: bool):
        """Fan *shards* (lists of NodeInfo) across the workers.
        Returns (per_shard, leftover): per_shard maps GLOBAL shard
        index -> ([(node_name, score, cls)], [(node_name, status)]);
        leftover lists (index, shard) pairs the caller must re-sweep
        serially and merge at their index (stale refusals / crashed
        workers — degradation, never wrong rows, never a different
        merge order than the serial walk)."""
        self.ensure_sync(ssn)
        with trace.span("sweep_fanout", kind="action"):
            return self._sweep_synced(ssn, task, shards, need_class)

    def _sweep_synced(self, ssn, task, shards: List[list],
                      need_class: bool):
        gen, op_seq = ssn.snapshot_gen, len(ssn.mirror_log)
        alive = [w for w in self.workers]
        if not alive:
            return {}, list(enumerate(shards))
        assignments: Dict[int, list] = {i: [] for i in
                                        range(len(alive))}
        for i, shard in enumerate(shards):
            assignments[i % len(alive)].append((i, shard))
        pending = []
        for i, w in enumerate(alive):
            mine = assignments[i]
            if not mine:
                continue
            names = [[n.name for n in shard] for _, shard in mine]
            req_id = id(w) ^ int(time.monotonic_ns() & 0xFFFFFFF)
            try:
                post(w.conn, ("sweep", req_id, gen, op_seq,
                              task.job, task.uid, task.task_spec,
                              names, need_class))
                pending.append((w, req_id, mine))
            except (BrokenPipeError, OSError):
                self._retire(w, "crash")
                pending.append((None, req_id, mine))
        # rows keyed by GLOBAL shard index so the caller's merge —
        # including serially re-swept leftovers — lands in exactly
        # the order the serial shard walk would have produced
        per_shard: Dict[int, tuple] = {}
        leftover: list = []
        for w, req_id, mine in pending:
            if w is None:
                leftover.extend(mine)
                continue
            reply = self._recv(w, req_id)
            if reply is None:
                leftover.extend(mine)
                continue
            stale = reply[0] == "stale" or reply[2] != gen \
                or reply[3] != op_seq
            if stale:
                # rows computed against the wrong world are refused
                # wholesale; a full sync heals the worker next cycle
                # vtplint: disable=shared-cache-unkeyed (owner-thread counter; fan-outs are serialized on the session owner thread)
                self.stale_refusals += 1
                metrics.inc("sweep_stale_refusals_total")
                w.gen = -1
                leftover.extend(mine)
                continue
            rows = reply[4]
            if len(rows) != len(mine):
                # a malformed reply never half-merges
                leftover.extend(mine)
                continue
            for (idx, _shard), pair in zip(mine, rows):
                per_shard[idx] = pair
        return per_shard, leftover

    def _recv(self, w: _Worker, req_id: int):
        """One stamped reply from *w*, or None after retiring it
        (crash/timeout).  Unmatched req-ids are discarded — they are
        replies to requests an earlier failure already wrote off."""
        deadline = time.monotonic() + REQ_TIMEOUT_S
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                self._retire(w, "timeout")
                return None
            try:
                if not w.conn.poll(budget):
                    self._retire(w, "timeout")
                    return None
                msg = unship(w.conn.recv_bytes())
            except (EOFError, OSError):
                self._retire(w, "crash")
                return None
            if msg[1] == req_id:
                return msg

    # -- mirror divergence audit ---------------------------------------

    def audit_mirrors(self, ssn, names=None) -> bool:
        """Armed-auditor check: ask every synced worker for a digest
        of its mirror and compare against the owner snapshot.  A
        mismatch is recorded as a ``mirror-divergence`` violation on
        the freeze auditor's report surface and poisons the worker
        (full re-sync).  Returns True when all mirrors matched."""
        from volcano_tpu_torch.analysis import freezeaudit
        self.ensure_sync(ssn)
        gen, op_seq = ssn.snapshot_gen, len(ssn.mirror_log)
        want = snapshot_digest(ssn.nodes, names)
        ok = True
        for w in list(self.workers):
            req_id = id(w) ^ 0x5A5A
            try:
                post(w.conn, ("digest", req_id, names))
            except (BrokenPipeError, OSError):
                self._retire(w, "crash")
                continue
            reply = self._recv(w, req_id)
            if reply is None:
                continue
            _, _, rgen, rops, digest = reply
            if rgen != gen or rops != op_seq:
                continue            # raced a restart: not divergence
            if digest != want:
                ok = False
                freezeaudit.record_boundary_violation(
                    "mirror-divergence",
                    ("mirror-divergence", w.id, gen, op_seq),
                    worker=w.id, gen=gen, ops=op_seq,
                    owner_digest=want, worker_digest=digest)
                w.gen = -1
        return ok

    def ping(self) -> List[tuple]:
        """(worker_id, pid, gen, ops) per worker — test/debug aid."""
        out = []
        for w in list(self.workers):
            req_id = id(w) ^ 0x9999
            try:
                post(w.conn, ("ping", req_id))
            except (BrokenPipeError, OSError):
                self._retire(w, "crash")
                continue
            reply = self._recv(w, req_id)
            if reply is not None:
                out.append((w.id,) + tuple(reply[2:]))
        return out

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                post(w.conn, ("exit",))
                w.conn.close()
            except OSError:
                # vtplint: disable=except-pass (already-dead worker; join below reaps it)
                pass
        for w in self.workers:
            try:
                w.proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                # vtplint: disable=except-pass (the kill below is the remedy for a wedged worker)
                pass
            if w.proc.poll() is None:
                w.proc.kill()
        # vtplint: disable=shared-cache-unkeyed (teardown on the owner thread after every fan-out joined)
        self.workers = []


# -- process-wide pool (mirrors sweep.sweep_pool's lifetime) -----------

_POOL: Optional[ProcSweepPool] = None
_POOL_LOCK = threading.Lock()


def pool(workers: int) -> ProcSweepPool:
    """Process-wide sweep pool, grown (never shrunk) to *workers*.
    Growth adds workers; it never tears the pool down, so existing
    mirrors and any in-flight fan-out survive a mid-session resize."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ProcSweepPool(workers)
        elif _POOL.size() < workers:
            _POOL.grow(workers)
        return _POOL


def shutdown() -> None:
    """Tear down the process-wide pool (tests / interpreter exit)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown()
            _POOL = None

"""Opt-in runtime snapshot-freeze + data-race auditor — the
``go test -race`` half of what vtplint's static ownership pass
(analysis/racecheck.py) proves, in the lockaudit.py mold.

Armed by ``VTP_RACE_AUDIT=1`` (installed from ``volcano_tpu_torch/__init__``
before any session exists) or ``install()`` from a test.  Three
mechanisms, one report:

  frozen-write     ``open_session`` deep-freezes the session snapshot:
                   NodeInfo/JobInfo/TaskInfo/SubJobInfo/QueueInfo
                   instances (plus their Resource accounting objects
                   and hot dicts) get ``__setattr__``/``__setitem__``
                   write barriers.  Until the session's FIRST
                   Statement commit, any write outside a designated
                   mutation seam is a violation; after the first
                   commit the single-threaded window closes and only
                   the two always-on conditions below keep firing —
                   a write from a thread other than the session
                   owner, or any write while a fan-out region is
                   active.
  seam-in-fanout   the designated seams (Session.allocate/pipeline/
                   evict/deallocate/unevict/set_job_pending_reason,
                   Statement.commit/rollback, JobInfo.record_fit_error)
                   are the ONLY sanctioned writers, and they are
                   single-threaded by contract: entering one while a
                   parallel sweep is in flight is itself a violation,
                   whatever it writes.
  unsync-pair      ThreadSanitizer-lite for tracked shared stores: a
                   ``TrackedDict`` records (thread, op, held-lock set,
                   site) per access — the held set comes from the lock
                   auditor's per-thread graph when it is armed — and
                   ``report()`` derives every cross-thread pair with a
                   write on one side and NO common lock between the
                   two held sets.  Armed processes track the stores
                   whose race waivers claim owner-thread CONFINEMENT
                   (``SpecCache.entries`` and the Session dispatch
                   memos, wired in ``maybe_freeze_session`` /
                   ``SpecCache.__init__``); see ``track()`` for why
                   the GIL-publish plugin memos are excluded.

Reports flush to ``VTP_RACE_AUDIT_OUT`` at 2Hz, at exit and on
SIGTERM (same contract as lockaudit: a SIGKILL'd chaos incarnation
still leaves its last report on disk); the chaos conductor's
``--race-audit`` merges them across the process plane.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional

ENV_FLAG = "VTP_RACE_AUDIT"
ENV_OUT = "VTP_RACE_AUDIT_OUT"

_ACTIVE = False
_PATCHED = False
_REG_LOCK = threading.Lock()
_TL = threading.local()

# id(obj) -> session uid that froze it
_FROZEN: Dict[int, str] = {}
# session uid -> {"owner": tid, "committed": bool, "objects": [ids]}
_SESSIONS: Dict[str, dict] = {}
_FANOUT = {"depth": 0, "owner": None}
_VIOLATIONS: List[dict] = []
_SEEN: set = set()
_TRACKS: Dict[str, list] = {}        # store name -> access rows
_COUNTS = {"frozen_objects": 0, "fanout_regions": 0, "sessions": 0}

_TRACK_CAP = 256                     # bounded per-store access log


def _stack(skip: int = 3) -> str:
    frames = traceback.extract_stack()[:-skip]
    keep = [f for f in frames
            if "freezeaudit" not in f.filename][-8:]
    return "".join(traceback.format_list(keep)).rstrip()


def _site(depth: int = 2) -> str:
    """file:line of the nearest caller frame outside this module."""
    try:
        frame = sys._getframe(depth)
        while frame is not None and \
                frame.f_code.co_filename.endswith("freezeaudit.py"):
            frame = frame.f_back
    except ValueError:
        return "?"
    if frame is None:
        return "?"
    return f"{os.path.basename(frame.f_code.co_filename)}:" \
           f"{frame.f_lineno}"


def _violation(kind: str, key, **fields) -> None:
    with _REG_LOCK:
        if key in _SEEN:
            return
        _SEEN.add(key)
        doc = {"kind": kind, "thread": threading.current_thread().name}
        doc.update(fields)
        _VIOLATIONS.append(doc)


def record_boundary_violation(kind: str, key, **fields) -> None:
    """Public entry for audits that live OUTSIDE this module but
    report through it — the process-pool's per-worker mirror
    divergence check (actions/procpool.py) records here so conductor
    runs and race_bench fail on exactly the same report surface as
    in-process freeze violations.  No-op when disarmed."""
    if not _ACTIVE:
        return
    _violation(kind, key, **fields)


def _held_names() -> frozenset:
    """The acquiring thread's held-lock names from the lock auditor
    (empty when it is not armed — pairs then need no common lock to
    fire, which is exactly the conservative reading)."""
    from volcano_tpu_torch.analysis import lockaudit
    if not lockaudit.enabled():
        return frozenset()
    return frozenset(h.name for h in lockaudit._held())


# -- seams ------------------------------------------------------------

class _Seam:
    """Context manager marking a designated mutation seam.  Reentrant
    per thread; entering one while a fan-out region is active is a
    violation (the seams are the single-threaded writers the parallel
    sweep must never overlap)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        depth = getattr(_TL, "seam", 0)
        _TL.seam = depth + 1
        if _ACTIVE and _FANOUT["depth"]:
            _violation(
                "seam-in-fanout",
                ("seam-in-fanout", self.name, _site(2)),
                seam=self.name, site=_site(2), stack=_stack())
        return self

    def __exit__(self, *exc):
        _TL.seam = getattr(_TL, "seam", 1) - 1
        return False


def in_seam() -> bool:
    return getattr(_TL, "seam", 0) > 0


# -- write barriers ---------------------------------------------------

def _check_write(obj, what: str, detail: str) -> None:
    if not _ACTIVE:
        return
    sid = _FROZEN.get(id(obj))
    if sid is None:
        return
    if in_seam():
        return        # seam legality is checked at seam entry
    sess = _SESSIONS.get(sid)
    if sess is None:
        return
    tid = threading.get_ident()
    if _FANOUT["depth"]:
        why = "written while a parallel sweep is in flight"
    elif tid != sess["owner"]:
        why = "written from a non-owner thread"
    elif not sess["committed"]:
        why = "written outside a mutation seam before the session's " \
              "first Statement commit"
    else:
        return
    site = _site()
    _violation(
        "frozen-write",
        ("frozen-write", type(obj).__name__, detail, site),
        object=type(obj).__name__, target=detail, op=what,
        session=sid, site=site, reason=why, stack=_stack())


def _guard_setattr(cls) -> None:
    orig = cls.__dict__.get("__setattr__", None) or cls.__setattr__
    if getattr(orig, "_vtp_freeze", False):
        return

    def guarded(self, name, value, _orig=orig):
        _check_write(self, "setattr", f"{type(self).__name__}.{name}")
        _orig(self, name, value)

    guarded._vtp_freeze = True
    guarded._vtp_orig = orig
    cls.__setattr__ = guarded


def _guard_method(cls, method: str) -> None:
    orig = cls.__dict__.get(method)
    if orig is None or getattr(orig, "_vtp_freeze", False):
        return

    def guarded(self, *a, _orig=orig, _m=method, **kw):
        _check_write(self, _m, f"{type(self).__name__}.{_m}()")
        return _orig(self, *a, **kw)

    guarded._vtp_freeze = True
    guarded._vtp_orig = orig
    setattr(cls, method, guarded)


class FrozenDict(dict):
    """dict with the freeze write barrier on every mutator — swapped
    in for the snapshot's hot dicts (ssn.nodes/jobs/queues,
    node.tasks, node.occupied_ports) while their session is frozen."""

    __slots__ = ("_vtp_name",)

    def __init__(self, data, name: str):
        super().__init__(data)
        self._vtp_name = name

    def __reduce__(self):
        # a pickled copy THAWS to a plain dict: the barrier guards
        # THIS process's snapshot objects, and the default dict-
        # subclass protocol would rebuild item-by-item through the
        # armed __setitem__ barrier on a half-constructed instance
        # (no _vtp_name yet) — which killed every process-pool mirror
        # worker that received a frozen owner's shipped payload.  The
        # worker freezes its OWN mirror session when armed.
        return (dict, (dict(self),))

    def _bar(self, op):
        _check_write(self, op, f"{self._vtp_name}[{op}]")

    def __setitem__(self, k, v):
        self._bar("__setitem__")
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._bar("__delitem__")
        super().__delitem__(k)

    def pop(self, *a, **kw):
        self._bar("pop")
        return super().pop(*a, **kw)

    def popitem(self):
        self._bar("popitem")
        return super().popitem()

    def clear(self):
        self._bar("clear")
        super().clear()

    def update(self, *a, **kw):
        self._bar("update")
        super().update(*a, **kw)

    def setdefault(self, *a, **kw):
        self._bar("setdefault")
        return super().setdefault(*a, **kw)


# -- cross-thread access tracking ------------------------------------

class TrackedDict(dict):
    """dict recording (thread, op, held-locks, site) per access, the
    raw material for unsync-pair detection.  Bounded and deduped by
    (thread, op, site) so hot read loops stay cheap."""

    __slots__ = ("_vtp_name", "_vtp_seen")

    def __init__(self, data, name: str):
        super().__init__(data)
        self._vtp_name = name
        self._vtp_seen = set()

    def _note(self, op: str):
        if not _ACTIVE:
            return
        tid = threading.get_ident()
        site = _site()
        key = (tid, op, site)
        if key in self._vtp_seen:
            return
        self._vtp_seen.add(key)
        with _REG_LOCK:
            rows = _TRACKS.setdefault(self._vtp_name, [])
            if len(rows) < _TRACK_CAP:
                rows.append({"tid": tid, "op": op, "site": site,
                             "held": _held_names(),
                             "stack": _stack()})

    def __getitem__(self, k):
        self._note("read")
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._note("read")
        return super().get(k, default)

    def __contains__(self, k):
        self._note("read")
        return super().__contains__(k)

    def items(self):
        self._note("read")
        return super().items()

    def values(self):
        self._note("read")
        return super().values()

    def __setitem__(self, k, v):
        self._note("write")
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._note("write")
        super().__delitem__(k)

    def pop(self, *a, **kw):
        self._note("write")
        return super().pop(*a, **kw)

    def update(self, *a, **kw):
        self._note("write")
        super().update(*a, **kw)

    def setdefault(self, *a, **kw):
        self._note("write")
        return super().setdefault(*a, **kw)

    def clear(self):
        self._note("write")
        super().clear()


def track(data: dict, name: str) -> TrackedDict:
    """Wrap a shared store for cross-thread pair detection.

    Production wiring targets the CONFINEMENT claims the static
    pass's waivers make — stores argued safe because only the session
    owner thread ever touches them (``SpecCache.entries``, the
    Session dispatch memos): any cross-thread access on one of these
    is a pair regardless of held locks, so the detector needs no
    lock-auditor fidelity to be sound there.  The plugin memo caches
    are deliberately NOT tracked: their waivers argue idempotent
    GIL-atomic publish — pool workers DO legitimately race those, and
    tracking them would fire on the benign-by-argument pattern the
    waiver inventory exists to document."""
    if isinstance(data, TrackedDict):
        return data
    return TrackedDict(data, name)


def _unsync_pairs() -> List[dict]:
    """Cross-thread (write, any) pairs on a tracked store whose two
    held-lock sets share nothing: with no common lock there is no
    ordering, and the pair is a data race under the right schedule."""
    out = []
    seen = set()
    with _REG_LOCK:
        snapshot = {name: list(rows) for name, rows in _TRACKS.items()}
    for name, rows in snapshot.items():
        for a in rows:
            if a["op"] != "write":
                continue
            for b in rows:
                if b is a or b["tid"] == a["tid"]:
                    continue
                if a["held"] & b["held"]:
                    continue
                key = (name,) + tuple(sorted((a["site"], b["site"])))
                if key in seen:
                    continue
                seen.add(key)
                out.append({
                    "kind": "unsync-pair", "store": name,
                    "write_site": a["site"], "other_site": b["site"],
                    "other_op": b["op"],
                    "write_stack": a["stack"],
                    "other_stack": b["stack"]})
    return out


# -- session freeze/thaw ---------------------------------------------

_SNAPSHOT_CLASSES = None


def _classes():
    global _SNAPSHOT_CLASSES
    if _SNAPSHOT_CLASSES is None:
        from volcano_tpu_torch.api.job_info import (JobInfo, SubJobInfo,
                                              TaskInfo)
        from volcano_tpu_torch.api.node_info import NodeInfo
        from volcano_tpu_torch.api.queue_info import QueueInfo
        from volcano_tpu_torch.api.resource import Resource
        _SNAPSHOT_CLASSES = (NodeInfo, JobInfo, TaskInfo, SubJobInfo,
                             QueueInfo, Resource)
    return _SNAPSHOT_CLASSES


def _ensure_patched() -> None:
    """Install the class-level barriers + seam wrappers (idempotent;
    deferred to first freeze so every class is importable)."""
    global _PATCHED
    if _PATCHED:
        return
    _PATCHED = True
    from volcano_tpu_torch.api.job_info import JobInfo
    from volcano_tpu_torch.api.resource import Resource
    from volcano_tpu_torch.framework.session import Session
    from volcano_tpu_torch.framework.statement import Statement
    nodeinfo, jobinfo, taskinfo, subjobinfo, queueinfo, _ = _classes()
    for cls in (nodeinfo, jobinfo, taskinfo, subjobinfo, queueinfo):
        _guard_setattr(cls)
    # Resource accounting objects mutate in place through these; the
    # frozen registry holds the node's idle/used/releasing/pipelined
    for m in ("add", "sub", "sub_unchecked"):
        _guard_method(Resource, m)
    # the designated mutation seams
    for cls, methods in (
            (Session, ("allocate", "pipeline", "evict", "deallocate",
                       "unevict", "set_job_pending_reason")),
            (Statement, ("commit", "rollback_to")),
            (JobInfo, ("record_fit_error", "set_job_fit_errors"))):
        for m in methods:
            orig = cls.__dict__.get(m)
            if orig is None or getattr(orig, "_vtp_seam", False):
                continue
            is_commit = cls is Statement and m == "commit"

            def seamed(self, *a, _orig=orig,
                       _name=f"{cls.__name__}.{m}",
                       _commit=is_commit, **kw):
                if _commit:
                    # the session's first commit closes the strict
                    # single-threaded freeze window
                    note_commit(self.ssn.uid)
                with _Seam(_name):
                    return _orig(self, *a, **kw)

            seamed._vtp_seam = True
            seamed._vtp_orig = orig
            setattr(cls, m, seamed)


def maybe_freeze_session(ssn) -> None:
    """Deep-freeze *ssn*'s snapshot (called at the end of
    open_session when the audit is armed: plugins have finished their
    on_session_open setup, the sweep phase begins)."""
    if not _ACTIVE:
        return
    _ensure_patched()
    uid = ssn.uid
    objects: List[int] = []
    register = objects.append

    # the snapshot maps themselves become barrier dicts (mutating the
    # node/job/queue SET mid-session is never legal); swapping the
    # hot per-object dicts happens BEFORE the ids are published to
    # the frozen registry, so none of this setup trips its own
    # barriers
    ssn.nodes = FrozenDict(ssn.nodes, "session.nodes")
    ssn.jobs = FrozenDict(ssn.jobs, "session.jobs")
    ssn.queues = FrozenDict(ssn.queues, "session.queues")
    for node in ssn.nodes.values():
        node.tasks = FrozenDict(node.tasks,
                                f"node[{node.name}].tasks")
        node.occupied_ports = FrozenDict(
            node.occupied_ports, f"node[{node.name}].ports")
        register(id(node))
        for res in (node.idle, node.used, node.releasing,
                    node.pipelined, node.oversubscription):
            register(id(res))
        register(id(node.tasks))
        register(id(node.occupied_ports))
    for job in ssn.jobs.values():
        register(id(job))
        for task in job.tasks.values():
            register(id(task))
        for sub in job.sub_jobs.values():
            register(id(sub))
    for queue in ssn.queues.values():
        register(id(queue))
    for m in (ssn.nodes, ssn.jobs, ssn.queues):
        register(id(m))
    # arm the TSan-lite half on the session's owner-confined stores
    # (see track()): the dispatch memos are resolved on this thread
    # before any fan-out — a pool worker reading one is the leak the
    # unsync-pair detector exists to catch
    ssn._enabled_cache = track(ssn._enabled_cache,
                               "session._enabled_cache")
    ssn._raw_cache = track(ssn._raw_cache, "session._raw_cache")
    with _REG_LOCK:
        _SESSIONS[uid] = {"owner": threading.get_ident(),
                          "committed": False, "objects": objects}
        for oid in objects:
            _FROZEN[oid] = uid
        _COUNTS["sessions"] += 1
        _COUNTS["frozen_objects"] += len(objects)


def note_commit(ssn_uid: str) -> None:
    """First Statement commit: the strict single-threaded window
    closes (cross-thread and in-fanout writes stay violations)."""
    if not _ACTIVE:
        return
    sess = _SESSIONS.get(ssn_uid)
    if sess is not None:
        sess["committed"] = True


def thaw_session(ssn) -> None:
    """Lift the freeze at close_session: the job updater and the
    cache's post-session bookkeeping mutate freely again."""
    if not _ACTIVE:
        return
    sess = _SESSIONS.pop(ssn.uid, None)
    if sess is None:
        return
    with _REG_LOCK:
        for oid in sess["objects"]:
            _FROZEN.pop(oid, None)


# -- fan-out regions --------------------------------------------------

def fanout_begin() -> None:
    """A parallel sweep is taking flight: between begin and end the
    snapshot is read-only for EVERY thread and seams are barred."""
    if not _ACTIVE:
        return
    _FANOUT["depth"] += 1
    _FANOUT["owner"] = threading.get_ident()
    _COUNTS["fanout_regions"] += 1


def fanout_end() -> None:
    if not _ACTIVE:
        return
    _FANOUT["depth"] = max(0, _FANOUT["depth"] - 1)


def fanout_active() -> bool:
    return _FANOUT["depth"] > 0


# -- lifecycle --------------------------------------------------------

def install() -> None:
    global _ACTIVE
    _ACTIVE = True


def uninstall() -> None:
    """Disarm recording.  Class patches stay installed (they no-op
    when inactive) — un-patching live classes mid-process would race
    the very code paths this module audits."""
    global _ACTIVE
    _ACTIVE = False


def enabled() -> bool:
    return _ACTIVE


def reset() -> None:
    with _REG_LOCK:
        _FROZEN.clear()
        _SESSIONS.clear()
        _VIOLATIONS.clear()
        _SEEN.clear()
        _TRACKS.clear()
        _FANOUT["depth"] = 0
        _FANOUT["owner"] = None
        for k in _COUNTS:
            _COUNTS[k] = 0


def report() -> dict:
    with _REG_LOCK:
        violations = list(_VIOLATIONS)
        counts = dict(_COUNTS)
        tracked = {name: len(rows) for name, rows in _TRACKS.items()}
    violations += _unsync_pairs()
    return {
        "pid": os.getpid(),
        "sessions_frozen": counts["sessions"],
        "objects_frozen": counts["frozen_objects"],
        "fanout_regions": counts["fanout_regions"],
        "tracked_stores": tracked,
        "violations": violations,
    }


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the report atomically; returns the path written."""
    out_dir = path or os.environ.get(ENV_OUT, "")
    if not out_dir:
        return None
    import json
    os.makedirs(out_dir, exist_ok=True)
    fpath = os.path.join(out_dir, f"raceaudit-{os.getpid()}.json")
    tmp = fpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report(), f, indent=1, default=str)
    os.replace(tmp, fpath)
    return fpath


def install_from_env() -> None:
    """Arm from VTP_RACE_AUDIT (called by volcano_tpu_torch/__init__).  With
    VTP_RACE_AUDIT_OUT set, the report flushes at exit AND at 2Hz
    from a daemon thread, so a SIGKILL'd chaos incarnation still
    reports; SIGTERM flushes once then chains to the previous
    disposition (same contract as lockaudit.install_from_env)."""
    if not os.environ.get(ENV_FLAG):
        return
    install()
    if not os.environ.get(ENV_OUT):
        return
    import atexit
    atexit.register(flush)
    import signal
    prev = signal.getsignal(signal.SIGTERM)

    def _flush_on_term(signum, frame):
        try:
            flush()
        except OSError:
            # vtplint: disable=except-pass (mid-shutdown best effort; the 2Hz flusher already wrote a near-final report)
            pass
        if callable(prev) and prev not in (signal.SIG_DFL,
                                           signal.SIG_IGN):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _flush_on_term)
    except ValueError:
        # vtplint: disable=except-pass (not the main thread: signal registration is impossible, the 2Hz flusher remains the fallback)
        pass

    def _flusher():
        import time
        while True:
            time.sleep(0.5)
            try:
                flush()
            except OSError:
                # vtplint: disable=except-pass (2Hz best-effort report flusher; the atexit flush is the authoritative write)
                pass

    threading.Thread(target=_flusher, name="raceaudit-flush",
                     daemon=True).start()

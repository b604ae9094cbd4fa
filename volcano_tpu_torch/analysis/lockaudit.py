"""Opt-in runtime lock-order auditor (the `faults.py` of deadlocks).

Before the scheduler cycle fans out across threads and processes
(ROADMAP item 3), the ~22 ``threading.Lock/RLock/Condition`` sites in
server/cache/scheduler need their acquisition ORDER mechanically
checked, not remembered.  When armed (``VTP_LOCK_AUDIT=1`` in the
environment, or ``install()`` from a test), lock construction inside
this repository is wrapped so that every acquisition records:

  * the held-set of the acquiring thread -> directed edges between
    lock SITES (locks are named by their creation site, so every
    ``FakeCluster._lock`` instance aggregates onto one node);
  * an ``inversion`` violation the moment two sites are observed in
    both orders (the two stacks are kept — that pair IS a potential
    deadlock under the right interleaving);
  * a ``self-deadlock`` violation when a non-reentrant Lock is
    re-acquired (blocking) by its owner;
  * ``unguarded-mutation`` violations from guarded shared stores
    (``guard_store``): a mutation observed while the owning lock is
    not held.  ``metrics`` registries and the state server's
    lease/req-cache/chip-guard maps opt in when the audit is armed.

``report()`` summarizes the graph (+ cycles of any length via DFS)
and the violations; under the chaos conductor every process flushes
its report to ``VTP_LOCK_AUDIT_OUT`` so ``--lock-audit`` runs can
assert an empty violation set across the whole process plane.

Same-site edges (two INSTANCES from one creation site acquired
nested, e.g. operations spanning the server's store and a mirror) are
reported informationally, not as violations: site-level aggregation
cannot distinguish a benign fixed instance order from a true peer
cycle, and this auditor's findings must be actionable, never noisy.

The audit only wraps locks created while armed from files inside this
repository — stdlib internals (logging, queues, Events created by
``threading`` itself) keep raw primitives.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "VTP_LOCK_AUDIT"
ENV_OUT = "VTP_LOCK_AUDIT_OUT"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_REAL = {"Lock": threading.Lock, "RLock": threading.RLock,
         "Condition": threading.Condition}
_ACTIVE = False
_INSTALLED = False
_REG_LOCK = _REAL["Lock"]()
_TL = threading.local()

# site name -> acquire count
_LOCKS: Dict[str, int] = {}
# (a, b) -> count: b acquired while a held
_EDGES: Dict[Tuple[str, str], int] = {}
_EDGE_STACKS: Dict[Tuple[str, str], str] = {}
_SAME_SITE: Dict[str, int] = {}
_VIOLATIONS: List[dict] = []
_SEEN_PAIRS: set = set()
_SEEN_MUTATIONS: set = set()


def _held() -> list:
    held = getattr(_TL, "held", None)
    if held is None:
        held = _TL.held = []
    return held


def _rlock_counts() -> dict:
    counts = getattr(_TL, "rlock_counts", None)
    if counts is None:
        counts = _TL.rlock_counts = {}
    return counts


def _stack(skip: int = 3) -> str:
    frames = traceback.extract_stack()[:-skip]
    keep = [f for f in frames if "lockaudit" not in f.filename][-8:]
    return "".join(traceback.format_list(keep)).rstrip()


def _record_acquire_intent(lock: "_AuditedBase",
                           blocking: bool) -> None:
    if not _ACTIVE:
        return
    held = _held()
    with _REG_LOCK:
        _LOCKS[lock.name] = _LOCKS.get(lock.name, 0) + 1
        for h in held:
            if h is lock:
                if not lock.reentrant and blocking:
                    _VIOLATIONS.append({
                        "kind": "self-deadlock", "lock": lock.name,
                        "stack": _stack()})
                continue
            if h.name == lock.name:
                _SAME_SITE[lock.name] = \
                    _SAME_SITE.get(lock.name, 0) + 1
                continue
            edge = (h.name, lock.name)
            _EDGES[edge] = _EDGES.get(edge, 0) + 1
            if edge not in _EDGE_STACKS:
                _EDGE_STACKS[edge] = _stack()
            rev = (lock.name, edge[0])
            pair = tuple(sorted((edge[0], edge[1])))
            if rev in _EDGES and pair not in _SEEN_PAIRS:
                _SEEN_PAIRS.add(pair)
                _VIOLATIONS.append({
                    "kind": "inversion",
                    "pair": list(pair),
                    "stack_forward": _EDGE_STACKS.get(rev, ""),
                    "stack_reverse": _EDGE_STACKS[edge]})


class _AuditedBase:
    reentrant = False

    def __init__(self, real, name: str):
        self._real = real
        self.name = name

    def __repr__(self):
        return f"<audited {type(self._real).__name__} {self.name}>"


class AuditedLock(_AuditedBase):
    """Wrapper over a non-reentrant lock with acquisition tracking."""

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _record_acquire_intent(self, blocking)
        got = self._real.acquire(blocking, timeout)
        if got:
            _held().append(self)
        return got

    def release(self):
        self._real.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def locked(self):
        return self._real.locked()

    def _is_owned(self):
        # given to threading.Condition so wait() never needs the
        # try-acquire probe (which would look like a self-deadlock)
        return any(h is self for h in _held())

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class AuditedRLock(_AuditedBase):
    reentrant = True

    def acquire(self, blocking: bool = True, timeout: float = -1):
        counts = _rlock_counts()
        if counts.get(id(self), 0) == 0:
            _record_acquire_intent(self, blocking)
        got = self._real.acquire(blocking, timeout)
        if got:
            n = counts.get(id(self), 0)
            counts[id(self)] = n + 1
            if n == 0:
                _held().append(self)
        return got

    def release(self):
        self._real.release()
        counts = _rlock_counts()
        n = counts.get(id(self), 1) - 1
        if n <= 0:
            counts.pop(id(self), None)
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        else:
            counts[id(self)] = n

    # the Condition protocol: full release for wait(), restore after
    def _release_save(self):
        state = self._real._release_save()
        count = _rlock_counts().pop(id(self), 0)
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        return (state, count)

    def _acquire_restore(self, saved):
        state, count = saved
        self._real._acquire_restore(state)
        if count:
            _rlock_counts()[id(self)] = count
            _held().append(self)

    def _is_owned(self):
        return _rlock_counts().get(id(self), 0) > 0

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def held_by_current(lock) -> bool:
    """Exact for audited locks; best-effort (is it held by ANYONE)
    for raw primitives created before the audit armed."""
    if isinstance(lock, _AuditedBase):
        return lock._is_owned()
    probe = getattr(lock, "_is_owned", None)
    if probe is not None:        # raw RLock
        try:
            return bool(probe())
        except Exception:  # noqa: BLE001 — foreign lock type
            return True
    locked = getattr(lock, "locked", None)
    return bool(locked()) if locked is not None else True


# -- construction patching -------------------------------------------

def _site(depth: int = 2) -> Optional[str]:
    """Creation-site name for the lock, or None when the caller is
    outside this repository (stdlib locks stay raw)."""
    import sys
    frame = sys._getframe(depth)
    fname = frame.f_code.co_filename
    if not fname.startswith(_REPO_ROOT) or \
            f"{os.sep}analysis{os.sep}" in fname:
        return None
    rel = os.path.relpath(fname, _REPO_ROOT)
    return f"{rel}:{frame.f_lineno}"


def _make_lock():
    name = _site()
    real = _REAL["Lock"]()
    return real if name is None else AuditedLock(real, name)


def _make_rlock():
    name = _site()
    real = _REAL["RLock"]()
    return real if name is None else AuditedRLock(real, name)


def _make_condition(lock=None):
    name = _site()
    if name is None:
        return _REAL["Condition"](lock)
    if lock is None:
        lock = AuditedRLock(_REAL["RLock"](), name)
    return _REAL["Condition"](lock)


def make_lock(name: str) -> AuditedLock:
    """Explicitly-named audited lock (tests, guards)."""
    return AuditedLock(_REAL["Lock"](), name)


def install() -> None:
    """Arm the audit: locks created from repo code are wrapped."""
    global _ACTIVE, _INSTALLED
    _ACTIVE = True
    if _INSTALLED:
        return
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    _INSTALLED = True


def uninstall() -> None:
    """Disarm: restore the raw constructors and stop recording.
    Already-wrapped locks keep working (bookkeeping only)."""
    global _ACTIVE, _INSTALLED
    _ACTIVE = False
    if _INSTALLED:
        threading.Lock = _REAL["Lock"]
        threading.RLock = _REAL["RLock"]
        threading.Condition = _REAL["Condition"]
        _INSTALLED = False


def enabled() -> bool:
    return _ACTIVE


def reset() -> None:
    with _REG_LOCK:
        _LOCKS.clear()
        _EDGES.clear()
        _EDGE_STACKS.clear()
        _SAME_SITE.clear()
        _VIOLATIONS.clear()
        _SEEN_PAIRS.clear()
        _SEEN_MUTATIONS.clear()


# -- guarded shared stores -------------------------------------------

def _mutation(store_name: str, op: str, lock) -> None:
    if not _ACTIVE or held_by_current(lock):
        return
    stack = _stack()
    key = (store_name, stack.splitlines()[-1] if stack else op)
    with _REG_LOCK:
        if key in _SEEN_MUTATIONS:
            return
        _SEEN_MUTATIONS.add(key)
        _VIOLATIONS.append({
            "kind": "unguarded-mutation", "store": store_name,
            "op": op, "stack": stack})


class GuardedDict(dict):
    """dict that records a violation when mutated without the owning
    lock held.  default_factory preserves defaultdict semantics (a
    defaulting READ inserts, so it counts as a mutation too)."""

    def __init__(self, data, lock, name, default_factory=None):
        super().__init__(data)
        self._vtp_lock = lock
        self._vtp_name = name
        self._vtp_factory = default_factory

    def __missing__(self, key):
        if self._vtp_factory is None:
            raise KeyError(key)
        _mutation(self._vtp_name, "__missing__", self._vtp_lock)
        value = self._vtp_factory()
        super().__setitem__(key, value)
        return value

    def __setitem__(self, key, value):
        _mutation(self._vtp_name, "__setitem__", self._vtp_lock)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        _mutation(self._vtp_name, "__delitem__", self._vtp_lock)
        super().__delitem__(key)

    def pop(self, *a, **kw):
        _mutation(self._vtp_name, "pop", self._vtp_lock)
        return super().pop(*a, **kw)

    def popitem(self):
        _mutation(self._vtp_name, "popitem", self._vtp_lock)
        return super().popitem()

    def clear(self):
        _mutation(self._vtp_name, "clear", self._vtp_lock)
        super().clear()

    def update(self, *a, **kw):
        _mutation(self._vtp_name, "update", self._vtp_lock)
        super().update(*a, **kw)

    def setdefault(self, *a, **kw):
        _mutation(self._vtp_name, "setdefault", self._vtp_lock)
        return super().setdefault(*a, **kw)


class GuardedOrderedDict(GuardedDict):
    def __init__(self, data, lock, name):
        # keep OrderedDict-only surface the server uses (move_to_end
        # emulated: plain dicts preserve insertion order, re-insert)
        super().__init__(data, lock, name)

    def move_to_end(self, key, last=True):
        _mutation(self._vtp_name, "move_to_end", self._vtp_lock)
        value = super(GuardedDict, self).pop(key)
        if last:
            dict.__setitem__(self, key, value)
        else:
            items = [(key, value)] + list(self.items())
            dict.clear(self)
            dict.update(self, items)

    def popitem(self, last=True):
        _mutation(self._vtp_name, "popitem", self._vtp_lock)
        key = next(reversed(self) if last else iter(self))
        return key, dict.pop(self, key)


def guard_store(container, lock, name):
    """Wrap a dict-like shared store so mutation without *lock* held
    is recorded.  Returns the wrapped store."""
    factory = getattr(container, "default_factory", None)
    import collections
    if isinstance(container, collections.OrderedDict):
        return GuardedOrderedDict(container, lock, name)
    return GuardedDict(container, lock, name,
                       default_factory=factory)


def maybe_guard_metrics(mod) -> None:
    """Arm the metrics registries (called by metrics.py at import
    when the audit env flag is set)."""
    if not _ACTIVE:
        return
    for attr in ("_observations", "_counters", "_gauges",
                 "_obs_totals"):
        setattr(mod, attr, guard_store(getattr(mod, attr),
                                       mod._lock, f"metrics.{attr}"))


def maybe_guard_server(state) -> None:
    """Arm the state server's lock-owned maps (called from
    StateServer.__init__ when the audit env flag is set)."""
    if not _ACTIVE:
        return
    state._leases = guard_store(state._leases, state._lock,
                                "state_server._leases")
    state._req_cache = guard_store(state._req_cache, state._lock,
                                   "state_server._req_cache")
    state._pod_chips = guard_store(state._pod_chips, state._lock,
                                   "state_server._pod_chips")
    state._chips_used = guard_store(state._chips_used, state._lock,
                                    "state_server._chips_used")


# -- reporting -------------------------------------------------------

def _cycles(edges) -> List[List[str]]:
    """Distinct simple cycles (length >= 2) in the site digraph,
    deduped by node set; bounded depth keeps this a report-time
    convenience, not a solver."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
    found: List[List[str]] = []
    seen_sets = set()

    def dfs(start: str, node: str, path: List[str]):
        if len(path) > 6:
            return
        for nxt in graph.get(node, ()):
            if nxt == start and len(path) >= 2:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    found.append(list(path))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return found


def report() -> dict:
    with _REG_LOCK:
        edges = dict(_EDGES)
        doc = {
            "pid": os.getpid(),
            "locks": dict(sorted(_LOCKS.items())),
            "edges": sorted(
                [[a, b, n] for (a, b), n in edges.items()]),
            "same_site_nestings": dict(sorted(_SAME_SITE.items())),
            "violations": list(_VIOLATIONS),
        }
    doc["cycles"] = _cycles(edges)
    return doc


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the report atomically; returns the path written."""
    out_dir = path or os.environ.get(ENV_OUT, "")
    if not out_dir:
        return None
    import json
    os.makedirs(out_dir, exist_ok=True)
    fpath = os.path.join(out_dir, f"lockaudit-{os.getpid()}.json")
    tmp = fpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report(), f, indent=1, default=str)
    os.replace(tmp, fpath)
    return fpath


def install_from_env() -> None:
    """Arm from VTP_LOCK_AUDIT (called by volcano_tpu_torch/__init__ before
    any repo lock exists).  With VTP_LOCK_AUDIT_OUT set, the report
    is flushed at exit AND every 500ms from a daemon thread, so a
    SIGKILL'd process (the chaos conductor reboots servers that way)
    still leaves its last graph on disk."""
    if not os.environ.get(ENV_FLAG):
        return
    install()
    if not os.environ.get(ENV_OUT):
        return
    import atexit
    atexit.register(flush)
    # SIGTERM bypasses atexit, and the chaos conductor tears the
    # plane down with exactly that — so a violation recorded after
    # the last 2Hz flush would vanish with the process.  Flush once
    # from the handler, then hand the signal back to the previous
    # disposition so shutdown semantics stay untouched.
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

    threading.Thread(target=_flusher, name="lockaudit-flush",
                     daemon=True).start()

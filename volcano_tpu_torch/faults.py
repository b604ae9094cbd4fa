"""Deterministic, seedable fault injection: wire, disk, and clocks.

The WAL proved the control plane survives the *clean* failure (kill -9);
a planet-scale scheduler mostly dies of *gray* failures — slow links,
dropped acks, duplicated retries, full disks, lying fsyncs, bit rot in
the WAL, wall clocks that jump.  This module is the one place those
faults are described, drawn, and counted:

  * A ``FaultPlan`` is a SEEDED set of ``FaultRule``s.  Every decision
    comes off one ``random.Random(seed)`` stream (under a lock, in
    rule order), so a chaos run that found a bug is replayed exactly
    by re-running the same plan — the seed is logged with every
    injection and ``tools/chaos_conductor.py --seed N`` rebuilds the
    identical schedule.
  * Injection SITES:
      - ``server``: the state server's HTTP handler consults the plan
        per request (state_server.py) — drop_request, drop_response
        (the ack-lost case: commit happens, the ack never arrives),
        delay, duplicate, reorder, http_503, reset, trickle.
      - ``proxy``: the reusable TCP proxy (tools/chaoslib.ChaosProxy)
        injects connection-level faults between any two components —
        blackhole, latency, reset, trickle.
      - ``disk``: durability.py routes WAL file ops through a
        ``FaultyVFS`` — ENOSPC on append, EIO on fsync, torn
        multi-record writes.
      - ``clock``: ``install_clock_faults`` skews/jumps the WALL clock
        (``time.time``) while the monotonic clock stays honest — the
        exact divergence leases and dedupe stamps must survive.
  * Every injected fault increments
    ``fault_injected_total{site,kind}`` (bounded label sets) and logs
    the plan seed, so a failing run names its own reproduction.

Plans serialize to/from a plain JSON doc and load from the
``VTP_FAULT_PLAN`` env var (inline JSON, or ``@/path/to/plan.json``)
so a subprocess server enables chaos without new wiring.  Post-hoc
corruption helpers (``flip_bit``, ``truncate_at``) cover what no live
shim can: bit rot discovered only at the next boot.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import random
import threading
import time
from typing import List, Optional

log = logging.getLogger(__name__)

FAULT_PLAN_ENV = "VTP_FAULT_PLAN"

SITES = ("server", "proxy", "disk", "clock")
# bounded kind enum — these label fault_injected_total, so the set is
# closed (a cardinality test pins it, like the sched_*/elastic_* rule)
WIRE_KINDS = ("drop_request", "drop_response", "delay", "duplicate",
              "reorder", "http_503", "reset", "trickle",
              # shipped-segment corruption: a byte flipped inside one
              # framed WAL record on the /wal shipping lane (the JSON
              # envelope stays valid; only the follower's per-record
              # CRC can tell) — applied by the /wal route itself
              "corrupt_ship")
PROXY_KINDS = ("blackhole", "latency", "reset", "trickle")
DISK_KINDS = ("enospc_append", "eio_fsync", "torn_write")
CLOCK_KINDS = ("wall_jump", "wall_skew")
ALL_KINDS = tuple(dict.fromkeys(
    WIRE_KINDS + PROXY_KINDS + DISK_KINDS + CLOCK_KINDS))


class FaultRule:
    """One injectable fault: where, what, how often, and when.

    route   glob-ish match on the HTTP path ("*" = any; a trailing
            "*" matches a prefix) — meaningful at the server site
    prob    per-opportunity injection probability (drawn from the
            plan's seeded stream)
    after_s/until_s
            active window in seconds since plan start (until_s 0 =
            forever) — how the conductor schedules an ENOSPC brownout
            or a wall jump at a known offset
    ms      magnitude for delay/latency/trickle (per-chunk gap)
    offset_s
            wall-clock displacement for clock kinds
    max_injections
            hard cap (0 = unlimited) — "drop exactly the first ack"
    """

    __slots__ = ("site", "kind", "route", "prob", "after_s", "until_s",
                 "ms", "offset_s", "max_injections", "injected")

    def __init__(self, site: str, kind: str, route: str = "*",
                 prob: float = 1.0, after_s: float = 0.0,
                 until_s: float = 0.0, ms: float = 0.0,
                 offset_s: float = 0.0, max_injections: int = 0):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        site_kinds = {"server": WIRE_KINDS, "proxy": PROXY_KINDS,
                      "disk": DISK_KINDS, "clock": CLOCK_KINDS}[site]
        if kind not in site_kinds:
            raise ValueError(
                f"fault kind {kind!r} is not injectable at site "
                f"{site!r} (valid: {', '.join(site_kinds)})")
        self.site = site
        self.kind = kind
        self.route = route
        self.prob = float(prob)
        self.after_s = float(after_s)
        self.until_s = float(until_s)
        self.ms = float(ms)
        self.offset_s = float(offset_s)
        self.max_injections = int(max_injections)
        self.injected = 0

    def matches_route(self, route: str) -> bool:
        if self.route in ("*", ""):
            return True
        if self.route.endswith("*"):
            return route.startswith(self.route[:-1])
        return route == self.route

    def to_doc(self) -> dict:
        doc = {"site": self.site, "kind": self.kind}
        for f in ("route", "prob", "after_s", "until_s", "ms",
                  "offset_s", "max_injections"):
            v = getattr(self, f)
            if v not in ("*", 0, 0.0) and not (f == "prob" and v == 1.0):
                doc[f] = v
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "FaultRule":
        return cls(**{k: v for k, v in doc.items()
                      if k in cls.__slots__ and k != "injected"})


class FaultPlan:
    """A seeded fault schedule shared by every injection site in one
    process.  Decisions are deterministic GIVEN the sequence of
    opportunities: one locked RNG draw per (matching rule, chance),
    in rule order — so a single-threaded replay of the same request
    sequence injects the same faults, and a threaded run is replayable
    to the extent its request interleaving is."""

    def __init__(self, seed: int, rules: List[FaultRule],
                 t0: Optional[float] = None):
        self.seed = int(seed)
        self.rules = list(rules)
        self.rng = random.Random(self.seed)
        self.t0 = time.monotonic() if t0 is None else t0
        self._lock = threading.Lock()
        # reorder pen: the first parked request waits for a second one
        # (or its hold budget) so two in-flight requests swap order
        self._reorder_cv = threading.Condition(self._lock)
        self._reorder_waiting = 0

    # -- construction ---------------------------------------------------

    def to_doc(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_doc() for r in self.rules]}

    @classmethod
    def from_doc(cls, doc: dict) -> "FaultPlan":
        return cls(int(doc.get("seed", 0)),
                   [FaultRule.from_doc(r) for r in doc.get("rules", [])])

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> Optional["FaultPlan"]:
        raw = (env if env is not None else os.environ).get(
            FAULT_PLAN_ENV, "")
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        plan = cls.from_doc(json.loads(raw))
        log.warning("fault plan ACTIVE (seed=%d, %d rules) — this "
                    "process injects faults on purpose", plan.seed,
                    len(plan.rules))
        return plan

    # -- decisions ------------------------------------------------------

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def _active(self, rule: FaultRule, now_s: float) -> bool:
        if rule.max_injections and \
                rule.injected >= rule.max_injections:
            return False
        if now_s < rule.after_s:
            return False
        if rule.until_s and now_s >= rule.until_s:
            return False
        return True

    def decide(self, site: str, route: str = "*",
               kinds=None) -> Optional[FaultRule]:
        """One injection opportunity: returns the first matching rule
        that fires, counting + logging it, or None.  kinds narrows to
        the fault kinds this opportunity can express (an append can
        suffer ENOSPC, never a lying fsync) — rules outside it are
        not consulted, so they neither fire nor burn their injection
        budget on the wrong seam."""
        now_s = self.elapsed()
        with self._lock:
            for rule in self.rules:
                if rule.site != site or not rule.matches_route(route):
                    continue
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not self._active(rule, now_s):
                    continue
                if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                    continue
                rule.injected += 1
                self._count(site, rule.kind, route)
                return rule
        return None

    def _count(self, site: str, kind: str, route: str) -> None:
        from volcano_tpu_torch import metrics
        metrics.inc("fault_injected_total", site=site, kind=kind)
        log.info("fault injected: site=%s kind=%s route=%s seed=%d "
                 "(replay: same plan, same seed)", site, kind, route,
                 self.seed)

    def reorder_park(self, hold_s: float = 0.15) -> None:
        """The reorder fault: park this request until another request
        enters the pen (they swap order) or the hold budget runs out
        (nothing to swap with — degrade to a delay)."""
        with self._reorder_cv:
            if self._reorder_waiting > 0:
                # someone is parked: release them and pass through —
                # the two requests have now swapped
                self._reorder_waiting = 0
                self._reorder_cv.notify_all()
                return
            self._reorder_waiting += 1
            self._reorder_cv.wait(hold_s)
            if self._reorder_waiting > 0:    # timed out un-swapped
                self._reorder_waiting = 0

    def status(self) -> List[dict]:
        with self._lock:
            return [dict(r.to_doc(), injected=r.injected)
                    for r in self.rules]


# -- disk faults: the VFS shim durability.py routes file ops through --

class VFS:
    """Passthrough file ops.  DurableStore calls ONLY these for WAL
    writes, so a FaultyVFS can sit in the seam without durability.py
    knowing faults exist."""

    def open_append(self, path: str):
        return open(path, "a", encoding="utf-8")

    def write(self, f, data: str) -> None:
        f.write(data)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())


class DiskFault(OSError):
    """An injected disk error (still an OSError: callers handle it
    exactly like the real thing)."""


class FaultyVFS(VFS):
    """Plan-driven disk faults on the WAL seam.

    enospc_append  append raises ENOSPC, nothing written
    torn_write     append persists only a PREFIX of the buffer then
                   raises EIO (a multi-record write torn mid-line)
    eio_fsync      fsync raises EIO after flushing — the lying-fsync
                   shape: page cache took the bytes, the disk did not
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def write(self, f, data: str) -> None:
        rule = self.plan.decide("disk", "append",
                                kinds=("enospc_append", "torn_write"))
        if rule is not None and rule.kind == "enospc_append":
            raise DiskFault(errno.ENOSPC, "injected: no space left "
                                          "on device")
        if rule is not None and rule.kind == "torn_write":
            f.write(data[:max(1, len(data) // 2)])
            f.flush()
            raise DiskFault(errno.EIO, "injected: torn write")
        f.write(data)

    def fsync(self, f) -> None:
        f.flush()
        rule = self.plan.decide("disk", "fsync",
                                kinds=("eio_fsync",))
        if rule is not None and rule.kind == "eio_fsync":
            raise DiskFault(errno.EIO, "injected: fsync I/O error")
        os.fsync(f.fileno())


# -- clock faults ----------------------------------------------------

_REAL_TIME = None


def install_clock_faults(plan: Optional[FaultPlan]) -> bool:
    """Skew/jump the WALL clock per the plan's clock rules while the
    monotonic clock stays honest — time.time is wrapped process-wide
    (chaos processes only; the plan env var is the opt-in).

    wall_jump  after after_s, time.time() returns real + offset_s
               (until until_s, then the jump reverts — an NTP step
               and its correction)
    wall_skew  offset grows linearly at offset_s per second inside
               the window (a drifting clock)
    Injection is counted once per rule, when its window first
    activates."""
    global _REAL_TIME
    rules = [r for r in (plan.rules if plan else [])
             if r.site == "clock"]
    if not rules:
        return False
    if _REAL_TIME is None:
        _REAL_TIME = time.time
    real_time = _REAL_TIME
    counted: set = set()

    def faulty_time():
        t = real_time()
        el = plan.elapsed()
        for i, r in enumerate(rules):
            if el < r.after_s or (r.until_s and el >= r.until_s):
                continue
            if i not in counted:
                counted.add(i)
                plan._count("clock", r.kind, "*")
            if r.kind == "wall_jump":
                t += r.offset_s
            elif r.kind == "wall_skew":
                t += r.offset_s * (el - r.after_s)
        return t

    time.time = faulty_time
    log.warning("clock faults installed: %d rule(s), seed=%d",
                len(rules), plan.seed)
    return True


def uninstall_clock_faults() -> None:
    global _REAL_TIME
    if _REAL_TIME is not None:
        time.time = _REAL_TIME
        _REAL_TIME = None


# -- post-hoc corruption (bit rot, operator accidents) ----------------

def flip_bit(path: str, offset: int, bit: int = 3) -> int:
    """Flip one bit of the byte at *offset* (negative = from EOF);
    returns the absolute offset touched.  The canonical bit-rot
    injection: the record still LOOKS like a line — only the CRC can
    tell."""
    size = os.path.getsize(path)
    if offset < 0:
        offset += size
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << bit)]))
    return offset


def flip_record_bit(path: str, record_index: int) -> int:
    """Flip a bit INSIDE the payload of the record_index'th line
    (0-based) of a WAL segment — mid-segment bit rot that still parses
    as a line.  Returns the absolute byte offset flipped."""
    with open(path, "rb") as f:
        lines = f.readlines()
    off = sum(len(ln) for ln in lines[:record_index])
    target = lines[record_index]
    # flip inside the JSON body, past the CRC frame, away from the
    # newline: a mid-payload flip that keeps the line a line
    return flip_bit(path, off + min(len(target) - 2,
                                    max(12, len(target) // 2)))


def truncate_at(path: str, nbytes: int) -> None:
    """Cut a file to *nbytes* (negative = drop that many from EOF) —
    the torn-final-record shape."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size + nbytes if nbytes < 0 else nbytes)

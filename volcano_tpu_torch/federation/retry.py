"""The ONE cross-region RPC policy for the federation tier.

Every mutating call the router makes into a regional plane goes
through FedRPC.call — replacing the scattered per-site
``except OSError: log("will retry")`` handlers with one shared
discipline:

  * transient classification reuses the wire client's rule
    (connection failures, truncated responses, 5xx); 4xx verdicts —
    including the fence's 409 — propagate typed, because retrying a
    verdict gets the same answer forever;
  * capped exponential backoff with DETERMINISTIC jitter (crc32 over
    (region, attempt), never random): under the seeded chaos
    conductor the retry schedule replays byte-identically, so a
    failure found at seed N reproduces at seed N;
  * a per-region CIRCUIT BREAKER: after ``threshold`` consecutive
    transient failures the region degrades to MIRROR-ONLY observation
    — the router keeps reading its mirror and folding goodput, but
    attempts no mutation until the cooldown elapses (half-open: one
    probe; success closes, failure re-opens with a longer cooldown).
    A partitioned region therefore costs one probe per cooldown, not
    a hot loop of doomed RPCs per reconcile pass.

The fence 409 is special-cased into RouterFencedError: it means THIS
router was deposed (a newer term wrote first), not that the region is
sick — the caller must stop mutating and re-contend for the lease,
never retry.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, Optional

from volcano_tpu_torch import metrics

# consecutive transient failures before a region's breaker opens
BREAKER_THRESHOLD = 3
# open-state cooldown: base doubling per open, capped
BREAKER_COOLDOWN_BASE_S = 1.0
BREAKER_COOLDOWN_CAP_S = 30.0
# per-call retry budget for region write clients: one dead region
# must cost a bounded slice of a reconcile pass, not the wire
# client's default 30s deadline
FED_RPC_DEADLINE_S = 5.0

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"
BREAKER_STATES = (STATE_CLOSED, STATE_OPEN, STATE_HALF_OPEN)
# gauge encoding (federation_router_breaker_state)
STATE_CODES = {STATE_CLOSED: 0.0, STATE_OPEN: 1.0, STATE_HALF_OPEN: 2.0}


def deterministic_jitter(key: str, attempt: int) -> float:
    """[0, 1) jitter fraction from a crc32 hash — stable across runs
    so seeded chaos schedules replay exactly."""
    return (zlib.crc32(f"{key}:{attempt}".encode()) % 1000) / 1000.0


def backoff_delay(attempt: int, key: str,
                  base: float = BREAKER_COOLDOWN_BASE_S,
                  cap: float = BREAKER_COOLDOWN_CAP_S) -> float:
    """Capped exponential backoff with deterministic half-jitter:
    delay in [exp/2, exp) where exp = min(cap, base * 2^(attempt-1))."""
    exp = min(cap, base * (2 ** max(0, attempt - 1)))
    return exp * (0.5 + 0.5 * deterministic_jitter(key, attempt))


class FedRPCError(RuntimeError):
    """A cross-region RPC failed transiently (after the client's own
    bounded retries) or was refused by an open breaker.  The caller
    skips the region this pass; the next pass re-consults the
    breaker."""

    def __init__(self, region: str, op: str, why: str):
        super().__init__(f"region {region!r} {op}: {why}")
        self.region = region
        self.op = op


class RegionTrippedError(FedRPCError):
    """The region's breaker is open: no RPC was attempted at all."""


class RouterFencedError(RuntimeError):
    """A regional plane refused this router's write as STALE-TERM
    (fence 409): a newer router holds the lease.  Not a region
    failure — the caller must stop mutating and re-contend."""

    def __init__(self, region: str, op: str, why: str):
        super().__init__(
            f"deposed: region {region!r} fenced {op}: {why}")
        self.region = region
        self.op = op


def _is_fence_refusal(e: Exception) -> bool:
    return isinstance(e, ValueError) and \
        str(e).startswith("fenced")


class RegionBreaker:
    """closed -> (threshold consecutive failures) -> open -> (cooldown,
    deterministic-jittered, doubling per open) -> half-open -> one
    probe -> closed | open.  Single-writer discipline: the router's
    reconcile pass is the only caller."""

    __slots__ = ("region", "state", "failures", "opens", "half_opens",
                 "last_trip_ts", "_retry_at", "threshold", "base",
                 "cap")

    def __init__(self, region: str, threshold: int = BREAKER_THRESHOLD,
                 base: float = BREAKER_COOLDOWN_BASE_S,
                 cap: float = BREAKER_COOLDOWN_CAP_S):
        self.region = region
        self.state = STATE_CLOSED
        self.failures = 0           # consecutive transient failures
        self.opens = 0              # times opened (drives the cooldown)
        self.half_opens = 0         # cooldown expiries -> probe admitted
        self.last_trip_ts = 0.0     # WALL ts of the last open (0=never)
        self._retry_at = 0.0        # open -> half-open deadline
        self.threshold = threshold
        self.base = base
        self.cap = cap

    def allow(self, now: float) -> bool:
        """May a mutation be attempted right now?  An open breaker
        past its cooldown transitions to half-open and admits ONE
        probe."""
        if self.state == STATE_OPEN:
            if now < self._retry_at:
                return False
            self.state = STATE_HALF_OPEN
            self.half_opens += 1
        return True

    def record_success(self) -> None:
        self.state = STATE_CLOSED
        self.failures = 0
        self.opens = 0

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure OPENED the breaker."""
        self.failures += 1
        if self.state == STATE_HALF_OPEN or \
                self.failures >= self.threshold:
            self.opens += 1
            self.state = STATE_OPEN
            self._retry_at = now + backoff_delay(
                self.opens, self.region, self.base, self.cap)
            return True
        return False

    def retry_in(self, now: float) -> float:
        return max(0.0, self._retry_at - now) \
            if self.state == STATE_OPEN else 0.0

    def snapshot(self, now: float) -> dict:
        """Durable state for the global store (router_breaker kind):
        the open->half-open deadline ships as a RELATIVE cooldown
        (monotonic clocks do not cross processes)."""
        return {"region": self.region, "state": self.state,
                "failures": self.failures, "opens": self.opens,
                "half_opens": self.half_opens,
                "last_trip_ts": self.last_trip_ts,
                "retry_in_s": round(self.retry_in(now), 3)}

    def restore(self, snap: dict, now: float) -> None:
        """Adopt a previous holder's learned region health (promoted
        standby): state machine position, counters, and the remaining
        cooldown re-anchored to OUR monotonic clock.  Conservative by
        construction — at worst the full snapshotted cooldown is
        served again, never a hot loop into a sick region."""
        if not isinstance(snap, dict):
            return
        state = snap.get("state")
        if state not in BREAKER_STATES:
            return
        self.state = state
        for attr in ("failures", "opens", "half_opens"):
            try:
                setattr(self, attr, max(0, int(snap.get(attr, 0) or 0)))
            except (TypeError, ValueError):
                pass
        try:
            self.last_trip_ts = float(snap.get("last_trip_ts", 0) or 0)
        except (TypeError, ValueError):
            self.last_trip_ts = 0.0
        try:
            retry_in = max(0.0, float(snap.get("retry_in_s", 0) or 0))
        except (TypeError, ValueError):
            retry_in = 0.0
        self._retry_at = now + retry_in if self.state == STATE_OPEN \
            else 0.0


class FedRPC:
    """The shared seam: breaker gate + classification + counters for
    every mutating cross-region call."""

    def __init__(self, now: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self._now = now
        self._wall = wall
        self.breakers: Dict[str, RegionBreaker] = {}
        # trip/close seam (router persistence): called as
        # on_transition(region, breaker, "open"|"close") AFTER the
        # state change — exceptions are the callback's problem, the
        # RPC verdict already stands
        self.on_transition: Optional[
            Callable[[str, RegionBreaker, str], None]] = None

    def breaker(self, region: str) -> RegionBreaker:
        b = self.breakers.get(region)
        if b is None:
            b = self.breakers[region] = RegionBreaker(region)
        return b

    def available(self, region: str) -> bool:
        """Would a mutation be attempted now?  (Does not consume the
        half-open probe — a pure read for scoring/placement.)"""
        b = self.breaker(region)
        return b.state != STATE_OPEN or \
            self._now() >= b._retry_at

    def state(self, region: str) -> str:
        return self.breaker(region).state

    def call(self, region: str, op: str, fn: Callable[[], object]):
        """Run one mutating RPC under the shared policy.  Raises
        RegionTrippedError (breaker open, nothing attempted),
        FedRPCError (transient failure, breaker fed),
        RouterFencedError (deposed — stop mutating), or the typed 4xx
        verdict (ValueError/KeyError/AdmissionError) unchanged."""
        from volcano_tpu_torch.cache.remote_cluster import _transient
        b = self.breaker(region)
        now = self._now()
        if not b.allow(now):
            metrics.inc("federation_router_rpc_skipped_total",
                        region=region)
            raise RegionTrippedError(
                region, op, f"breaker open (retry in "
                f"{b.retry_in(now):.1f}s)")
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if _is_fence_refusal(e):
                raise RouterFencedError(region, op, str(e)) from e
            if not _transient(e):
                raise               # typed 4xx verdict: caller's call
            opened = b.record_failure(self._now())
            metrics.inc("federation_router_rpc_failures_total",
                        region=region, op=op)
            if opened:
                b.last_trip_ts = self._wall()
                metrics.inc("federation_router_breaker_opens_total",
                            region=region)
                self._fire(region, b, "open")
            metrics.set_gauge("federation_router_breaker_state",
                              STATE_CODES[b.state], region=region)
            raise FedRPCError(region, op, str(e)) from e
        was_tripped = b.state != STATE_CLOSED
        b.record_success()
        if was_tripped:
            self._fire(region, b, "close")
        metrics.set_gauge("federation_router_breaker_state",
                          STATE_CODES[b.state], region=region)
        return out

    def _fire(self, region: str, b: RegionBreaker, event: str) -> None:
        if self.on_transition is None:
            return
        try:
            self.on_transition(region, b, event)
        except Exception:  # noqa: BLE001 — persistence is advisory
            pass

    def snapshot(self, region: str) -> dict:
        return self.breaker(region).snapshot(self._now())

    def restore(self, region: str, snap: dict) -> None:
        self.breaker(region).restore(snap, self._now())

    def states(self) -> Dict[str, str]:
        return {r: b.state for r, b in sorted(self.breakers.items())}

"""RouterElector: the term-fenced lease that makes the federation
router a crash-adoptive replica set.

N router processes contend for ONE lease (`federation-router`) in the
GLOBAL store.  The store mints a monotonic TERM on every acquisition
that is not a live same-holder renewal — terms are never reissued,
even across a store reboot — and the holder carries that term as the
FENCE on every mutating cross-region RPC.  The split of duties:

  elector    who may mutate (this module): lease CAS in the global
             store, synchronous ``renew()`` the router calls at the
             top of every reconcile pass, plus an optional background
             renewal thread for process deployments where a pass can
             outlive ttl.

  fence      what happens to the loser (server substrate): every
             regional plane tracks a per-name fence floor; a write
             stamped with term < floor is refused 409 BEFORE the
             idempotency-replay lookup, so a deposed router's
             in-flight retries die atomically — no matter how its
             clock drifts or how long its GC pause was.

  adoption   what the winner does first (router._adopt): advance the
             fence on every region to its term, then reconstruct
             in-flight work from region mirrors + durable job
             annotations — the deterministic admission key, the
             evacuating-to episode state, and the create-then-delete
             cutover order make every half-done mutation resumable.

When NO router holds the lease (all crashed, or the global store is
partitioned away), nothing mutates: regions run autonomously on their
admitted gangs and the global queue simply accumulates — admission is
delayed, never lost.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Callable, Optional

from volcano_tpu_torch.api import federation as fedapi

log = logging.getLogger(__name__)


class RouterElector:
    """Contends for the router lease; exposes ``is_leader``/``term``
    and a ``take_promotion()`` edge the router consumes to run its
    adoption pass exactly once per won term."""

    def __init__(self, cluster, holder: str = "",
                 name: str = fedapi.ROUTER_LEASE_NAME,
                 ttl: float = fedapi.ROUTER_LEASE_TTL_S,
                 now: Callable[[], float] = time.monotonic):
        self.cluster = cluster
        self.holder = holder or f"router-{uuid.uuid4().hex[:8]}"
        self.name = name
        self.ttl = ttl
        self._now = now
        self._term = 0
        self._leader = False
        self._promoted = False      # edge: won (or re-won) a term
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- synchronous contention ----------------------------------------

    def renew(self) -> bool:
        """One lease CAS against the global store.  Returns leadership
        AFTER this call.  A wire failure toward the store demotes
        conservatively: a router that cannot prove its lease must stop
        mutating before the ttl lets someone else win."""
        try:
            res = self.cluster.lease(self.name, self.holder,
                                     ttl=self.ttl,
                                     deadline=max(1.0, self.ttl / 3.0))
        except Exception as e:  # noqa: BLE001 — any failure demotes
            if self._leader:
                log.warning("router lease renewal failed (%s); "
                            "standing by", e)
            self._leader = False
            return False
        acquired = bool(res.get("acquired"))
        if acquired:
            term = int(res.get("term", 0) or 0)
            if not self._leader or term != self._term:
                # fresh win OR a new term under the same holder (our
                # lease lapsed and we re-acquired): adopt again — the
                # world may have moved while we were not the holder
                self._promoted = True
                log.info("router %s promoted: term %d", self.holder,
                         term)
            self._term = term
        self._leader = acquired
        return acquired

    @property
    def is_leader(self) -> bool:
        return self._leader

    @property
    def term(self) -> int:
        return self._term

    def take_promotion(self) -> bool:
        """Consume the promotion edge (True exactly once per won
        term)."""
        if self._promoted:
            self._promoted = False
            return True
        return False

    def step_down(self) -> None:
        """Local demotion after a fence refusal proved a newer term
        exists: stop mutating NOW and let renew() re-contend.  The
        lease itself is left to expire — releasing it would hand the
        new holder a redundant term bump."""
        if self._leader:
            log.warning("router %s stepping down (term %d fenced "
                        "off)", self.holder, self._term)
        self._leader = False

    def release(self) -> None:
        """Graceful shutdown: drop the lease so a standby wins within
        one renew interval instead of a full ttl."""
        try:
            self.cluster.lease(self.name, self.holder, ttl=self.ttl,
                               release=True, deadline=1.0)
        except Exception:  # noqa: BLE001 — best-effort on the way out
            pass
        self._leader = False

    # -- background renewal (process deployments) ----------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="router-elector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.release()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.renew()
            # leaders renew eagerly (ttl/3); standbys probe at ttl/2 —
            # the LeaderElector cadence
            self._stop.wait(self.ttl / 3.0 if self._leader
                            else self.ttl / 2.0)

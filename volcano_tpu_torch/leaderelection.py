"""Leader election over a state-server lease.

Reference parity: cmd/scheduler/app/server.go:99-128 (client-go
leaderelection).  Renewal runs on a dedicated thread at ttl/3 cadence
— NEVER inline with the scheduling cycle, so a slow cycle (first
session imports, big snapshot) cannot let the lease lapse under the
leader's feet.  A failed or lost renewal clears `is_leader`
immediately; the component checks the flag each cycle and stands by
until re-acquired.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger(__name__)


class LeaderElector:
    def __init__(self, cluster, lease_name: str, holder: str,
                 ttl: float = 5.0):
        self.cluster = cluster
        self.lease_name = lease_name
        self.holder = holder
        self.ttl = ttl
        self._leader = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="leader-elector", daemon=True)

    def start(self) -> "LeaderElector":
        self._renew_once()
        self._thread.start()
        return self

    @property
    def is_leader(self) -> bool:
        return self._leader.is_set()

    def _renew_once(self) -> None:
        try:
            # the retry budget must stay inside ONE renewal slot
            # (ttl/3): a wire retrying past the TTL would hold the
            # thread while the lease lapses under it — better to fail
            # this renewal, step down, and re-contend next slot
            res = self.cluster.lease(self.lease_name, self.holder,
                                     ttl=self.ttl,
                                     deadline=self.ttl / 3.0)
            acquired = bool(res.get("acquired"))
        except Exception:  # noqa: BLE001 — server blip: step down
            log.warning("lease renewal failed; standing by",
                        exc_info=True)
            acquired = False
        if acquired != self._leader.is_set():
            log.info("leadership %s (%s)",
                     "acquired" if acquired else "lost", self.holder)
        if acquired:
            self._leader.set()
        else:
            self._leader.clear()

    def _loop(self) -> None:
        # renew at ttl/3 (leader) and retry at ttl/2 (standby) — the
        # standby polls slower than the holder renews, so a healthy
        # leader is never raced at the expiry instant
        while not self._stop.is_set():
            interval = self.ttl / 3.0 if self.is_leader else self.ttl / 2.0
            if self._stop.wait(interval):
                return
            self._renew_once()

    def stop(self) -> None:
        self._stop.set()
        if self._leader.is_set():
            try:
                # shutdown courtesy only (the TTL lapses anyway):
                # never let a dead wire block process exit
                self.cluster.lease(self.lease_name, self.holder,
                                   ttl=self.ttl, release=True,
                                   deadline=1.0)
            except Exception:  # noqa: BLE001
                pass
        self._leader.clear()

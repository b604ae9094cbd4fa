"""Audit-log latency exporter — benchmark-layer parity.

The reference measures scheduling latency OUTSIDE the scheduler, from
apiserver audit logs: microsecond `pods/binding` timestamps minus pod
creation timestamps (third_party/kube-apiserver-audit-exporter/
exporter/metrics.go:32-38 — pod_scheduling_latency_seconds and
batchjob_completion_latency_seconds).  This exporter does the same
against the state server's /audit trail: it needs no cooperation from
the scheduler, so the numbers it reports are ground truth for the wire
control plane, not self-reported.

Usage:
    exp = AuditExporter("http://127.0.0.1:8080")
    exp.poll()              # incremental; call on a timer
    exp.pod_latencies()     # {pod_key: seconds}
Observations also land in volcano_tpu_torch.metrics under
pod_scheduling_latency_seconds / batchjob_completion_latency_seconds
so they ride the normal /metrics exposition.
"""

from __future__ import annotations

import logging
import urllib.request
from typing import Dict, List

from volcano_tpu_torch import metrics

log = logging.getLogger(__name__)

TERMINAL_JOB_PHASES = {"Completed", "Failed", "Aborted"}
# completed (bound) pairs retained for pod_latencies(); beyond this the
# oldest measured pairs are dropped (observations already landed in the
# metrics registry, so nothing is lost from the histograms)
MAX_TRACKED = 100_000


class AuditExporter:
    def __init__(self, base_url: str, timeout: float = 5.0,
                 ca_cert: str = "", insecure: bool = False,
                 token: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        from volcano_tpu_torch.server.tlsutil import client_ssl_context
        self._ssl_ctx = client_ssl_context(ca_cert, insecure)
        self._since = 0
        self._pod_created: Dict[str, float] = {}
        self._pod_bound: Dict[str, float] = {}
        self._job_created: Dict[str, float] = {}
        self._job_done: Dict[str, float] = {}
        # jobs first seen ALREADY terminal (exporter attached mid-run):
        # creation ts was seeded by the same record, so a completion
        # latency would read ~0 — excluded from observations/results
        self._seeded_terminal: set = set()
        self.lost_records = False   # sticky: a poll fell off the ring

    # -- collection ----------------------------------------------------

    def poll(self) -> int:
        """Fetch and fold new audit records (paging until drained);
        returns how many.  The server enables audit collection on the
        first poll, so start the exporter BEFORE the workload you want
        measured."""
        total = 0
        while True:
            url = f"{self.base_url}/audit?since={self._since}"
            headers = {"Accept-Encoding": "gzip"}   # 10k-record pages
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            req = urllib.request.Request(url, headers=headers)
            try:
                from volcano_tpu_torch.server.httputil import read_json_body
                with urllib.request.urlopen(req, timeout=self.timeout,
                                            context=self._ssl_ctx
                                            ) as resp:
                    payload = read_json_body(resp)
            except Exception as e:  # noqa: BLE001 - exporter must not die
                log.warning("audit poll of %s failed: %s", url, e)
                break
            if payload.get("lost"):
                self.lost_records = True
                log.warning("audit ring wrapped between polls: some "
                            "records were lost; latencies may "
                            "undercount")
            records = payload.get("records", [])
            for rec in records:
                self._fold(rec)
            total += len(records)
            new_since = payload.get("idx", self._since)
            if not records or new_since <= self._since:
                self._since = new_since
                break
            self._since = new_since
        self._trim()
        return total

    def _fold(self, rec: dict) -> None:
        kind, key, ts = rec.get("kind"), rec.get("key"), rec.get("ts")
        if not key or ts is None:
            return
        if kind == "pod":
            if not rec.get("node"):
                # first sighting without a node = creation
                self._pod_created.setdefault(key, ts)
            elif key not in self._pod_bound:
                self._pod_bound[key] = ts
                created = self._pod_created.get(key)
                if created is not None:
                    metrics.observe("pod_scheduling_latency_seconds",
                                    ts - created)
        elif kind == "pod_deleted":
            # a recreated same-key pod is a NEW scheduling episode
            self._pod_created.pop(key, None)
            self._pod_bound.pop(key, None)
        elif kind == "vcjob":
            first_sighting = key not in self._job_created
            self._job_created.setdefault(key, ts)
            if rec.get("phase") in TERMINAL_JOB_PHASES and \
                    key not in self._job_done:
                self._job_done[key] = ts
                if first_sighting:
                    self._seeded_terminal.add(key)
                else:
                    metrics.observe(
                        "batchjob_completion_latency_seconds",
                        ts - self._job_created[key])
        elif kind == "vcjob_deleted":
            self._job_created.pop(key, None)
            self._job_done.pop(key, None)
            self._seeded_terminal.discard(key)

    def _trim(self) -> None:
        for store in (self._pod_created, self._pod_bound,
                      self._job_created, self._job_done):
            while len(store) > MAX_TRACKED:
                store.pop(next(iter(store)))    # oldest insertion

    # -- results -------------------------------------------------------

    def pod_latencies(self) -> Dict[str, float]:
        return {k: self._pod_bound[k] - self._pod_created[k]
                for k in self._pod_bound
                if k in self._pod_created}

    def job_completion_latencies(self) -> Dict[str, float]:
        return {k: self._job_done[k] - self._job_created[k]
                for k in self._job_done
                if k in self._job_created
                and k not in self._seeded_terminal}

    def quantile(self, q: float) -> float:
        import math
        lats: List[float] = sorted(self.pod_latencies().values())
        if not lats:
            return 0.0
        # nearest-rank: ceil(q*n)-1 (int(q*n) reads one rank high at
        # exact multiples)
        return lats[max(0, min(len(lats) - 1,
                               math.ceil(q * len(lats)) - 1))]

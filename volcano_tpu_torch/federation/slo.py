"""Fleet metric rollups + SLO burn-rate gauges (router-side).

The router is the only process that can see every region, so it is
where fleet health becomes ONE exposition instead of N: each pass it
scrapes every ready region's /metrics text, folds the bounded
families into `federation_rollup_*` gauges (sum for counters and
histogram sums/counts, sum AND max for gauges — `region` is the only
label added, `family` values are closed over bundle.FAMILIES), and
feeds the samples into multi-window burn-rate tracking over the SLOs
the system already claims:

  serving-p99    serving_slo_attainment_min >= SERVING_ATTAINMENT_TARGET
                 (the serving autoscaler's p99 attainment contract)
  failover-mttr  mean of new failover_mttr_seconds observations
                 <= FAILOVER_MTTR_BOUND_S (the failover recovery bound)
  sched-e2e-p95  mean of new e2e_scheduling_latency_seconds
                 observations <= SCHED_E2E_TARGET_S (the flight
                 recorder's latency claim; a mean proxy — the text
                 exposition carries count/sum, not quantiles)

Burn rate is the standard multi-window form: the fraction of polls
inside the window that violated the SLO, divided by the error budget
— 1.0 means the budget is being spent exactly as fast as it accrues,
anything sustained above it means the SLO will be missed.  Episode
IDs and job keys NEVER appear here: every label is a closed enum or
an operator-bounded region name.
"""

from __future__ import annotations

import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch import metrics

# rollup scrape budget per region per pass (a slow region must not
# stall the reconcile loop)
ROLLUP_FETCH_TIMEOUT_S = 2.0

# burn-rate windows (label values of slo_burn_rate{window=})
SLO_WINDOWS = ("5m", "1h")
WINDOW_S = {"5m": 300.0, "1h": 3600.0}

# the SLOs (label values of slo_burn_rate{slo=})
SLO_SERVING = "serving-p99"
SLO_FAILOVER = "failover-mttr"
SLO_SCHED = "sched-e2e-p95"
SLO_NAMES = (SLO_SERVING, SLO_FAILOVER, SLO_SCHED)

SERVING_ATTAINMENT_TARGET = 0.99
FAILOVER_MTTR_BOUND_S = 120.0
SCHED_E2E_TARGET_S = 1.0

# error budget: tolerated bad-poll fraction per window
ERROR_BUDGETS = {SLO_SERVING: 0.01, SLO_FAILOVER: 0.05,
                 SLO_SCHED: 0.05}


def fetch_metrics_text(url: str, token: str = "",
                       timeout: float = ROLLUP_FETCH_TIMEOUT_S) -> str:
    """One region's Prometheus text exposition (read-only; breakers
    govern mutations, not scrapes — a failed scrape just skips the
    region this pass)."""
    req = urllib.request.Request(url.rstrip("/") + "/metrics")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
    return body.decode("utf-8", "replace")


def parse_samples(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """(family, labels, value) per exposition line; histogram
    _count/_sum suffixes are kept verbatim (the rollup folds them)."""
    from volcano_tpu_torch.analysis.schema import _LABEL_RE, _LINE_RE
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group("value"))
        except (TypeError, ValueError):
            continue
        labels = {lm.group("k"): lm.group("v")
                  for lm in _LABEL_RE.finditer(m.group("labels") or "")}
        out.append((m.group("name"), labels, value))
    return out


def rollup(region: str, samples) -> List[Tuple[str, dict, float]]:
    """One region's samples folded to (rollup family, labels, value)
    rows: sums for counters/histograms, sum AND max for gauges.
    Families outside bundle.FAMILIES are dropped — the rollup is the
    bounded-cardinality contract applied fleet-wide."""
    from volcano_tpu_torch.bundle import FAMILIES
    sums: Dict[str, float] = {}
    maxes: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for name, _labels, value in samples:
        base, suffix = name, ""
        for s in ("_count", "_sum"):
            if name.endswith(s) and name[:-len(s)] in FAMILIES:
                base, suffix = name[:-len(s)], s
                break
        kind = FAMILIES.get(base)
        if kind is None:
            continue
        if kind == "histogram":
            if suffix == "_sum":
                sums[base] = sums.get(base, 0.0) + value
            elif suffix == "_count":
                counts[base] = counts.get(base, 0.0) + value
            continue
        sums[base] = sums.get(base, 0.0) + value
        if kind == "gauge":
            maxes[base] = max(maxes.get(base, value), value)
    rows = []
    for fam, v in sums.items():
        rows.append(("federation_rollup_sum",
                     {"family": fam, "region": region}, v))
    for fam, v in maxes.items():
        rows.append(("federation_rollup_max",
                     {"family": fam, "region": region}, v))
    for fam, v in counts.items():
        rows.append(("federation_rollup_count",
                     {"family": fam, "region": region}, v))
    return rows


class SLOTracker:
    """Multi-window burn-rate accounting over per-pass region samples.

    Each ingest() is one poll: the fleet-wide indicator per SLO is
    computed from the freshly scraped samples (histogram indicators
    use the DELTA against the previous poll, so one old spike does
    not poison the window), classified good/bad, and appended to a
    time-bounded ring.  burn_rates() is then pure arithmetic."""

    def __init__(self, now: Callable[[], float] = time.time):
        self.now = now
        self._polls: Dict[str, deque] = {
            slo: deque() for slo in SLO_NAMES}
        # (region, family) -> (count, sum) at the previous poll
        self._prev_hist: Dict[Tuple[str, str], Tuple[float, float]] = {}

    # -- indicator extraction ------------------------------------------

    def _hist_delta_mean(self, region_samples, family: str
                         ) -> Optional[float]:
        """Mean of the observations ADDED since the previous poll,
        across regions (None = no new observations anywhere)."""
        dc_total = ds_total = 0.0
        for region, samples in region_samples.items():
            count = total = None
            for name, _labels, value in samples:
                if name == family + "_count":
                    count = (count or 0.0) + value
                elif name == family + "_sum":
                    total = (total or 0.0) + value
            if count is None or total is None:
                continue
            pc, ps = self._prev_hist.get((region, family), (0.0, 0.0))
            if count < pc:
                pc, ps = 0.0, 0.0       # region process restarted
            dc_total += count - pc
            ds_total += total - ps
            self._prev_hist[(region, family)] = (count, total)
        if dc_total <= 0:
            return None
        return ds_total / dc_total

    def _attainment_min(self, region_samples) -> Optional[float]:
        worst = None
        for samples in region_samples.values():
            for name, _labels, value in samples:
                if name == "serving_slo_attainment_min":
                    worst = value if worst is None \
                        else min(worst, value)
        return worst

    # -- poll ingest ---------------------------------------------------

    def ingest(self, region_samples: Dict[str, list],
               now: Optional[float] = None) -> Dict[str, Optional[bool]]:
        """One poll over {region: parse_samples(...)}.  Returns the
        per-SLO verdict (True=good, False=bad, None=no data)."""
        now = self.now() if now is None else now
        verdicts: Dict[str, Optional[bool]] = {}
        att = self._attainment_min(region_samples)
        verdicts[SLO_SERVING] = None if att is None \
            else att >= SERVING_ATTAINMENT_TARGET
        mttr = self._hist_delta_mean(region_samples,
                                     "failover_mttr_seconds")
        verdicts[SLO_FAILOVER] = None if mttr is None \
            else mttr <= FAILOVER_MTTR_BOUND_S
        e2e = self._hist_delta_mean(region_samples,
                                    "e2e_scheduling_latency_seconds")
        verdicts[SLO_SCHED] = None if e2e is None \
            else e2e <= SCHED_E2E_TARGET_S
        horizon = now - max(WINDOW_S.values())
        for slo, ok in verdicts.items():
            ring = self._polls[slo]
            if ok is not None:
                ring.append((now, ok))
            while ring and ring[0][0] < horizon:
                ring.popleft()
        return verdicts

    # -- burn math -----------------------------------------------------

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[Tuple[str, str], float]:
        """{(slo, window): burn rate}; 0.0 when the window holds no
        polls (no data is not a burning budget)."""
        now = self.now() if now is None else now
        out = {}
        for slo in SLO_NAMES:
            ring = self._polls[slo]
            for window in SLO_WINDOWS:
                cutoff = now - WINDOW_S[window]
                polls = [ok for ts, ok in ring if ts >= cutoff]
                if not polls:
                    out[(slo, window)] = 0.0
                    continue
                bad_frac = polls.count(False) / len(polls)
                out[(slo, window)] = bad_frac / ERROR_BUDGETS[slo]
        return out

    def export(self, now: Optional[float] = None) -> dict:
        """Emit slo_burn_rate gauges and return the durable doc the
        router writes to the global store (vtpctl slo)."""
        now = self.now() if now is None else now
        burns = self.burn_rates(now)
        doc: dict = {"ts": now, "slos": {}}
        targets = {SLO_SERVING: SERVING_ATTAINMENT_TARGET,
                   SLO_FAILOVER: FAILOVER_MTTR_BOUND_S,
                   SLO_SCHED: SCHED_E2E_TARGET_S}
        for slo in SLO_NAMES:
            windows = {}
            for window in SLO_WINDOWS:
                burn = burns[(slo, window)]
                metrics.set_gauge("slo_burn_rate", burn,
                                  slo=slo, window=window)
                cutoff = now - WINDOW_S[window]
                polls = [ok for ts, ok in self._polls[slo]
                         if ts >= cutoff]
                windows[window] = {
                    "burn": round(burn, 4),
                    "good_frac": (round(polls.count(True)
                                        / len(polls), 4)
                                  if polls else None),
                    "polls": len(polls)}
            doc["slos"][slo] = {"target": targets[slo],
                                "budget": ERROR_BUDGETS[slo],
                                "windows": windows}
        return doc

"""Federation-tier annotation schema + region-record helpers.

The federation tier treats N regional control planes as one fungible
accelerator pool behind ONE global queue (Singularity's global
scheduler, arxiv 2202.07848).  The moving parts:

  global store   an ordinary durable state server holding the global
                 job queue (vcjobs) plus the REGION REGISTRY (the
                 `region` dict-kind below: name -> record).  It runs
                 no scheduler and no regional controllers — regions
                 keep their existing planes unchanged.

  router         federation/router.py: admits unadmitted global jobs
                 into the region scoring best on learned
                 goodput-per-generation x capacity x price x data
                 locality, folds regional phase back onto the global
                 record, requeues gangs out of lost regions, and
                 drives cross-region migration (the PR-6 elastic
                 checkpoint/resume drain pointed at another region).

  mirror         federation/mirror.py: the PR-9 WAL-shipping lane
                 reused as an ASYNC object mirror (`/wal?mirror=1` —
                 advertised staleness, never part of the commit
                 quorum) so job records and checkpoint metadata are
                 readable in the destination region before cutover.

Contract (who writes what):

  submitter   `data-locality` (preferred regions, comma list) on the
              GLOBAL job; everything else a normal vcjob.
  router      stamps `admission-key` (deterministic — survives a
              router restart mid-admission), `admitted-region` +
              `admitted-ts` on the global job; stamps `home` (the
              global job key) + `origin-region` on the REGIONAL copy;
              folds the regional phase into `regional-phase`.
  elastic     an `evacuate` resize decision (api/elastic.py
              RESIZE_EVACUATE) drains the gang via the checkpointed
              restart; the `evacuated` hold annotation parks the
              drained gang so the source scheduler never re-places it
              while the router cuts it over.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional

# -- global job (router <-> submitter) ---------------------------------
FED_DATA_LOCALITY_ANNOTATION = "federation.volcano-tpu.io/data-locality"
FED_ADMISSION_KEY_ANNOTATION = "federation.volcano-tpu.io/admission-key"
FED_ADMITTED_REGION_ANNOTATION = \
    "federation.volcano-tpu.io/admitted-region"
FED_ADMITTED_TS_ANNOTATION = "federation.volcano-tpu.io/admitted-ts"
# regional phase folded onto the global record by the router (bounded:
# PodGroupPhase/JobPhase values), so `vtpctl federate` renders fleet
# state from the global store alone
FED_REGIONAL_PHASE_ANNOTATION = \
    "federation.volcano-tpu.io/regional-phase"
# migration provenance: where the gang ran before the current region,
# and how many cross-region moves it has survived
FED_MIGRATED_FROM_ANNOTATION = "federation.volcano-tpu.io/migrated-from"
FED_MIGRATIONS_ANNOTATION = "federation.volcano-tpu.io/migrations"
# admission attempt counter: the deterministic admission key is
# derived from (job key, attempt), so every requeue/migration bumps it
# — a router restart re-derives the SAME key for the SAME attempt
FED_ATTEMPT_ANNOTATION = "federation.volcano-tpu.io/admission-attempt"
# cross-region migration trigger on the GLOBAL job: a region name, or
# "auto" to let the router pick the best destination.  `vtpctl
# federate migrate` stamps it; draining a whole region stamps it on
# every gang admitted there (follow-the-sun)
FED_EVACUATE_ANNOTATION = "federation.volcano-tpu.io/evacuate"
# while a migration is in flight: the chosen destination (cleared at
# cutover or on abort) — restart-safe episode state
FED_EVACUATING_TO_ANNOTATION = "federation.volcano-tpu.io/evacuating-to"
# pending-arbitrage damping: a gang is only migrated off its queue
# after sitting pending this long with another region able to take it
ARBITRAGE_PENDING_S = 30.0

# -- regional copy (router-owned) --------------------------------------
# the global job key this regional job reconciles back to; its
# PRESENCE marks a job as router-placed (the regional plane treats it
# as any other job)
FED_HOME_ANNOTATION = "federation.volcano-tpu.io/home"
FED_ORIGIN_REGION_ANNOTATION = "federation.volcano-tpu.io/origin-region"

# -- causal episode (one ID from global submit to running pod) ---------
# minted by the router the first time it sees an unadmitted global
# job, then carried on EVERY downstream wire write: the regional copy,
# its podgroup (annotation inheritance in the job controller), its
# pods, scheduler session root spans, controller episodes, and both
# sides of a cross-region cutover.  `GET /traces?episode=` on any
# plane returns that plane's local fragment; the router's stitcher
# joins them into one /fleet_trace span tree.
FED_EPISODE_ANNOTATION = "federation.volcano-tpu.io/episode"
# hop index: 0 at first admission, +1 per cross-region move (requeue,
# arbitrage, cutover).  Both cutover sides carry the SAME episode with
# the destination stamped at hop+1 — the create-then-delete pair is
# distinguishable in the stitched tree.
FED_EPISODE_HOP_ANNOTATION = "federation.volcano-tpu.io/episode-hop"
# wall-clock mint timestamp: the stitched tree's t0 (submit-side edge)
FED_EPISODE_TS_ANNOTATION = "federation.volcano-tpu.io/episode-ts"

# -- region registry (the `region` dict-kind) --------------------------
# record shape: {"name", "url", "price", "locality", "token",
#                "heartbeat_ts", "state", "capacity_chips",
#                "idle_chips", "mirror_url"}
REGION_STATE_READY = "ready"
REGION_STATE_LOST = "lost"
# operator cordon (`vtpctl federate drain <region>`): no new
# admissions; the router evacuates every RUNNING federated gang out
REGION_STATE_DRAINING = "draining"
REGION_STATES = (REGION_STATE_READY, REGION_STATE_LOST,
                 REGION_STATE_DRAINING)
# a region silent past this is declared lost: its gangs requeue
# globally (the global store is the source of truth — nothing acked
# is lost with the region)
REGION_TTL_S = 15.0

# mirror staleness bound: reads through RegionMirror.read_checked()
# refuse (MirrorStaleError) once the advertised age exceeds this —
# the migration cutover gate
MIRROR_MAX_AGE_S = 30.0

# -- router HA (leased, crash-adoptive replica set) ---------------------
# N router processes compete for this term-fenced lease in the GLOBAL
# store; only the holder mutates.  The same name doubles as the FENCE
# name on every regional plane: a promoted router advances the
# regional fence to its term before its first write, so the deposed
# holder's in-flight cross-region RPCs are atomically refused (409) —
# the cross-shard-spill refusal discipline applied to routers.
ROUTER_LEASE_NAME = "federation-router"
ROUTER_LEASE_TTL_S = 10.0


def region_record(name: str, url: str, price: float = 1.0,
                  locality: str = "", mirror_url: str = "",
                  token: str = "", metrics_url: str = "") -> dict:
    """A fresh region-registry record (state: ready, heartbeat now).
    ``metrics_url`` is the region's Prometheus exposition endpoint
    (the regional agent's --metrics-port); when set, the leaseholder
    router scrapes it into the federation_rollup_* families."""
    return {
        "name": name, "url": url, "price": float(price),
        "locality": locality, "mirror_url": mirror_url or url,
        "token": token, "metrics_url": metrics_url,
        # vtplint: disable=wall-clock (registry records cross processes; wall time is the shared clock)
        "heartbeat_ts": time.time(),
        "state": REGION_STATE_READY,
        "capacity_chips": 0.0, "idle_chips": 0.0,
    }


def region_alive(rec: dict, now: Optional[float] = None,
                 ttl: float = REGION_TTL_S) -> bool:
    """Fresh heartbeat and not declared lost — a DRAINING region is
    alive (it can still run and evacuate gangs), just not admittable."""
    if not isinstance(rec, dict) or \
            rec.get("state") == REGION_STATE_LOST:
        return False
    # vtplint: disable=wall-clock (heartbeats are cross-process wall stamps)
    now = time.time() if now is None else now
    try:
        return now - float(rec.get("heartbeat_ts", 0)) <= ttl
    except (TypeError, ValueError):
        return False


def region_ready(rec: dict, now: Optional[float] = None,
                 ttl: float = REGION_TTL_S) -> bool:
    """Admittable: fresh heartbeat AND state ready (not lost, not
    draining)."""
    return region_alive(rec, now, ttl) and \
        isinstance(rec, dict) and rec.get("state") == REGION_STATE_READY


def _ann(obj) -> dict:
    return obj.annotations if obj is not None else {}


def data_locality(obj) -> List[str]:
    raw = _ann(obj).get(FED_DATA_LOCALITY_ANNOTATION, "")
    return [r.strip() for r in raw.split(",") if r.strip()]


def admitted_region(obj) -> Optional[str]:
    return _ann(obj).get(FED_ADMITTED_REGION_ANNOTATION) or None


def home_key(obj) -> Optional[str]:
    """On a REGIONAL copy: the global job key it reconciles to."""
    return _ann(obj).get(FED_HOME_ANNOTATION) or None


def admission_key(job_key: str, attempt: int = 0) -> str:
    """Deterministic idempotency key for one (global job, admission
    attempt): a router that crashed between the regional create and
    the admitted-region stamp re-derives the SAME key on restart, so
    the regional put_object replays instead of double-creating (the
    req-id cache / idempotency-keyed mirror write path)."""
    h = hashlib.sha256(f"fed-admit:{job_key}:{attempt}".encode())
    return h.hexdigest()[:24]


def migration_count(obj) -> int:
    try:
        return int(_ann(obj).get(FED_MIGRATIONS_ANNOTATION, 0) or 0)
    except (TypeError, ValueError):
        return 0


def episode_id(job_key: str, attempt: int = 0) -> str:
    """Deterministic BOUNDED episode ID for one global job's causal
    timeline (19 chars, derived like admission_key): a router that
    crashed between minting and the stamp write re-derives the SAME
    ID on restart, so the episode never forks.  The ID is an
    annotation/trace-label value ONLY — never a metric label (it is
    per-job, i.e. unbounded as a label family)."""
    h = hashlib.sha256(f"fed-episode:{job_key}:{attempt}".encode())
    return "ep-" + h.hexdigest()[:16]


def episode_of(obj) -> Optional[str]:
    """The episode ID riding a job/podgroup/pod, if any."""
    return _ann(obj).get(FED_EPISODE_ANNOTATION) or None


def episode_hop(obj) -> int:
    try:
        return int(_ann(obj).get(FED_EPISODE_HOP_ANNOTATION, 0) or 0)
    except (TypeError, ValueError):
        return 0


def episode_ts(obj, default: float = 0.0) -> float:
    """The episode's wall mint timestamp (the stitched tree's t0)."""
    try:
        return float(_ann(obj).get(FED_EPISODE_TS_ANNOTATION,
                                   default) or default)
    except (TypeError, ValueError):
        return default


def ensure_episode(job, now: Optional[float] = None) -> str:
    """Mint (idempotently) the episode onto a GLOBAL job's
    annotations: ID from the mint-time attempt, hop 0, wall t0.
    Returns the episode ID; the caller persists the job."""
    ep = episode_of(job)
    if ep:
        return ep
    try:
        attempt = int(job.annotations.get(FED_ATTEMPT_ANNOTATION, 0)
                      or 0)
    except (TypeError, ValueError):
        attempt = 0
    ep = episode_id(job.key, attempt)
    job.annotations[FED_EPISODE_ANNOTATION] = ep
    job.annotations.setdefault(FED_EPISODE_HOP_ANNOTATION, "0")
    # vtplint: disable=wall-clock (episode t0 crosses processes; wall time is the shared clock)
    job.annotations.setdefault(FED_EPISODE_TS_ANNOTATION,
                               f"{time.time() if now is None else now:.6f}")
    return ep

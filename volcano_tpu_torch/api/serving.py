"""Serving wire types — the SLO contract for inference replica groups.

Training gangs optimize throughput; serving replicas optimize a LATENCY
objective under traffic that breathes (the diurnal curve every consumer
workload rides).  The serving plane reuses the substrate the training
arcs built instead of minting parallel machinery:

  workload   serving workers (workloads/serve.py) run batched forward
             passes off a request queue and publish one cumulative
             stats record per beat (requests served, SLO-ok count,
             latency quantiles) to a per-pod stats file — the goodput
             progress-file convention, different record;

  agent      the ServingCollector (agent/collect.py) turns the
             cumulative request counter into an EWMA QPS on the shared
             util.RateWindow and carries the quantiles through; the
             ServingHandler posts one ServingReport per node per sync
             (change-elided, debt-reposted);

  store      the report folds into PODGROUP annotations exactly like
             GoodputReport: per-pod cumulative ledgers diffed against
             the node's previous report (idempotent under lost-ack
             retry), QPS summed across replicas, p99 maxed — so every
             watch mirror sees the per-group serving summary via
             ordinary podgroup events;

  scheduler  serving replica groups ARE elastic gangs (min/max
             replicas ride the elastic min/max-slices annotations with
             one pod per slice-unit): the serving autoscaler
             (controllers/serving.py) computes desired replicas from
             the folded QPS/p99 vs the declared target and writes the
             SAME desired-slices decision the elastic controller
             already executes — grow, shrink, checkpointed drain,
             floor guards and resize history all inherited, never
             reimplemented.  Topology-aware burst preemption lives in
             actions/elastic.py: the training victim whose slice sits
             nearest the serving pool (hypernode LCA tier) funds the
             scale-up through the elastic shrink path, never a kill.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# -- submitter annotations (on the vcjob/podgroup) ---------------------
# The SLO contract a serving group declares at submit time.  A group
# carrying SLO_P99_MS is "serving-class": the autoscaler manages it and
# burst preemption may be funded on its behalf.
SLO_P99_MS_ANNOTATION = "serving.volcano-tpu.io/slo-p99-ms"
MIN_REPLICAS_ANNOTATION = "serving.volcano-tpu.io/min-replicas"
MAX_REPLICAS_ANNOTATION = "serving.volcano-tpu.io/max-replicas"
TARGET_QPS_ANNOTATION = \
    "serving.volcano-tpu.io/target-qps-per-replica"
# Directory serving workers publish stats under; one file per pod,
# named STATS_FILE_PREFIX + <pod uid> + ".json" (the goodput
# progress-dir convention).
STATS_DIR_ANNOTATION = "serving.volcano-tpu.io/stats-dir"

# Env injected by the torch job plugin for serving-class jobs: the stats
# file THIS replica writes, plus the same restart/resize epoch the
# goodput contract uses (VTP_EPOCH) so the collector can tell a
# restarted replica from a rolled-back counter.
ENV_STATS_FILE = "VTP_SERVING_STATS_FILE"

STATS_FILE_PREFIX = "vtps-"
STATS_FILE_SUFFIX = ".json"

# bounded scale-direction enum (serving_scale_decisions_total label)
SCALE_KINDS = ("up", "down")

# Stats record fields (JSON object, atomically replaced per beat):
#   requests  int   CUMULATIVE requests served by this replica
#   slo_ok    int   cumulative requests answered within the SLO
#   p50_ms    float windowed latency median
#   p99_ms    float windowed latency p99
#   ts        float wall-clock seconds of the last beat
#   epoch     int   restart/resize epoch (VTP_EPOCH passthrough)


def stats_file_for(root: str, uid: str) -> str:
    import os
    return os.path.join(
        root, f"{STATS_FILE_PREFIX}{uid}{STATS_FILE_SUFFIX}")


# -- pod-level annotations (written by the agent's ServingHandler) -----
POD_QPS_ANNOTATION = "serving.volcano-tpu.io/qps"
POD_P99_MS_ANNOTATION = "serving.volcano-tpu.io/p99-ms"

# -- podgroup-level annotations (folded from ServingReport by the
#    STORE — the per-group summary every watch mirror sees) ------------
PG_QPS_ANNOTATION = "serving.volcano-tpu.io/qps"
PG_P50_MS_ANNOTATION = "serving.volcano-tpu.io/p50-ms"
PG_P99_MS_ANNOTATION = "serving.volcano-tpu.io/p99-ms"
# Cumulative request ledgers, ACCUMULATED across reports the way the
# goodput pod-seconds ledger is: each fold contributes only the diff
# against the node's previous report, so several nodes hosting one
# group never double-count and a lost-ack re-post is idempotent.
PG_REQUESTS_ANNOTATION = "serving.volcano-tpu.io/requests"
PG_SLO_OK_ANNOTATION = "serving.volcano-tpu.io/slo-ok"
PG_REPLICAS_ANNOTATION = "serving.volcano-tpu.io/reporting-replicas"
PG_EPOCH_ANNOTATION = "serving.volcano-tpu.io/epoch"
PG_UPDATED_TS_ANNOTATION = "serving.volcano-tpu.io/updated-ts"

# -- autoscaler decision annotations (controllers/serving.py) ----------
# The last decision and its wall time, for `vtpctl serve` and the
# bench's decision->chips-free->serving latency measurement.
PG_LAST_DECISION_ANNOTATION = "serving.volcano-tpu.io/last-decision"
PG_LAST_DECISION_TS_ANNOTATION = \
    "serving.volcano-tpu.io/last-decision-ts"
# Slices currently hosting this group's replicas, stamped by the
# autoscaler from live placements — the topology anchor the
# serving-aware shrink scores training victims against.
PG_POOL_SLICES_ANNOTATION = "serving.volcano-tpu.io/pool-slices"
# Stamped (alongside avoid-slices) on a TRAINING gang whose shrink was
# funded by a serving scale-up: the elastic plugin's avoid filter
# switches to the serving-victim message (bounded reason
# `serving-preemption-victim`), and the elastic controller pops it
# with the avoid preference at resume.
VICTIM_ANNOTATION = "serving.volcano-tpu.io/preemption-victim"

# every accumulated/maxed fold key, for the sticky re-apply
# (cache/fake_cluster.py): a whole-podgroup write from a mirror that
# predates a fold must not erase the serving summary
PG_FOLD_KEYS = (
    PG_QPS_ANNOTATION, PG_P50_MS_ANNOTATION, PG_P99_MS_ANNOTATION,
    PG_REQUESTS_ANNOTATION, PG_SLO_OK_ANNOTATION,
    PG_REPLICAS_ANNOTATION, PG_EPOCH_ANNOTATION,
    PG_UPDATED_TS_ANNOTATION,
)


def ann_float(obj_or_ann, key: str, default: float = 0.0) -> float:
    """Tolerant float read of an annotation (podgroup or dict)."""
    ann = getattr(obj_or_ann, "annotations", obj_or_ann) or {}
    try:
        return float(ann.get(key, default))
    except (TypeError, ValueError):
        return default


def is_serving(obj) -> bool:
    """A podgroup/vcjob declaring a p99 SLO is serving-class."""
    return SLO_P99_MS_ANNOTATION in (
        getattr(obj, "annotations", None) or {})


def slo_p99_ms(obj) -> Optional[float]:
    ann = getattr(obj, "annotations", obj) or {}
    if SLO_P99_MS_ANNOTATION not in ann:
        return None
    try:
        v = float(ann[SLO_P99_MS_ANNOTATION])
    except (TypeError, ValueError):
        return None
    return v if v > 0 else None


def replica_range(obj) -> Optional[Tuple[int, int]]:
    """(min, max) replicas, or None when not declared/invalid."""
    ann = getattr(obj, "annotations", obj) or {}
    try:
        lo = int(ann[MIN_REPLICAS_ANNOTATION])
        hi = int(ann[MAX_REPLICAS_ANNOTATION])
    except (KeyError, TypeError, ValueError):
        return None
    if lo < 1 or hi < lo:
        return None
    return lo, hi


def target_qps_per_replica(obj, default: float = 0.0) -> float:
    return ann_float(obj, TARGET_QPS_ANNOTATION, default)


def pool_slices(obj) -> List[str]:
    ann = getattr(obj, "annotations", obj) or {}
    raw = ann.get(PG_POOL_SLICES_ANNOTATION, "")
    return [s for s in raw.split(",") if s]


@dataclass
class ReplicaServing:
    """One serving replica's measured traffic, as the agent saw it."""

    pod_key: str = ""            # ns/name
    uid: str = ""
    job: str = ""                # owning podgroup key (ns/name)
    epoch: int = 0               # restart/resize epoch of the record
    qps: float = 0.0             # windowed EWMA request rate
    p50_ms: float = 0.0          # windowed latency quantiles
    p99_ms: float = 0.0
    # CUMULATIVE ledgers (this replica's lifetime on this node).  The
    # store folds the per-pod diff against the node's previous report,
    # so a re-posted report after a lost ack is idempotent — deltas on
    # the wire would double-count whenever the server folded a report
    # whose response never arrived (the GoodputReport argument).
    requests: int = 0
    slo_ok: int = 0


@dataclass
class ServingReport:
    """Per-node serving summary the agent posts to the state server
    (one per sync, change-elided; keyed by node like GoodputReport)."""

    node: str = ""
    ts: float = 0.0
    usages: List[ReplicaServing] = field(default_factory=list)

    @property
    def name(self) -> str:      # kinds.py keys servingreport by name
        return self.node

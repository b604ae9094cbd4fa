"""Goodput wire types — measure what the scheduler allocates.

The elastic/failover subsystems can *move* GPUs; nothing else
measures what the workloads DO with them.  These types carry the
measurement half of the Pollux/Gavel loop (arxiv 2008.12260 /
2008.09213):

  workload   workers publish step progress (step counter, examples,
             wall timestamp, restart/resize epoch) to a per-pod
             progress file — workloads/progress.py writes it, the
             torch job plugin injects its path as VTP_PROGRESS_FILE;

  agent      the GoodputCollector (agent/collect.py) turns progress
             into EWMA step rates and productive-vs-allocated time
             accounting; the GoodputHandler posts one GoodputReport
             per node per sync (change-elided);

  store      the report is folded into PODGROUP annotations (the
             per-job summary every watch mirror sees, same pattern as
             BandwidthReport -> node annotations), accumulating
             allocated/productive pod-seconds so goodput =
             productive / allocated reconciles with wall-clock
             GPU-residency.  Drains, failover MTTR and restore ramps
             debit it: GPUs held while the step counter stalls are
             allocated-but-unproductive time;

  scheduler  the cache folds annotated rates into an online
             per-(job, GPU-generation) throughput-vector estimator
             (volcano_tpu_torch/goodput.py) keyed by the node generation
             label below — the substrate Gavel-style policy reads
             (observation-only in this PR; policy stays later).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

# -- GPU generation attribute ------------------------------------------
# Node label naming the hardware generation; the simulator stamps it
# from the GPU product, real deployments inherit it from the node
# pool.  Metric labels use ONLY the bounded enum below — an unknown
# generation string maps to "other", never mints a new series.
GENERATION_LABEL = "volcano-tpu.io/gpu-generation"
GENERATIONS = ("v100", "a100", "h100", "h200", "b200", "gb200", "other")

# GPU Feature Discovery's product label (the derivation used when the
# generation label is absent): its value is the marketing name with
# spaces as dashes, e.g. NVIDIA-H100-80GB-HBM3, Tesla-V100-SXM2-16GB
ACCELERATOR_LABEL = "nvidia.com/gpu.product"


def generation_of(labels: Dict[str, str]) -> str:
    """A node's generation as the BOUNDED enum value: the explicit
    label wins, else the first dash-separated word of the GPU product
    that names a generation (NVIDIA-H100-80GB-HBM3 -> h100), else
    "other".  Never returns a string outside GENERATIONS."""
    gen = (labels or {}).get(GENERATION_LABEL, "")
    if not gen:
        product = (labels or {}).get(ACCELERATOR_LABEL, "")
        gen = next((w for w in product.lower().split("-")
                    if w in GENERATIONS), "")
    return gen if gen in GENERATIONS else "other"


# -- workload progress contract ----------------------------------------
# Env injected by the torch job plugin when the vcjob declares a
# progress dir (annotation below): the file THIS worker writes its
# progress record to, and the restart/resize epoch stamped by the
# control plane (failover generation + elastic generation) so the
# collector can tell a resumed worker from a rolled-back counter.
ENV_PROGRESS_FILE = "VTP_PROGRESS_FILE"
ENV_EPOCH = "VTP_EPOCH"
# Job annotation (submitter): directory workers publish progress
# under; one file per pod, named PROGRESS_FILE_PREFIX + <pod uid> +
# ".json" — the same uid-keyed-dir convention the enforcer/net
# accounting use for cgroups.
PROGRESS_DIR_ANNOTATION = "goodput.volcano-tpu.io/progress-dir"
PROGRESS_FILE_PREFIX = "vtp-"
PROGRESS_FILE_SUFFIX = ".json"

# Progress record fields (JSON object, atomically replaced per step):
#   step      int   global optimizer step (monotonic per epoch)
#   examples  float cumulative examples/tokens processed
#   ts        float wall-clock seconds of the last step
#   epoch     int   restart/resize epoch (VTP_EPOCH passthrough)


def progress_file_for(root: str, uid: str) -> str:
    import os
    return os.path.join(
        root, f"{PROGRESS_FILE_PREFIX}{uid}{PROGRESS_FILE_SUFFIX}")


# -- pod-level annotations (written by the agent's GoodputHandler) -----
POD_STEP_ANNOTATION = "goodput.volcano-tpu.io/step"
POD_STEP_RATE_ANNOTATION = "goodput.volcano-tpu.io/steps-per-s"

# -- podgroup-level annotations (folded from GoodputReport by the
#    STORE, so every watch mirror sees the per-job summary via
#    ordinary podgroup events) -----------------------------------------
PG_STEP_ANNOTATION = "goodput.volcano-tpu.io/step"
PG_STEP_RATE_ANNOTATION = "goodput.volcano-tpu.io/steps-per-s"
PG_EXAMPLES_RATE_ANNOTATION = "goodput.volcano-tpu.io/examples-per-s"
PG_GOODPUT_ANNOTATION = "goodput.volcano-tpu.io/goodput"
# Cumulative pod-residency accounting (pod-seconds; multiply by
# chips-per-pod for chip-seconds).  ACCUMULATED across reports — each
# report carries only the deltas since the node's previous report, so
# several nodes hosting one gang never double-count.
PG_ALLOCATED_S_ANNOTATION = "goodput.volcano-tpu.io/allocated-pod-s"
PG_PRODUCTIVE_S_ANNOTATION = "goodput.volcano-tpu.io/productive-pod-s"
PG_GENERATION_ANNOTATION = "goodput.volcano-tpu.io/generation"
PG_EPOCH_ANNOTATION = "goodput.volcano-tpu.io/epoch"
PG_UPDATED_TS_ANNOTATION = "goodput.volcano-tpu.io/updated-ts"

# every accumulated/maxed fold key, for the sticky re-apply
# (cache/fake_cluster.py): a whole-podgroup write from a mirror that
# predates a fold must not erase the accounting
PG_FOLD_KEYS = (
    PG_STEP_ANNOTATION, PG_STEP_RATE_ANNOTATION,
    PG_EXAMPLES_RATE_ANNOTATION, PG_GOODPUT_ANNOTATION,
    PG_ALLOCATED_S_ANNOTATION, PG_PRODUCTIVE_S_ANNOTATION,
    PG_GENERATION_ANNOTATION, PG_EPOCH_ANNOTATION,
    PG_UPDATED_TS_ANNOTATION,
)


def ann_float(obj_or_ann, key: str, default: float = 0.0) -> float:
    """Tolerant float read of an annotation (podgroup or dict)."""
    ann = getattr(obj_or_ann, "annotations", obj_or_ann) or {}
    try:
        return float(ann.get(key, default))
    except (TypeError, ValueError):
        return default


@dataclass
class PodGoodput:
    """One pod's measured training progress, as the agent saw it."""

    pod_key: str = ""            # ns/name
    uid: str = ""
    job: str = ""                # owning podgroup key (ns/name)
    generation: str = "other"    # node generation (bounded enum)
    epoch: int = 0               # restart/resize epoch of the record
    step: int = 0                # last observed global step
    steps_per_s: float = 0.0     # windowed EWMA step rate
    examples_per_s: float = 0.0
    goodput: float = 0.0         # cumulative productive/allocated
    # CUMULATIVE ledger (seconds over this pod's lifetime on this
    # node).  The store folds the per-pod diff against the node's
    # previous report, so a re-posted report after a lost ack is
    # idempotent — deltas on the wire would double-count whenever the
    # server folded a report whose response never arrived.
    allocated_s: float = 0.0
    productive_s: float = 0.0
    stalled: bool = False        # allocated but no step progress


@dataclass
class GoodputReport:
    """Per-node progress summary the agent posts to the state server
    (one per sync, change-elided; keyed by node like BandwidthReport)."""

    node: str = ""
    ts: float = 0.0
    usages: List[PodGoodput] = field(default_factory=list)

    @property
    def name(self) -> str:       # kinds.py keys goodputreport by name
        return self.node

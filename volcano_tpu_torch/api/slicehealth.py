"""Slice-health wire types — the failover loop's detect half.

A slice here is one NVLink domain: one sick host kills the whole NCCL
gang resident on it.  The agent's GpuHealthHandler escalates GPU telemetry
from an instant verdict to K-consecutive-ticks hysteresis and posts a
SliceHealthReport here (one per host, keyed by node name — the same
wire-kind pattern as api/netusage.py's BandwidthReport).  The state
server folds the verdict into node annotations so every watch mirror —
the failover controller's and the scheduler's included — sees host
health from ordinary node events without decoding reports.

The failover controller (controllers/failover.py) consumes the folded
verdicts, declares the SLICE failed when any resident host is Failed,
drains the gang with one job-level restart, stamps resume metadata on
the podgroup/job, and quarantines the slice's hosts behind a
flap-damping TTL; the scheduler's failover plugin filters quarantined
hosts and fast-tracks the requeued gang.

Verdict ladder (per host):

    Healthy --bad tick--> Suspect --K bad ticks--> Failed
    Failed  --K good ticks--> Healthy        (agent-side hysteresis)

Slice lifecycle (controller-side, docs/design/failover.md):

    Healthy -> Suspect -> Failed -> Quarantined --TTL + healthy--> Healthy
"""

from __future__ import annotations

from dataclasses import dataclass

# Host verdicts the agent publishes (SliceHealthReport.verdict and the
# folded node annotation).
VERDICT_HEALTHY = "Healthy"
VERDICT_SUSPECT = "Suspect"
VERDICT_FAILED = "Failed"

# -- node-level (folded from SliceHealthReport by the STORE, so wire
#    mirrors learn host health via node watch events) ------------------
NODE_HEALTH_ANNOTATION = "failover.volcano-tpu.io/health"
# Stamped by the failover controller on every host of a failed slice:
# unix timestamp until which the slice must not take new gangs (flap
# damping — a slice that heals immediately after failing still serves
# out the TTL before re-entering rotation).
NODE_QUARANTINED_UNTIL_ANNOTATION = \
    "failover.volcano-tpu.io/quarantined-until"

# -- podgroup / job resume metadata ------------------------------------
# Declared by the JOB (where the workload checkpoints); passed through
# to worker env as VTP_CHECKPOINT_DIR by the torch plugin.
CHECKPOINT_DIR_ANNOTATION = "failover.volcano-tpu.io/checkpoint-dir"
# Written by the workload (or its supervisor) as training progresses:
# the last durably checkpointed step.
LAST_STEP_ANNOTATION = "failover.volcano-tpu.io/last-checkpoint-step"
# Stamped by the failover controller at drain time (a snapshot of
# LAST_STEP at declaration): the step the requeued gang resumes from,
# injected into worker env as VTP_RESUME_STEP.
RESUME_STEP_ANNOTATION = "failover.volcano-tpu.io/resume-step"
# Monotonic failover count for the job — bumped once per slice-failure
# drain, so operators (and the smoke test) can tell a failover restart
# from a policy retry.
FAILOVER_GENERATION_ANNOTATION = "failover.volcano-tpu.io/generation"
# Marks a drained gang awaiting re-placement; the scheduler's failover
# plugin gives these allocation priority, and the controller clears it
# once the gang is running again.
REQUEUED_ANNOTATION = "failover.volcano-tpu.io/requeued"


@dataclass
class SliceHealthReport:
    """One host's GPU-health verdict, as the agent's hysteresis saw
    it.  Keyed by node name (kinds.py) — slice membership rides the
    `slice` field so the failover controller can group hosts without
    a node lookup."""

    node: str = ""
    slice: str = ""              # GPU_CLIQUE_LABEL of the host ("" = none)
    verdict: str = VERDICT_HEALTHY
    chips_detected: int = 0
    chips_healthy: int = 0
    consecutive_bad: int = 0     # bad ticks so far (hysteresis position)
    consecutive_good: int = 0
    # wall-clock of the FIRST bad tick of the current episode (0 when
    # healthy): the failover controller derives detection latency from
    # declare-time minus this
    first_bad_ts: float = 0.0

    @property
    def name(self) -> str:       # kinds.py keys slicehealthreport by name
        return self.node

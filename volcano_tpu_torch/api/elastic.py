"""Elastic-gang annotation schema + helpers.

An elastic vcjob declares a SLICE range instead of a fixed world
size: the scheduler may grow it into idle slices up to `max-slices`
and shrink it toward `min-slices` under pressure — world size becomes
a *scheduler decision*, following Singularity's transparent
checkpoint-based resize/migrate (arxiv 2202.07848) and the
elastic-gang semantics of goodput schedulers (Pollux, arxiv
2008.12260).

Contract (who writes what):

  submitter   `elastic.volcano-tpu.io/min-slices` / `max-slices` on
              the vcjob; task replicas size the SUBMIT-time world
              (`slices`, defaulted to min-slices by admission:
              replicas must divide evenly into slices — the quotient
              is the job's pods-per-slice, invariant across resizes).
              Validated in webhooks/admission.py; the podgroup
              inherits the annotations so every watch mirror sees the
              elastic range.

  scheduler   actions/elastic.py stamps the DECISION on the podgroup:
              `desired-slices` + `resize-reason` (grow|shrink|
              migrate), and for migrations `avoid-slices` (the slices
              the re-placement must leave).  Decisions only — no
              object surgery in the scheduling hot path.

  controller  controllers/elastic.py EXECUTES the decision by
              generalizing the failover drain: scale the task
              replicas to desired x pods-per-slice, stamp resume
              metadata (resume step floor-guarded against regress,
              elastic generation), drain with ONE job-level
              RestartJob, let the scheduler re-place at the new world
              size, and observe shrink-latency / grow-latency /
              migration-MTTR into the elastic_* metric families.
              `slices` is updated to the executed size; `history`
              keeps the last resizes for `vtpctl elastic`.

  workload    the torch plugin injects TPU_NUM_SLICES/TPU_SLICE_ID
              from the CURRENT slice count (a slice is one NVLink
              domain) so the worker builds its hybrid mesh at the new
              world size; checkpoint.
              resume_state restores onto the resized mesh (dp-
              dimension resize is loss-continuous when the global
              batch is held constant — asserted by the dryrun e2e).
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

# -- spec (submitter) --------------------------------------------------
ELASTIC_MIN_SLICES_ANNOTATION = "elastic.volcano-tpu.io/min-slices"
ELASTIC_MAX_SLICES_ANNOTATION = "elastic.volcano-tpu.io/max-slices"
# current world size in slices (admission defaults it to min-slices;
# the elastic controller re-stamps it after every executed resize)
ELASTIC_SLICES_ANNOTATION = "elastic.volcano-tpu.io/slices"

# optional: global batch (samples/step) the workload holds constant
# across resizes; defaults to one sample per device at the FLOOR world
# (min-slices x pods-per-slice x GPUs-per-pod) — the torch plugin
# injects it as WORKER_GLOBAL_BATCH
ELASTIC_GLOBAL_BATCH_ANNOTATION = "elastic.volcano-tpu.io/global-batch"

# -- decision (scheduler -> controller) --------------------------------
ELASTIC_DESIRED_SLICES_ANNOTATION = \
    "elastic.volcano-tpu.io/desired-slices"
ELASTIC_RESIZE_REASON_ANNOTATION = "elastic.volcano-tpu.io/resize-reason"
# wall time the CURRENT desired value was first stamped.  A decision
# this old with no controller executing it is STALE: the plugin's
# shrink-before-preempt veto and the action's convergence guard both
# ignore it, so a dead/disabled elastic controller degrades the
# subsystem to a no-op instead of freezing preemption fleet-wide.
ELASTIC_DECIDED_TS_ANNOTATION = "elastic.volcano-tpu.io/decided-ts"
STALE_DECISION_S = 120.0
# migration only: slices the re-placement must avoid (comma list);
# the elastic plugin filters their hosts for this gang until resume
ELASTIC_AVOID_SLICES_ANNOTATION = "elastic.volcano-tpu.io/avoid-slices"

# -- execution record (controller) -------------------------------------
# set (to the resize kind) while the controller is executing a resize,
# popped at resume: the durable in-flight marker episode adoption
# rebuilds from after a controller restart (a purely in-memory episode
# would leave the annotation-driven in-flight guard wedged forever)
ELASTIC_RESIZING_ANNOTATION = "elastic.volcano-tpu.io/resizing"
ELASTIC_GENERATION_ANNOTATION = "elastic.volcano-tpu.io/generation"
ELASTIC_HISTORY_ANNOTATION = "elastic.volcano-tpu.io/history"
ELASTIC_LAST_RESIZE_TS_ANNOTATION = \
    "elastic.volcano-tpu.io/last-resize-ts"

RESIZE_GROW = "grow"
RESIZE_SHRINK = "shrink"
RESIZE_MIGRATE = "migrate"
# cross-region evacuation (api/federation.py): the checkpointed drain
# with NO local re-place — the gang parks under the `evacuated` hold
# until the federation router cuts it over to the destination region
RESIZE_EVACUATE = "evacuate"
RESIZE_KINDS = (RESIZE_GROW, RESIZE_SHRINK, RESIZE_MIGRATE,
                RESIZE_EVACUATE)

# -- evacuation (federation router <-> elastic controller) -------------
# stamped by the router on the SOURCE podgroup: the destination region
# name.  The elastic controller executes the drain exactly like a
# migrate, then stamps `evacuated` instead of letting the gang
# re-place; actions/enqueue.py holds an evacuated gang out of INQUEUE
# (reason: `evacuating-region`) so the source scheduler never races
# the cutover.  The router clears both after the destination accepts.
ELASTIC_EVACUATE_ANNOTATION = "elastic.volcano-tpu.io/evacuate-to"
ELASTIC_EVACUATED_ANNOTATION = "elastic.volcano-tpu.io/evacuated"

HISTORY_KEEP = 8    # resize records retained on the annotation


def evacuating(obj) -> bool:
    """True while *obj* (podgroup or vcjob) is anywhere inside a
    cross-region evacuation: decision stamped, drain in flight, or
    drained-and-held awaiting the router's cutover."""
    ann = _ann(obj)
    return bool(ann.get(ELASTIC_EVACUATE_ANNOTATION) or
                ann.get(ELASTIC_EVACUATED_ANNOTATION))


def _ann(obj) -> dict:
    return obj.annotations if obj is not None else {}


def is_elastic(obj) -> bool:
    """True when *obj* (vcjob or podgroup) declares an elastic range."""
    ann = _ann(obj)
    return ELASTIC_MIN_SLICES_ANNOTATION in ann and \
        ELASTIC_MAX_SLICES_ANNOTATION in ann


def elastic_range(obj) -> Optional[Tuple[int, int]]:
    """(min_slices, max_slices) or None when not elastic/malformed."""
    ann = _ann(obj)
    try:
        lo = int(ann[ELASTIC_MIN_SLICES_ANNOTATION])
        hi = int(ann[ELASTIC_MAX_SLICES_ANNOTATION])
    except (KeyError, TypeError, ValueError):
        return None
    if lo < 1 or hi < lo:
        return None
    return lo, hi


def current_slices(obj) -> int:
    """The object's CURRENT world size in slices (>= 1)."""
    ann = _ann(obj)
    try:
        return max(1, int(ann.get(ELASTIC_SLICES_ANNOTATION, 1)))
    except (TypeError, ValueError):
        return 1


def desired_slices(obj) -> Optional[int]:
    raw = _ann(obj).get(ELASTIC_DESIRED_SLICES_ANNOTATION)
    if raw is None:
        return None
    try:
        return max(1, int(raw))
    except (TypeError, ValueError):
        return None


def decision_stale(obj, now: float) -> bool:
    """True when a desired-slices decision has sat unexecuted past
    STALE_DECISION_S (no elastic controller alive to consume it)."""
    if desired_slices(obj) is None:
        return False
    try:
        decided = float(_ann(obj).get(ELASTIC_DECIDED_TS_ANNOTATION,
                                      0) or 0)
    except (TypeError, ValueError):
        return False
    return decided > 0 and now - decided > STALE_DECISION_S


def avoid_slices(obj) -> List[str]:
    raw = _ann(obj).get(ELASTIC_AVOID_SLICES_ANNOTATION, "")
    return [s for s in raw.split(",") if s]


def resize_history(obj) -> List[dict]:
    """Parsed resize history (oldest first); [] when absent/corrupt."""
    raw = _ann(obj).get(ELASTIC_HISTORY_ANNOTATION, "")
    if not raw:
        return []
    try:
        doc = json.loads(raw)
    except (TypeError, ValueError):
        return []
    return doc if isinstance(doc, list) else []


def append_history(ann: dict, record: dict) -> None:
    """Append one resize record, keeping the last HISTORY_KEEP."""
    hist = []
    try:
        hist = json.loads(ann.get(ELASTIC_HISTORY_ANNOTATION, "[]"))
        if not isinstance(hist, list):
            hist = []
    except (TypeError, ValueError):
        hist = []
    hist.append(record)
    ann[ELASTIC_HISTORY_ANNOTATION] = json.dumps(hist[-HISTORY_KEEP:])

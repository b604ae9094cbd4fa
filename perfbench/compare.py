"""The numbers that decide `correct`, and their judgement.

Training (the first steps of the timed step object, against the
reference's steps on the same inputs):

- `loss_gap`: the largest |loss - reference loss| / |reference loss|
  over the steps;
- `grad1_gap`: the first gradient as the optimizer took it (after the
  clip; the program's read from its first moment after one step), the
  worst leaf's |norm - reference norm| / max(reference norm, the median
  leaf's reference norm);
- `change_gap`: each leaf's ||p - p0|| after the steps, the worst leaf
  the same way, over the leaves whose reference first gradient is at
  least `MOVED` of the median leaf's (the others move by round-off).

A cell's limits file names the numbers it compares.

Serving (answers sampled from the seed, once the window has closed):

- `logit_err`: the worst sampled request's ||logits - reference
  logits|| / ||reference logits|| over its sampled positions.

A run is correct when every number is finite and at most its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Iterable, List, Optional, Tuple

MOVED = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> float:
    med = statistics.median(ref.values())
    names = list(ref) if names is None else list(names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def moved(grad1_ref: Dict[str, float]) -> List[str]:
    med = statistics.median(grad1_ref.values())
    return [n for n, v in grad1_ref.items() if v >= MOVED * med]


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, float]:
    """prog, ref: readings with `losses`, `first` and `change` (leaf
    norms)."""
    gr = ref["first"]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad1_gap": leaf_gap(prog["first"], gr),
        "change_gap": leaf_gap(prog["change"], ref["change"], moved(gr)),
    }


def rel_err(prog, ref) -> float:
    """||prog - ref|| / ||ref|| of two tensors, in f32."""
    ref = ref.float()
    return float((prog.float() - ref).norm() / ref.norm())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    checks = {k: {"value": numbers.get(k, math.nan), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

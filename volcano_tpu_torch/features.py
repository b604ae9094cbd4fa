"""Feature gates.

Reference parity: pkg/features/volcano_features.go (k8s component-base
featuregate).  A process-wide mutable registry of named boolean gates
with defaults; configured from a ``--feature-gates A=true,B=false``
style string or programmatically.  Components consult `enabled(name)`
where the reference checks `utilfeature.DefaultFeatureGate.Enabled`.

GPU gate set: the reference's device/CSI-specific gates map onto
their NVLink-domain/standalone analogues; gates keep the reference
names where the concept carries over so operators find familiar
switches.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# name -> (default, description)
_DEFINITIONS: Dict[str, tuple] = {
    # reference gates that carry over directly
    "WorkLoadSupport": (True, "reconcile bare workload pods into "
                              "podgroups (podgroup controller)"),
    "VolcanoJobSupport": (True, "vcjob controller + lifecycle policies"),
    "PodDisruptionBudgetsSupport": (True, "pdb plugin vetoes evictions"),
    "QueueCommandSync": (True, "queue open/close via command bus"),
    "PriorityClass": (True, "priority-class ordering and preemption"),
    "ResourceTopology": (True, "numaaware NUMA topology scheduling"),
    "CronVolcanoJobSupport": (True, "cronjob controller"),
    "SchedulingGatesQueueAdmission": (False, "create pods gated until "
                                            "their queue admits"),
    # GPU-layer gates (CSIStorage analogue + new surface)
    "VolumeBinding": (True, "zone-affine PV/PVC binding plugin "
                            "(CSIStorage analogue)"),
    "GPUDeviceAtomicity": (True, "whole-host GPU atomicity on "
                                 "multi-host NVLink domains"),
    "IncrementalSnapshot": (True, "dirty-tracked snapshot reuse "
                                  "between cycles (16k-host headroom); "
                                  "false = full rebuild every cycle"),
    # DRA feature-gate surface (reference predicates.go:154-162)
    "DRADeviceTaints": (True, "devices may carry taints; claims need "
                              "matching tolerations"),
    "DRAPrioritizedList": (True, "claims may list device classes in "
                                 "preference order (firstAvailable)"),
    "DRAAdminAccess": (False, "admin claims attach to owned devices "
                              "without consuming capacity"),
}

_lock = threading.Lock()
_overrides: Dict[str, bool] = {}


class UnknownFeatureError(ValueError):
    pass


def enabled(name: str) -> bool:
    """Is the gate on?  Unknown names raise (matching featuregate)."""
    with _lock:
        if name in _overrides:
            return _overrides[name]
    try:
        return _DEFINITIONS[name][0]
    except KeyError:
        raise UnknownFeatureError(f"unknown feature gate {name!r}") \
            from None


def set_gate(name: str, value: bool) -> None:
    if name not in _DEFINITIONS:
        raise UnknownFeatureError(f"unknown feature gate {name!r}")
    with _lock:
        _overrides[name] = bool(value)


def parse(spec: str) -> None:
    """Apply a 'A=true,B=false' flag string (cmd-line / conf)."""
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise UnknownFeatureError(
                f"feature gate spec {part!r} is not name=bool")
        name, _, raw = part.partition("=")
        raw = raw.strip().lower()
        if raw not in ("true", "false"):
            raise UnknownFeatureError(
                f"feature gate {name!r}: value {raw!r} is not true/false")
        set_gate(name.strip(), raw == "true")


def reset(name: Optional[str] = None) -> None:
    """Drop overrides (tests)."""
    with _lock:
        if name is None:
            _overrides.clear()
        else:
            _overrides.pop(name, None)


def known() -> Dict[str, bool]:
    """Current effective values for every defined gate."""
    with _lock:
        return {n: _overrides.get(n, d[0])
                for n, d in sorted(_DEFINITIONS.items())}

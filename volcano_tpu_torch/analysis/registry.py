"""Runtime registry cross-checks: the contracts no AST pass can see.

These import the live package and verify the three registries agree
with each other and with the code that feeds them:

  wire-roundtrip   every class the codec registers encodes and
                   decodes back to an equal encoding (a wire type
                   whose fields the codec cannot carry would corrupt
                   the first snapshot that ships one).  Instances are
                   synthesized from dataclass defaults, with simple
                   placeholder values for required fields.
  kind-registry    every kind in cache.kinds.KINDS maps to a real
                   store attribute on FakeCluster, and typed kinds
                   can derive a key.
  family-coverage  every family the code can generate is declared in
                   bundle.FAMILIES and every FAMILY_LABELS row points
                   at a declared family; every 'enum:' label spec
                   resolves.  This is what caught the eleven live
                   queue_* families and two whole subsystems
                   (audit exporter, mirror resync) the table had
                   silently drifted from.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import List

from volcano_tpu_torch.analysis.astlint import Finding

_PLACEHOLDERS = {str: "x", int: 1, float: 1.0, bool: True,
                 dict: {}, list: [], tuple: (), set: set(),
                 frozenset: frozenset()}


def _synthesize(cls):
    """Best-effort instance of a registered wire dataclass: defaults
    where declared, simple placeholders for required simple fields."""
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING or \
                f.default_factory is not dataclasses.MISSING:
            continue
        hint = hints.get(f.name, str)
        origin = typing.get_origin(hint) or hint
        if origin in _PLACEHOLDERS:
            kwargs[f.name] = _PLACEHOLDERS[origin]
        elif isinstance(origin, type) and \
                issubclass(origin, enum.Enum):
            kwargs[f.name] = next(iter(origin))
        elif isinstance(origin, type) and dataclasses.is_dataclass(
                origin):
            kwargs[f.name] = _synthesize(origin)
        else:
            kwargs[f.name] = None
    return cls(**kwargs)


def check_wire_roundtrip() -> List[Finding]:
    from volcano_tpu_torch.api import codec
    codec._build_registry()
    findings: List[Finding] = []
    for name, cls in sorted(codec._CLASSES.items()):
        try:
            obj = _synthesize(cls)
            wire = codec.dumps(obj)
            back = codec.loads(wire)
            if codec.dumps(back) != wire:
                findings.append(Finding(
                    "wire-roundtrip", "volcano_tpu_torch/api/codec.py", 0,
                    f"{name}: decode(encode(x)) re-encodes "
                    f"differently — a lossy wire type"))
        except Exception as e:  # noqa: BLE001 — each failure reported
            findings.append(Finding(
                "wire-roundtrip", "volcano_tpu_torch/api/codec.py", 0,
                f"{name}: does not round-trip through the codec "
                f"({type(e).__name__}: {e})"))
    return findings


def check_kind_registry() -> List[Finding]:
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.cache.kinds import KINDS
    findings: List[Finding] = []
    cluster = FakeCluster()
    for kind, spec in sorted(KINDS.items()):
        store = getattr(cluster, spec.attr, None)
        if store is None:
            findings.append(Finding(
                "kind-registry", "volcano_tpu_torch/cache/kinds.py", 0,
                f"kind {kind!r} names store attribute "
                f"{spec.attr!r} which FakeCluster does not have"))
        elif not hasattr(store, "items"):
            findings.append(Finding(
                "kind-registry", "volcano_tpu_torch/cache/kinds.py", 0,
                f"kind {kind!r} store {spec.attr!r} is not a "
                f"mapping (snapshot encoding iterates .items())"))
    return findings


def check_family_coverage() -> List[Finding]:
    from volcano_tpu_torch import goodput
    from volcano_tpu_torch.analysis.astlint import _Enums
    from volcano_tpu_torch.bundle import (FAMILIES, FAMILY_LABELS,
                                    agent_dashboard,
                                    dashboard_metric_names,
                                    scheduler_dashboard)
    findings: List[Finding] = []
    for fam in FAMILY_LABELS:
        if fam not in FAMILIES:
            findings.append(Finding(
                "family-coverage", "volcano_tpu_torch/bundle.py", 0,
                f"FAMILY_LABELS declares {fam!r} which is not in "
                f"FAMILIES"))
    enums = _Enums()
    for fam, labels in FAMILY_LABELS.items():
        for key, spec in labels.items():
            try:
                enums.resolve(spec)
            except Exception as e:  # noqa: BLE001 — reported per spec
                findings.append(Finding(
                    "family-coverage", "volcano_tpu_torch/bundle.py", 0,
                    f"label spec {fam}.{key} = {spec!r} does not "
                    f"resolve ({e})"))
    for fam in goodput.SESSION_GAUGE_FAMILIES:
        if fam not in FAMILIES:
            findings.append(Finding(
                "family-coverage", "volcano_tpu_torch/goodput.py", 0,
                f"SESSION_GAUGE_FAMILIES exports {fam!r} which is "
                f"not declared in FAMILIES"))
    for dash in (scheduler_dashboard(), agent_dashboard()):
        for fam in dashboard_metric_names(dash):
            if fam not in FAMILIES:
                findings.append(Finding(
                    "family-coverage", "volcano_tpu_torch/bundle.py", 0,
                    f"dashboard {dash['uid']} queries undeclared "
                    f"family {fam!r}"))
    return findings


def check_all() -> List[Finding]:
    return (check_wire_roundtrip() + check_kind_registry()
            + check_family_coverage())

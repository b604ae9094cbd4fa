"""Runtime metric label-schema enforcement over a live exposition.

``bundle.FAMILY_LABELS`` declares, per family, which label keys may
appear and what values they may carry (closed enum / operator config /
per-object key with a deletion lifecycle).  ``check_exposition`` runs
the declaration against a real Prometheus text dump — the dynamic
half of the bounded-cardinality contract, covering the label values
no static pass can see (f-string families, computed label values).

This subsumes the three per-PR cardinality tests (trace / elastic /
goodput) that each re-implemented a slice of it by hand:
tests/test_lint.py drives a real scheduling session and feeds the
whole exposition through here instead.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:'
                       r'[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str]]]:
    """(family, labels) per sample line; _count/_sum histogram
    suffixes fold back onto their family name."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            out.append(("<unparseable>", {"line": line}))
            continue
        name = m.group("name")
        labels = {lm.group("k"): lm.group("v")
                  for lm in _LABEL_RE.finditer(m.group("labels") or "")}
        out.append((name, labels))
    return out


def check_exposition(text: str, families=None,
                     family_labels=None) -> List[str]:
    """Violation strings for every sample breaking the declared
    schema (empty list == the exposition honours the contract)."""
    if families is None or family_labels is None:
        from volcano_tpu_torch.bundle import FAMILIES, FAMILY_LABELS
        families = FAMILIES if families is None else families
        family_labels = FAMILY_LABELS if family_labels is None \
            else family_labels
    from volcano_tpu_torch.analysis.astlint import _Enums
    enums = _Enums()
    violations: List[str] = []
    for name, labels in parse_exposition(text):
        if name == "<unparseable>":
            violations.append(f"unparseable exposition line: "
                              f"{labels['line']!r}")
            continue
        fam = name
        if fam not in families:
            base = re.sub(r"_(count|sum)$", "", fam)
            if base in families:
                fam = base
            else:
                violations.append(
                    f"{name}: family not declared in bundle.FAMILIES")
                continue
        declared = family_labels.get(fam, {})
        for key, val in labels.items():
            spec = declared.get(key)
            if spec is None:
                violations.append(
                    f"{name}: label {key}={val!r} not declared for "
                    f"this family (undeclared keys are how job-key "
                    f"cardinality leaks in)")
                continue
            allowed = enums.resolve(spec)
            if allowed is not None and val not in allowed:
                violations.append(
                    f"{name}: label {key}={val!r} outside its "
                    f"bounded enum {sorted(allowed)}")
    return violations

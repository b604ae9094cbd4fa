"""A pyflakes-shaped pass with a zero-dependency fallback.

Tier-1 wants a basic hygiene gate (syntax errors, unused imports)
alongside the project rules.  The container image bakes in no linter,
so: when the real ``pyflakes`` is importable it runs (full checker);
otherwise a conservative built-in fallback covers the two highest-
signal checks without its false-positive surface:

  syntax-error    the file does not parse
  unused-import   an imported binding never referenced by any Name in
                  the module (attribute roots included).  Skipped for
                  __init__.py (re-export surface), ``from __future__``,
                  imports inside try/except (optional-dependency
                  gating), names in ``__all__``, underscore bindings,
                  and lines carrying ``noqa``.

Conservative by design: a missed unused import is cheap, a false
positive that fails tier-1 is not.
"""

from __future__ import annotations

import ast
from typing import List, Set

from volcano_tpu_torch.analysis.astlint import Finding


def _real_pyflakes(src: str, path: str):
    try:
        from pyflakes.api import check
        from pyflakes.reporter import Reporter
    except ImportError:
        return None
    import io

    class _Cap(io.StringIO):
        pass

    out, err = _Cap(), _Cap()
    check(src, path, Reporter(out, err))
    findings = []
    for line in out.getvalue().splitlines():
        # "<path>:<line>:<col>: <msg>" (pyflakes >= 3) or without col
        parts = line.split(":", 3)
        if len(parts) >= 3 and parts[1].strip().isdigit():
            lineno = int(parts[1])
            msg = parts[-1].strip()
            findings.append(Finding("pyflakes", path, lineno, msg))
    return findings


def check_source(src: str, path: str) -> List[Finding]:
    real = _real_pyflakes(src, path)
    if real is not None:
        return real
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0,
                        f"cannot parse: {e.msg}")]
    if path.endswith("__init__.py"):
        return []
    lines = src.splitlines()

    used: Set[str] = set()
    exported: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__" and \
                        isinstance(node.value, (ast.List, ast.Tuple)):
                    exported.update(
                        e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str))

    in_try: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for sub in ast.walk(node):
                in_try.add(id(sub))
        elif isinstance(node, ast.If):
            # `if TYPE_CHECKING:` imports feed quoted annotations the
            # AST cannot see — never report them
            test = node.test
            name = test.attr if isinstance(test, ast.Attribute) \
                else getattr(test, "id", "")
            if name == "TYPE_CHECKING":
                for sub in ast.walk(node):
                    in_try.add(id(sub))

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and \
                node.module == "__future__":
            continue
        if id(node) in in_try:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) \
            else ""
        if "noqa" in line:
            continue
        for alias in node.names:
            if alias.name == "*":
                continue
            bound = alias.asname or alias.name.split(".")[0]
            if bound.startswith("_") or bound in exported:
                continue
            if bound not in used:
                findings.append(Finding(
                    "unused-import", path, node.lineno,
                    f"{bound!r} imported but unused"))
    return findings


def check_paths(paths) -> List[Finding]:
    import os
    findings: List[Finding] = []
    for path in paths:
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                findings.extend(check_source(f.read(), path))
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(root, fname)
                with open(fpath, encoding="utf-8") as f:
                    findings.extend(check_source(f.read(), fpath))
    return findings

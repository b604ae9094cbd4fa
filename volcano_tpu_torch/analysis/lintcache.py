"""mtime-keyed lint result cache (``.vtplint_torch_cache/``).

The rule set grows (eight AST rules plus a whole-program ownership
pass) while the tier-1 lint gate's wall time must not: vtplint re-lints
only what changed.

Two granularities, one JSON file:

  per-file   the astlint AST rules and the flakes pass are pure
             functions of one file's bytes — results key on
             ``mtime_ns:size`` per file.
  per-tree   the racecheck ownership pass is whole-program (its call
             graph crosses files), so its result keys on a digest of
             EVERY in-domain file's signature: one byte changed
             anywhere re-runs the pass, nothing changed replays it.

The cache version is a digest of the analysis toolchain's own
sources (astlint/flakes/racecheck/registry/schema/lintcache +
analysis/vtplint.py + bundle.py, whose FAMILIES tables feed the metric
rules): editing ANY rule invalidates every cached result — a stale
green from an older rule set is worse than a slow gate.  Registry
cross-checks run live every time (they verify the imported package,
not file bytes).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

from volcano_tpu_torch.analysis.astlint import Finding

# the port's own directory: the reference's linter keys its entries on
# the same file signatures, so a shared directory would replay them
CACHE_DIR = ".vtplint_torch_cache"

_TOOLCHAIN = (
    "volcano_tpu_torch/analysis/astlint.py",
    "volcano_tpu_torch/analysis/flakes.py",
    "volcano_tpu_torch/analysis/racecheck.py",
    "volcano_tpu_torch/analysis/registry.py",
    "volcano_tpu_torch/analysis/schema.py",
    "volcano_tpu_torch/analysis/lintcache.py",
    "volcano_tpu_torch/bundle.py",
    "volcano_tpu_torch/analysis/vtplint.py",
)


def file_sig(path: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f"{st.st_mtime_ns}:{st.st_size}"


def _encode(findings: List[Finding]) -> list:
    return [{"rule": f.rule, "path": f.path, "line": f.line,
             "msg": f.msg, "suppressed": f.suppressed}
            for f in findings]


def _decode(rows: list) -> List[Finding]:
    return [Finding(r["rule"], r["path"], r["line"], r["msg"],
                    r.get("suppressed")) for r in rows]


class LintCache:
    def __init__(self, root: str, cache_dir: str = CACHE_DIR):
        self.root = root
        self.path = os.path.join(root, cache_dir, "results.json")
        self.version = self._toolchain_sig()
        self.dirty = False
        self.data: dict = {"version": self.version, "files": {},
                           "trees": {}}
        try:
            with open(self.path, encoding="utf-8") as f:
                loaded = json.load(f)
            if loaded.get("version") == self.version:
                self.data = loaded
        except (OSError, ValueError):
            # vtplint: disable=except-pass (a missing or torn cache file IS the cold-cache outcome; the pass re-runs and rewrites it)
            pass

    def _toolchain_sig(self) -> str:
        h = hashlib.sha256()
        for rel in _TOOLCHAIN:
            h.update(rel.encode())
            h.update(str(file_sig(os.path.join(self.root, rel)))
                     .encode())
        return h.hexdigest()[:16]

    # -- per-file ------------------------------------------------------

    def get_file(self, pass_name: str,
                 path: str) -> Optional[List[Finding]]:
        entry = self.data["files"].get(f"{pass_name}:{path}")
        if entry is None or entry.get("sig") != file_sig(path):
            return None
        return _decode(entry["findings"])

    def put_file(self, pass_name: str, path: str,
                 findings: List[Finding]) -> None:
        self.data["files"][f"{pass_name}:{path}"] = {
            "sig": file_sig(path), "findings": _encode(findings)}
        self.dirty = True

    # -- per-tree ------------------------------------------------------

    def tree_sig(self, paths: List[str]) -> str:
        h = hashlib.sha256()
        for p in sorted(paths):
            h.update(p.encode())
            h.update(str(file_sig(p)).encode())
        return h.hexdigest()[:16]

    def get_tree(self, pass_name: str,
                 sig: str) -> Optional[List[Finding]]:
        entry = self.data["trees"].get(pass_name)
        if entry is None or entry.get("sig") != sig:
            return None
        return _decode(entry["findings"])

    def put_tree(self, pass_name: str, sig: str,
                 findings: List[Finding]) -> None:
        self.data["trees"][pass_name] = {
            "sig": sig, "findings": _encode(findings)}
        self.dirty = True

    # -- persistence ---------------------------------------------------

    def save(self) -> None:
        if not self.dirty:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.data, f)
        os.replace(tmp, self.path)
        self.dirty = False

"""vtplint — the project-native invariant linter (CLI) over the port.

Runs four passes over the tree and prints one merged report:

  rules      AST project rules (volcano_tpu_torch/analysis/astlint.py):
             req-id, wall-clock, metric-family, metric-labels,
             append-lock, except-pass — plus unexplained-suppression
             for any waiver without a reason.
  race       the snapshot-ownership pass (analysis/racecheck.py):
             functions reachable from the predicate/nodeOrder/
             batchNodeOrder/fit_class call trees are classified
             snapshot-readers; snapshot-write and
             shared-cache-unkeyed flag mutations that would race the
             parallel sweep.
  flakes     pyflakes when installed, the conservative built-in
             fallback otherwise (syntax errors, unused imports).
  registry   runtime cross-checks: codec wire round-trips, store
             kind registry, metric family/label-schema coverage.

Results are cached in .vtplint_torch_cache/ keyed by file mtime+size and
the toolchain's own sources (analysis/lintcache.py), so the growing
rule set keeps the tier-1 gate's wall time flat: an unchanged tree
replays instantly, an edit re-lints just that file (plus the
whole-program race pass).

Usage:
    python -m volcano_tpu_torch.analysis.vtplint [--strict] [--json] [--report OUT.json]
                            [--no-flakes] [--no-registry] [--no-race]
                            [--no-cache] [paths...]

--strict exits 1 on ANY unsuppressed finding (tier-1 runs this via
tests/test_torch_lint.py).  Suppressed findings are listed as the
suppression inventory — an explained waiver is part of the contract,
an unexplained one fails strict.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_PATHS = ("volcano_tpu_torch",)


def _py_files(paths):
    files = []
    for path in paths:
        if os.path.isfile(path):
            files.append(path)
            continue
        for root, dirs, fnames in os.walk(path):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            files.extend(os.path.join(root, f) for f in sorted(fnames)
                         if f.endswith(".py"))
    return files


def run(paths, flakes: bool = True, registry: bool = True,
        race: bool = True, cache=None):
    """(active findings, suppressed findings) over the given paths."""
    from volcano_tpu_torch.analysis import astlint
    from volcano_tpu_torch.analysis import flakes as flakes_mod
    from volcano_tpu_torch.analysis import racecheck
    from volcano_tpu_torch.analysis import registry as registry_mod

    files = _py_files(paths)
    findings = []
    linter = astlint.Linter()
    for fpath in files:
        per_file = None
        if cache is not None:
            per_file = cache.get_file("rules", fpath)
        if per_file is None:
            per_file = linter.lint_file(fpath)
            if cache is not None:
                cache.put_file("rules", fpath, per_file)
        findings.extend(per_file)
        if flakes:
            fl = cache.get_file("flakes", fpath) \
                if cache is not None else None
            if fl is None:
                with open(fpath, encoding="utf-8") as f:
                    fl = flakes_mod.check_source(f.read(), fpath)
                if cache is not None:
                    cache.put_file("flakes", fpath, fl)
            findings.extend(fl)
    if race:
        domain = [f for f in files if racecheck.in_domain(f)]
        rf = None
        sig = ""
        if cache is not None:
            sig = cache.tree_sig(domain)
            rf = cache.get_tree("race", sig)
        if rf is None:
            rf = racecheck.check_paths(paths)
            if cache is not None:
                cache.put_tree("race", sig, rf)
        findings.extend(rf)
    if registry:
        findings += registry_mod.check_all()
    if cache is not None:
        cache.save()
    active = [f for f in findings if f.suppressed is None]
    suppressed = [f for f in findings if f.suppressed is not None]
    return active, suppressed


def doc(active, suppressed) -> dict:
    return {
        "findings": len(active),
        "rule_counts": dict(sorted(Counter(
            f.rule for f in active).items())),
        "suppressions": [
            {"rule": f.rule, "site": f"{f.path}:{f.line}",
             "reason": f.suppressed} for f in suppressed],
        "details": [
            {"rule": f.rule, "site": f"{f.path}:{f.line}",
             "msg": f.msg} for f in active],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vtplint", description=__doc__)
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS))
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unsuppressed finding")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report instead of lines")
    ap.add_argument("--report", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--no-flakes", action="store_true")
    ap.add_argument("--no-registry", action="store_true")
    ap.add_argument("--no-race", action="store_true")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass .vtplint_torch_cache/ (cold full run)")
    args = ap.parse_args(argv)

    os.chdir(REPO)
    cache = None
    if not args.no_cache:
        from volcano_tpu_torch.analysis.lintcache import LintCache
        cache = LintCache(REPO)
    active, suppressed = run(args.paths or list(DEFAULT_PATHS),
                             flakes=not args.no_flakes,
                             registry=not args.no_registry,
                             race=not args.no_race,
                             cache=cache)
    report = doc(active, suppressed)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for f in active:
            print(f.format())
        if suppressed:
            print(f"-- {len(suppressed)} suppressed "
                  f"(explained waivers):")
            for f in suppressed:
                print(f"   {f.format()}")
        print(f"vtplint: {len(active)} finding(s), "
              f"{len(suppressed)} suppression(s)")
    if args.strict and active:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Project-native static analysis + runtime concurrency auditing.

The concurrency and wire invariants this control plane bled for —
fsync-before-ack, merge-under-one-lock-hold, monotonic-only leases,
bounded metric labels, idempotency keys on mutating POSTs — used to
live in CHANGES.md prose and scattered per-PR tests.  Before the
scheduler cycle goes parallel (ROADMAP item 3), they are enforced by
tooling that fails tier-1, not by reviewer memory:

  astlint.py    AST rules over the whole package (req-id, wall-clock,
                metric-family, metric-labels, append-lock, except-pass)
                with inline ``# vtplint: disable=<rule> (<reason>)``
                suppressions — a suppression without a reason is
                itself a finding.
  flakes.py     a pyflakes-shaped pass (syntax, unused imports) that
                uses the real pyflakes when installed and a built-in
                conservative fallback when not (this image bakes no
                linters in).
  registry.py   runtime registry cross-checks: every codec wire class
                round-trips, every store kind exists, every generated
                metric family is declared.
  schema.py     the metric label schema checker over a live
                Prometheus exposition (bundle.FAMILY_LABELS is the
                declaration; this is the enforcement) — subsumes the
                per-PR label-cardinality tests.
  lockaudit.py  opt-in runtime lock-order auditor in the faults.py
                mold: wraps threading.Lock/RLock/Condition creation,
                records the acquisition graph, fails on inversions/
                cycles/guarded-store mutation without the owning lock.

``tools/vtplint.py`` is the CLI over all of it; ``tests/test_lint.py``
wires it into tier-1.  Keep this module import-light: lockaudit is
imported from ``volcano_tpu_torch/__init__`` when VTP_LOCK_AUDIT is set,
before any lock exists.
"""

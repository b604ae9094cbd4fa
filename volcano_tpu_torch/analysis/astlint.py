"""AST rules for the project's own invariants (the vtplint core).

Each rule exists because a real incident or review burned us (the
catalog with provenance lives in docs/design/static-analysis.md):

  req-id         a mutating wire POST through the client's _request
                 seam must carry an idempotency key
                 (idempotency_key=True) or be explicitly suppressed as
                 replay-safe-by-state-compare — the double-apply
                 class.
  wall-clock     time.time() is banned in the lease/WAL/election
                 paths (server/durability.py, server/state_server.py,
                 server/replication.py, and any function named like a
                 lease/election/wal path elsewhere): deadlines are
                 monotonic-only; wall time appears only where the
                 wire/disk format needs it, suppressed with the
                 rebase story.
  metric-family  every literal metric name at an emission site must
                 be declared in bundle.FAMILIES (dashboards and the
                 scrape contract are generated from that table).
  metric-labels  label keyword keys must be declared for the family
                 in bundle.FAMILY_LABELS, and literal label values of
                 enum-typed labels must be members — the bounded-
                 cardinality contract, statically.
  append-lock    a durable append (self.durable.append*/append_event)
                 in server code must happen inside a lock-holding
                 ``with`` block, so WAL order cannot drift from the
                 order the lock assigned (rv order == journal order
                 is what makes replay exact).  Order-independent
                 records suppress with the reason.
  except-pass    a broad exception handler that silently swallows
                 (pass/continue-only body) around wire/disk I/O —
                 gray failures must be counted or classified, never
                 eaten.
  process-ship-purity
                 in any module touching multiprocessing, a pipe
                 ``.send(...)``/``.send_bytes(...)`` may only happen
                 inside the designated ship seam
                 (actions/procpool.post/post_bytes), whose pickler
                 REFUSES callables — the pickled-callback purity
                 contract of the process-pool sweep: worker behavior
                 comes from worker-side resolution, never from
                 shipped code.
  episode-propagation
                 a function POSTing a mutating federation RPC
                 (add_vcjob / delete_vcjob / update_podgroup_status /
                 reap_residuals through FedRPC.call) or opening a
                 controller episode (FailoverEpisode / ResizeEpisode)
                 must thread the causal episode ID — reference the
                 episode API (episode_of/ensure_episode/FED_EPISODE*)
                 or pass episode= — or carry a reasoned waiver.  A
                 cross-plane hop that drops the ID is invisible to
                 `GET /fleet_trace?episode=`: the stitched tree holes
                 exactly where the bug is.
  fed-retry      in volcano_tpu_torch/federation/ (except retry.py, which
                 IS the policy), a retry loop may not sleep a fixed
                 literal delay: every cross-region wait goes through
                 federation.retry.backoff_delay (capped exponential,
                 deterministic jitter — seeded chaos replays exactly)
                 or the FedRPC breaker.  A fleet of routers/mirrors
                 hot-looping a constant delay against a struggling
                 region is a synchronized retry stampede.

Suppressions: ``# vtplint: disable=<rule>[,<rule>] (<reason>)`` on the
finding's line or the line above.  A suppression WITHOUT a
parenthesized reason is reported as ``unexplained-suppression`` and
fails --strict: the inventory of explained suppressions is part of
the shipped artifact, a reason-free one is just a muted bug.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

RULES = ("req-id", "wall-clock", "metric-family", "metric-labels",
         "append-lock", "except-pass", "process-ship-purity",
         "fed-retry", "episode-propagation")

SUPPRESS_RE = re.compile(
    r"#\s*vtplint:\s*disable=([a-z0-9*,_-]+)(?:\s*\(([^)]+)\))?")

# wall-clock rule scope: the monotonic-only files...
WALL_CLOCK_FILES = ("server/durability.py", "server/state_server.py",
                    "server/replication.py")
# ...and, anywhere else, functions that ARE a lease/election/WAL path
WALL_CLOCK_FN = re.compile(r"lease|election|campaign|promote|_wal",
                           re.IGNORECASE)

# append-lock rule scope (the callers of the durability seam; the
# DurableStore implementation takes its own internal lock)
APPEND_LOCK_FILES = ("server/state_server.py", "server/replication.py")
APPEND_METHODS = frozenset({"append", "append_event", "append_shipped"})

# process-ship-purity: the only functions allowed to call a pipe send
# (both live in actions/procpool.py and route through the pure
# pickler that refuses callables)
SHIP_SEAMS = frozenset({"post", "post_bytes"})
SHIP_SENDS = frozenset({"send", "send_bytes"})

# fed-retry rule scope: the federation tier, minus the shared policy
# module itself (its constants ARE the delays)
FED_RETRY_DIR = "volcano_tpu_torch/federation/"
FED_RETRY_EXEMPT = ("federation/retry.py",)
SLEEP_METHODS = frozenset({"sleep", "wait"})

# episode-propagation scope: the mutating federation RPC verbs that
# move a gang between planes (advance_fence is term plumbing, not a
# causal hop), the controllers' episode state machines, and the names
# whose presence in the enclosing function counts as threading the ID
FED_MUTATING_OPS = frozenset({"add_vcjob", "delete_vcjob",
                              "update_podgroup_status",
                              "reap_residuals"})
EPISODE_CTORS = frozenset({"FailoverEpisode", "ResizeEpisode"})
EPISODE_CTOR_DIR = "volcano_tpu_torch/controllers/"
EPISODE_API = frozenset({"episode", "episode_id", "episode_of",
                         "episode_hop", "episode_ts",
                         "ensure_episode"})

EMIT_METHODS = frozenset({"inc", "observe", "set_gauge"})
READ_METHODS = frozenset({"get_gauge", "get_counter",
                          "get_observations", "quantile",
                          "clear_gauge_series"})

BROAD_EXCEPTS = frozenset({"Exception", "BaseException", "OSError",
                           "IOError"})
IO_HINTS = frozenset({
    "open", "open_append", "urlopen", "fsync", "unlink", "rename",
    "remove", "makedirs", "rmtree", "replace", "truncate", "getsize",
    "sendall", "recv", "connect", "setsockopt", "shutdown",
    "_request", "_request_once", "http_json", "read", "write",
    "readlines", "flush",
})


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    msg: str
    suppressed: Optional[str] = None    # the reason text when waived

    def format(self) -> str:
        tag = f" [suppressed: {self.suppressed}]" if self.suppressed \
            else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}{tag}"


def _suppressions(src: str) -> Dict[int, Tuple[Set[str], str]]:
    """line -> (rules, reason).  reason '' == unexplained."""
    out: Dict[int, Tuple[Set[str], str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r}
            out[i] = (rules, (m.group(2) or "").strip())
    return out


def _attr_chain(node: ast.AST) -> str:
    """Dotted-source-ish rendering of an attribute chain for matching
    ("self.durable.append" -> "self.durable.append")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _Enums:
    """Lazy resolver for 'enum:<module>:<NAME>' label specs."""

    def __init__(self) -> None:
        self._cache: Dict[str, tuple] = {}

    def resolve(self, spec) -> Optional[tuple]:
        if isinstance(spec, (tuple, list, set, frozenset)):
            return tuple(spec)
        if isinstance(spec, str) and spec.startswith("enum:"):
            if spec not in self._cache:
                import importlib
                _, mod, name = spec.split(":", 2)
                self._cache[spec] = tuple(
                    getattr(importlib.import_module(mod), name))
            return self._cache[spec]
        return None        # CONFIG / OBJECT: not statically checkable


def match_waivers(findings, src: str, path: str) -> List[Finding]:
    """Match raw findings against *src*'s inline suppressions (shared
    by the AST rules and the racecheck ownership pass).

    The waiver may sit on the finding's line or the line above;
    except-pass alone also honours the first handler-body line (the
    comment rides next to the ``pass`` it explains).  The window stays
    this tight on purpose: a wider one would let a NEW violation
    written adjacent to an existing waiver inherit that waiver's
    reason.  Every candidate is checked for the rule (a neighboring
    waiver for a different rule never shadows a match)."""
    sup = _suppressions(src)
    out: List[Finding] = []
    for f in findings:
        lines = [f.line, f.line - 1]
        if f.rule == "except-pass":
            lines.append(f.line + 1)
        waiver = next(
            (w for w in (sup.get(ln) for ln in lines)
             if w and (f.rule in w[0] or "*" in w[0])), None)
        if waiver:
            f.suppressed = waiver[1] or None
            if not waiver[1]:
                out.append(Finding(
                    "unexplained-suppression", path, f.line,
                    f"suppression of [{f.rule}] carries no "
                    f"(reason) — every waiver must say why"))
        out.append(f)
    return out


class Linter:
    """One AST pass over one file; yields Findings (already matched
    against the file's inline suppressions)."""

    def __init__(self, families: Optional[dict] = None,
                 family_labels: Optional[dict] = None):
        if families is None or family_labels is None:
            from volcano_tpu_torch.bundle import FAMILIES, FAMILY_LABELS
            families = FAMILIES if families is None else families
            family_labels = FAMILY_LABELS if family_labels is None \
                else family_labels
        self.families = families
        self.family_labels = family_labels
        self._enums = _Enums()

    # -- entry ----------------------------------------------------------

    def lint_source(self, src: str, path: str) -> List[Finding]:
        rel = path.replace("\\", "/")
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            return [Finding("syntax-error", path, e.lineno or 0,
                            f"cannot parse: {e.msg}")]
        return match_waivers(self._walk(tree, rel), src, path)

    def lint_file(self, path: str) -> List[Finding]:
        with open(path, encoding="utf-8") as f:
            return self.lint_source(f.read(), path)

    # -- the pass -------------------------------------------------------

    def _walk(self, tree: ast.AST, rel: str) -> Iterator[Finding]:
        in_scope_file = rel.endswith(WALL_CLOCK_FILES)
        append_scope = rel.endswith(APPEND_LOCK_FILES)
        is_metrics_impl = rel.endswith("volcano_tpu_torch/metrics.py")
        fed_scope = FED_RETRY_DIR in rel and \
            not rel.endswith(FED_RETRY_EXEMPT)
        fed_flagged: Set[int] = set()
        ctor_scope = EPISODE_CTOR_DIR in rel
        ship_scope = rel.endswith("actions/procpool.py") or any(
            (isinstance(n, ast.Import)
             and any(a.name.split(".")[0] == "multiprocessing"
                     for a in n.names))
            or (isinstance(n, ast.ImportFrom) and n.module
                and n.module.split(".")[0] == "multiprocessing")
            for n in ast.walk(tree))
        # ancestor context maintained by an explicit stack walk
        fn_stack: List[str] = []
        fn_nodes: List[ast.AST] = []
        lock_depth = [0]        # with-a-lock nesting count
        threads_cache: Dict[int, bool] = {}

        def threads_episode() -> bool:
            """Does the INNERMOST enclosing function reference the
            episode API anywhere in its body?  (Module-level code is
            never a hop — only reconcile/controller functions move
            gangs.)"""
            if not fn_nodes:
                return True
            fn = fn_nodes[-1]
            key = id(fn)
            if key not in threads_cache:
                threads_cache[key] = _references_episode(fn)
            return threads_cache[key]

        def locky(withitem: ast.withitem) -> bool:
            try:
                src = ast.unparse(withitem.context_expr)
            except Exception:  # noqa: BLE001 — unparse is best-effort
                return False
            return bool(re.search(r"lock|_cv|mutex", src, re.I))

        def visit(node: ast.AST) -> Iterator[Finding]:
            pushed_fn = False
            pushed_lock = False
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                fn_stack.append(node.name)
                fn_nodes.append(node)
                pushed_fn = True
            if isinstance(node, ast.With) and \
                    any(locky(i) for i in node.items):
                lock_depth[0] += 1
                pushed_lock = True
            if isinstance(node, ast.Call):
                yield from check_call(node)
            if isinstance(node, ast.Try):
                yield from check_try(node)
            if isinstance(node, (ast.While, ast.For)):
                yield from check_retry_loop(node)
            for child in ast.iter_child_nodes(node):
                yield from visit(child)
            if pushed_fn:
                fn_stack.pop()
                fn_nodes.pop()
            if pushed_lock:
                lock_depth[0] -= 1

        def check_call(node: ast.Call) -> Iterator[Finding]:
            chain = _attr_chain(node.func)
            attr = chain.rsplit(".", 1)[-1]

            # req-id --------------------------------------------------
            if attr == "_request" and node.args:
                method = _literal_str(node.args[0])
                if method == "POST":
                    keyed = any(
                        kw.arg == "idempotency_key" for kw in
                        node.keywords)
                    if not keyed:
                        route = _literal_str(node.args[1]) \
                            if len(node.args) > 1 else "?"
                        yield Finding(
                            "req-id", rel, node.lineno,
                            f"mutating POST {route or '<dynamic>'} "
                            f"without idempotency_key=True (_req_id): "
                            f"a retried ack-lost mutation may "
                            f"double-apply")

            # wall-clock ----------------------------------------------
            if chain == "time.time":
                in_scope = in_scope_file or any(
                    WALL_CLOCK_FN.search(fn) for fn in fn_stack)
                if in_scope:
                    yield Finding(
                        "wall-clock", rel, node.lineno,
                        "time.time() in a lease/WAL/election path — "
                        "deadlines are monotonic-only (a wall jump "
                        "mass-expires or immortalizes leases)")

            # append-lock ---------------------------------------------
            if append_scope and attr in APPEND_METHODS and \
                    "durable" in chain.split("."):
                if lock_depth[0] == 0:
                    yield Finding(
                        "append-lock", rel, node.lineno,
                        f"{chain}(...) outside a lock-holding `with` "
                        f"block: journal order may drift from the "
                        f"order the lock assigned")

            # process-ship-purity -------------------------------------
            if ship_scope and attr in SHIP_SENDS and \
                    isinstance(node.func, ast.Attribute):
                if not (fn_stack and fn_stack[-1] in SHIP_SEAMS):
                    yield Finding(
                        "process-ship-purity", rel, node.lineno,
                        f"{chain}(...) outside the ship seam "
                        f"(procpool.post/post_bytes): every cross-"
                        f"process payload must go through the pure "
                        f"pickler that refuses callables")

            # episode-propagation -------------------------------------
            if fed_scope and attr == "call" and \
                    "rpc" in chain.split(".") and len(node.args) >= 2:
                op = _literal_str(node.args[1])
                if op in FED_MUTATING_OPS and not threads_episode():
                    yield Finding(
                        "episode-propagation", rel, node.lineno,
                        f"mutating federation RPC {op!r} without "
                        f"threading the causal episode ID "
                        f"(episode_of/ensure_episode/FED_EPISODE*) — "
                        f"this hop would be invisible to "
                        f"GET /fleet_trace?episode=")
            if ctor_scope and \
                    chain.rsplit(".", 1)[-1] in EPISODE_CTORS and \
                    not threads_episode():
                yield Finding(
                    "episode-propagation", rel, node.lineno,
                    f"{chain.rsplit('.', 1)[-1]} opened without "
                    f"threading the causal episode ID — the "
                    f"controller's drain/recovery fragment would "
                    f"detach from the fleet trace")

            # metric-family / metric-labels ---------------------------
            if not is_metrics_impl and chain.startswith("metrics."):
                yield from check_metric(node, attr)

        def check_metric(node: ast.Call,
                         attr: str) -> Iterator[Finding]:
            names: List[str] = []
            if attr in EMIT_METHODS or attr in READ_METHODS:
                fam = _literal_str(node.args[0]) if node.args else None
                if fam is not None:
                    names = [fam]
            elif attr == "swap_gauge_families":
                if node.args and isinstance(
                        node.args[0], (ast.Tuple, ast.List, ast.Set)):
                    names = [n for n in map(_literal_str,
                                            node.args[0].elts)
                             if n is not None]
            elif attr == "resource_gauge_rows":
                prefix = _literal_str(node.args[0]) if node.args \
                    else None
                if prefix is not None:
                    names = [f"{prefix}_milli_cpu",
                             f"{prefix}_memory_bytes",
                             f"{prefix}_scalar_resources"]
            else:
                return
            for fam in names:
                if fam not in self.families:
                    yield Finding(
                        "metric-family", rel, node.lineno,
                        f"metric family {fam!r} is not declared in "
                        f"bundle.FAMILIES — dashboards and the scrape "
                        f"contract are generated from that table")
            if attr not in EMIT_METHODS or not names:
                return
            fam = names[0]
            declared = self.family_labels.get(fam, {})
            for kw in node.keywords:
                if kw.arg in (None, "value"):
                    continue
                if kw.arg not in declared:
                    yield Finding(
                        "metric-labels", rel, node.lineno,
                        f"label {kw.arg!r} is not declared for family "
                        f"{fam!r} in bundle.FAMILY_LABELS")
                    continue
                allowed = self._enums.resolve(declared[kw.arg])
                val = _literal_str(kw.value)
                if allowed is not None and val is not None and \
                        val not in allowed:
                    yield Finding(
                        "metric-labels", rel, node.lineno,
                        f"label {kw.arg}={val!r} is outside the "
                        f"bounded enum for family {fam!r}")

        def check_retry_loop(node: ast.AST) -> Iterator[Finding]:
            # fed-retry: a loop that both handles exceptions AND
            # sleeps a fixed literal delay is a bare retry loop —
            # the wait must come from the shared backoff policy
            if not fed_scope:
                return
            if not any(isinstance(n, ast.Try) for n in ast.walk(node)):
                return
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or not sub.args:
                    continue
                attr = _attr_chain(sub.func).rsplit(".", 1)[-1]
                if attr not in SLEEP_METHODS:
                    continue
                arg = sub.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, (int, float)) and \
                        sub.lineno not in fed_flagged:
                    fed_flagged.add(sub.lineno)
                    yield Finding(
                        "fed-retry", rel, sub.lineno,
                        f"bare retry loop: fixed {arg.value}s delay "
                        f"in a federation retry path — use "
                        f"federation.retry.backoff_delay (capped "
                        f"exponential, deterministic jitter) or "
                        f"route the call through FedRPC, so a fleet "
                        f"of retriers never stampedes in lockstep")

        def check_try(node: ast.Try) -> Iterator[Finding]:
            if not _try_does_io(node):
                return
            for h in node.handlers:
                if _broad(h.type) and _silent(h.body):
                    what = ast.unparse(h.type) if h.type is not None \
                        else "bare except"
                    yield Finding(
                        "except-pass", rel, h.lineno,
                        f"{what} silently swallowed around wire/disk "
                        f"I/O — classify, count, or log it")

        return visit(tree)


def _references_episode(fn: ast.AST) -> bool:
    """Any mention of the episode API in *fn* counts as threading the
    ID: a read (episode_of), a mint (ensure_episode), the annotation
    constants (FED_EPISODE*), an `episode=` keyword, or a plain
    `episode` name/attribute the surrounding code assigned."""
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Name) and (
                sub.id in EPISODE_API or "FED_EPISODE" in sub.id):
            return True
        if isinstance(sub, ast.Attribute) and (
                sub.attr in EPISODE_API or "FED_EPISODE" in sub.attr):
            return True
        if isinstance(sub, ast.keyword) and sub.arg == "episode":
            return True
        if isinstance(sub, ast.arg) and sub.arg == "episode":
            return True
    return False


def _broad(t: Optional[ast.expr]) -> bool:
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in BROAD_EXCEPTS
    if isinstance(t, ast.Tuple):
        return any(_broad(e) for e in t.elts)
    return False


def _silent(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant):
            continue        # docstring / ellipsis
        return False
    return True


def _try_does_io(node: ast.Try) -> bool:
    for stmt in node.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                name = _attr_chain(sub.func).rsplit(".", 1)[-1]
                if name in IO_HINTS:
                    return True
    return False


def lint_paths(paths, families=None,
               family_labels=None) -> List[Finding]:
    """Lint every .py under the given files/directories."""
    import os
    linter = Linter(families, family_labels)
    findings: List[Finding] = []
    for path in paths:
        if os.path.isfile(path):
            findings.extend(linter.lint_file(path))
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for fname in sorted(files):
                if fname.endswith(".py"):
                    findings.extend(
                        linter.lint_file(os.path.join(root, fname)))
    return findings

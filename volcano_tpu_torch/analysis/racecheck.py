"""Static snapshot-immutability pass — the `go vet` half of race
certification for the parallel scheduler cycle (the runtime half is
analysis/freezeaudit.py).

ROADMAP item 3 fans the predicate/scoring sweep out across a pool
over a read-only snapshot.  That is only sound if every function the
sweep can reach treats the session snapshot as immutable.  This pass
makes the claim mechanical:

  1. OWNERSHIP / REACHABILITY — functions registered at the reader
     extension points (``add_predicate_fn``/``add_pre_predicate_fn``/
     ``add_node_order_fn``/``add_batch_node_order_fn``/
     ``add_grouped_batch_node_order_fn``/``add_hyper_node_order_fn``,
     or the equivalent ``add_fn("predicate", ...)`` form), plus the
     sweep machinery itself (``fit_class``/``predicate_nodes``/
     ``split_by_fit``/``prioritize_nodes``/``sweep_shard``/
     ``SpecCache.build_entry`` and the Session dispatchers), are
     classified *snapshot-readers*; classification propagates through
     the call graph by conservative name matching, STOPPING at the
     designated mutation seams (Session's five state primitives +
     ``set_job_pending_reason``, the Statement paths,
     ``record_fit_error``/``add_task``/``remove_task``/
     ``update_task_status``, ``SpecCache.invalidate``/``_admit``/
     ``_seal``) and at the locked sink modules (metrics/trace, whose
     internal order is serialized by their own locks and audited at
     runtime by lockaudit.guard_store).

  2. ``snapshot-write`` — inside a reader, any attribute/item write,
     delete, or known-mutator call (``add``/``sub``/``append``/
     ``pop``/``update``/``record_fit_error``/``heappush``/...) whose
     receiver chain roots at a snapshot object (a task/node/job/queue/
     session parameter, a local assigned from one, or ``self`` of a
     snapshot class) is flagged: under the fan-out that write races
     every concurrent reader of the same object.

  3. ``shared-cache-unkeyed`` — the same mutations rooted at PLUGIN
     or Session instance state (``self._cache[...] = ...``) or a
     module global: a memo shared across concurrent sweep calls
     without a serializing lock or per-sweep keying.

Waivers: the standard ``# vtplint: disable=<rule> (<reason>)`` form;
each reason must name the serializing lock or the single-threaded
phase that makes the write safe (docs/design/static-analysis.md).
Like every heuristic in this linter the pass over-approximates on
purpose — a reasoned waiver is the documented escape hatch, a missed
write is a 3am deadlock-free data corruption.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set

from volcano_tpu_torch.analysis.astlint import (Finding, _attr_chain,
                                          match_waivers)

RULES = ("snapshot-write", "shared-cache-unkeyed")

# reader registration seams: ssn.add_predicate_fn(name, fn) etc.
READER_REG = frozenset({
    "add_predicate_fn", "add_pre_predicate_fn", "add_node_order_fn",
    "add_batch_node_order_fn", "add_grouped_batch_node_order_fn",
    "add_hyper_node_order_fn",
})
# ...and the add_fn("point", name, fn) spelling
READER_POINTS = frozenset({
    "predicate", "prePredicate", "nodeOrder", "batchNodeOrder",
    "groupedBatchNodeOrder", "hyperNodeOrder",
})

# sweep machinery roots by bare name / qualname
ROOT_NAMES = frozenset({
    "fit_class", "predicate_nodes", "split_by_fit",
    "prioritize_nodes", "sweep_shard",
})
ROOT_QUALS = frozenset({
    "SpecCache.build_entry", "SpecCache._build_serial",
    "SpecCache._build_parallel",
    "Session.predicate", "Session.predicate_for_preempt",
    "Session._run_predicates", "Session.pre_predicate",
    "Session.node_order", "Session.batch_node_order",
    "Session.grouped_batch_node_order", "Session.hyper_node_order",
})

# the designated mutation seams: reachability stops here, and a
# rooted mutating CALL to one of these from a reader is reported at
# the call site (record_fit_error below)
SEAM_QUALS = frozenset({
    "Session.allocate", "Session.pipeline", "Session.evict",
    "Session.deallocate", "Session.unevict",
    "Session.set_job_pending_reason",
    "Statement.allocate", "Statement.pipeline", "Statement.evict",
    "Statement.commit", "Statement.discard", "Statement.rollback_to",
    "Statement.recover_operations",
    "JobInfo.record_fit_error", "JobInfo.set_job_fit_errors",
    "JobInfo.update_task_status",
    "NodeInfo.add_task", "NodeInfo.remove_task",
    "NodeInfo.update_task_status",
    "SpecCache.invalidate", "SpecCache._admit", "SpecCache._seal",
    "SpecCache._new_entry",
})

# locked sinks: modules whose internal mutation is serialized by
# their own lock (metrics._lock / trace._lock), runtime-audited by
# lockaudit.guard_store — reachability does not descend into them
SINK_MODULES = ("volcano_tpu_torch/metrics.py", "volcano_tpu_torch/trace.py")

# The ownership domain: the scheduler-cycle code the parallel sweep
# can actually reach.  The agent's own scheduler, the state server,
# controllers, CLI and workloads run in other processes/threads with
# their own locking stories (lockaudit's beat) — including them here
# would only drown the sweep findings in same-name noise.
DOMAIN = (
    "volcano_tpu_torch/actions", "volcano_tpu_torch/plugins",
    "volcano_tpu_torch/framework", "volcano_tpu_torch/api",
    "volcano_tpu_torch/util.py", "volcano_tpu_torch/goodput.py",
    "volcano_tpu_torch/conf.py", "volcano_tpu_torch/metrics.py",
    "volcano_tpu_torch/trace.py",
)


def in_domain(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    for d in DOMAIN:
        if d.endswith(".py"):
            if rel.endswith(d):
                return True
        elif f"{d}/" in rel or rel.rstrip("/").endswith(d):
            return True
    return False

# parameter names that denote snapshot-reachable objects inside a
# reader (the framework's reader signatures use exactly these)
SNAPSHOT_PARAMS = frozenset({
    "task", "proto", "node", "nodes", "job", "jobs", "queue",
    "queues", "ssn", "session", "candidates", "candidate_nodes",
    "shard", "fit_nodes", "idle_fit", "future_fit", "hypernodes",
    "hypernode", "hn", "sub", "sub_job", "subjob", "preemptor",
    "reclaimer", "victim", "victims", "entry", "taskinfo",
    "task_info", "node_info",
})
# `self` of these classes is snapshot data (a write through self is a
# snapshot-write, not a cache write)
SNAPSHOT_CLASSES = frozenset({
    "NodeInfo", "JobInfo", "TaskInfo", "SubJobInfo", "QueueInfo",
    "HyperNode", "HyperNodeInfo", "HyperNodesInfo",
})

# receiver methods whose return value ALIASES stored state (rooted
# in, rooted out); any other call breaks the chain — e.g. clone()
# and future_idle() return fresh objects, so they are NOT here
ALIAS_CALLS = frozenset({
    "get", "values", "items", "keys", "tasks_in_status",
    "leaf_of_node", "hypernodes_covering", "members_of",
})

# known mutating methods: a rooted receiver makes the call a finding
MUTATORS = frozenset({
    "add", "sub", "sub_unchecked", "set_scalar",
    "append", "extend", "insert", "remove", "discard", "pop",
    "popitem", "clear", "update", "setdefault", "move_to_end",
    "add_task", "remove_task", "update_task_status",
    "record_fit_error", "set_error", "set_node_error",
})
HEAP_FNS = frozenset({"heappush", "heappop", "heapify",
                      "heappushpop", "heapreplace"})


class FuncInfo:
    __slots__ = ("name", "qual", "cls", "path", "node", "is_reader")

    def __init__(self, name, qual, cls, path, node):
        self.name = name
        self.qual = qual
        self.cls = cls
        self.path = path
        self.node = node
        self.is_reader = False


class Program:
    """A set of parsed sources analyzed as one ownership domain."""

    def __init__(self) -> None:
        self.sources: Dict[str, str] = {}
        self.trees: Dict[str, ast.Module] = {}
        self.funcs: List[FuncInfo] = []
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.by_qual: Dict[str, List[FuncInfo]] = {}
        self.parse_errors: List[Finding] = []

    # -- loading -------------------------------------------------------

    def add_source(self, path: str, src: str) -> None:
        rel = path.replace("\\", "/")
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            self.parse_errors.append(Finding(
                "syntax-error", rel, e.lineno or 0,
                f"cannot parse: {e.msg}"))
            return
        self.sources[rel] = src
        self.trees[rel] = tree
        self._index(rel, tree)

    def _index(self, rel: str, tree: ast.Module) -> None:
        def walk(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = f"{cls}.{child.name}" if cls else child.name
                    info = FuncInfo(child.name, qual, cls, rel, child)
                    self.funcs.append(info)
                    self.by_name.setdefault(child.name, []).append(info)
                    self.by_qual.setdefault(qual, []).append(info)
                    walk(child, cls)   # nested defs keep class ctx
                else:
                    walk(child, cls)

        walk(tree, None)

    # -- roots ---------------------------------------------------------

    def _roots(self) -> List[FuncInfo]:
        roots: List[FuncInfo] = []
        for name in ROOT_NAMES:
            roots.extend(self.by_name.get(name, ()))
        for qual in ROOT_QUALS:
            roots.extend(self.by_qual.get(qual, ()))
        # registration sites: ssn.add_predicate_fn(self.name, self._fn)
        for rel, tree in self.trees.items():
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                attr = _attr_chain(node.func).rsplit(".", 1)[-1]
                fn_arg = None
                if attr in READER_REG and len(node.args) >= 2:
                    fn_arg = node.args[1]
                elif attr == "add_fn" and len(node.args) >= 3:
                    point = node.args[0]
                    if isinstance(point, ast.Constant) and \
                            point.value in READER_POINTS:
                        fn_arg = node.args[2]
                if fn_arg is None:
                    continue
                fn_name = None
                if isinstance(fn_arg, ast.Attribute):
                    fn_name = fn_arg.attr
                elif isinstance(fn_arg, ast.Name):
                    fn_name = fn_arg.id
                if not fn_name:
                    continue
                cands = [f for f in self.by_name.get(fn_name, ())
                         if f.path == rel] or \
                    self.by_name.get(fn_name, [])
                roots.extend(cands)
        return roots

    # -- reachability --------------------------------------------------

    def classify(self) -> None:
        work = list(self._roots())
        while work:
            fn = work.pop()
            if fn.is_reader:
                continue
            if fn.qual in SEAM_QUALS or fn.path.endswith(SINK_MODULES):
                continue
            fn.is_reader = True
            for callee in self._callees(fn):
                if not callee.is_reader:
                    work.append(callee)

    def _callees(self, fn: FuncInfo) -> Iterable[FuncInfo]:
        seen: Set[int] = set()
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # calls named like known mutators/aliases are judged at
            # the CALL SITE (rooted receiver => finding); descending
            # into every same-named def (dict.pop vs PriorityQueue.pop
            # vs Resource.add) only manufactures unrelated readers
            name = func.attr if isinstance(func, ast.Attribute) else \
                getattr(func, "id", "")
            if name in MUTATORS or name in ALIAS_CALLS or \
                    name in HEAP_FNS or name in ("push", "pop"):
                continue
            targets: List[FuncInfo] = []
            if isinstance(func, ast.Name):
                # plain call: resolve against known defs anywhere
                targets = self.by_name.get(func.id, [])
            elif isinstance(func, ast.Attribute):
                # method call: resolve by bare name.  self.X prefers
                # the same class; Class.X (capitalized receiver)
                # resolves to that class
                cands = self.by_name.get(func.attr, [])
                base = func.value
                if isinstance(base, ast.Name) and base.id == "self" \
                        and fn.cls:
                    same = [c for c in cands if c.cls == fn.cls]
                    targets = same or cands
                elif isinstance(base, ast.Name) and base.id[:1].isupper():
                    targets = [c for c in cands if c.cls == base.id] \
                        or cands
                else:
                    targets = cands
            for t in targets:
                if id(t) not in seen:
                    seen.add(id(t))
                    yield t

    # -- per-reader mutation scan -------------------------------------

    def analyze(self) -> List[Finding]:
        self.classify()
        raw: Dict[str, List[Finding]] = {}
        for fn in self.funcs:
            if not fn.is_reader:
                continue
            if fn.qual in SEAM_QUALS or fn.path.endswith(SINK_MODULES):
                continue
            for f in _scan_reader(fn):
                raw.setdefault(fn.path, []).append(f)
        findings: List[Finding] = list(self.parse_errors)
        for rel, fs in raw.items():
            findings.extend(match_waivers(fs, self.sources[rel], rel))
        return findings

    def readers(self) -> List[str]:
        """The classified reader set (for reports/debugging)."""
        return sorted({f"{f.path}:{f.qual}" for f in self.funcs
                       if f.is_reader})


def _param_names(node) -> List[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _scan_reader(fn: FuncInfo) -> List[Finding]:
    """Taint params -> locals, then flag rooted mutations."""
    rooted: Dict[str, str] = {}      # name -> "snap" | "shared"
    for p in _param_names(fn.node):
        if p in SNAPSHOT_PARAMS:
            rooted[p] = "snap"
        elif p == "self":
            rooted[p] = "snap" if fn.cls in SNAPSHOT_CLASSES \
                else "shared"

    def chain_kind(expr) -> Optional[str]:
        """Root kind of an expression chain, or None (fresh/local)."""
        while True:
            if isinstance(expr, ast.Name):
                return rooted.get(expr.id)
            if isinstance(expr, ast.Attribute):
                expr = expr.value
                continue
            if isinstance(expr, ast.Subscript):
                expr = expr.value
                continue
            if isinstance(expr, ast.Call):
                f = expr.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in ALIAS_CALLS:
                    expr = f.value
                    continue
                return None
            return None

    # forward taint to fixpoint: x = <rooted>, for x in <rooted>,
    # with <rooted> as x
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn.node):
            tgt = None
            src = None
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                tgt, src = node.targets[0].id, node.value
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name):
                tgt, src = node.target.id, node.iter
            elif isinstance(node, ast.withitem) and \
                    node.optional_vars is not None and \
                    isinstance(node.optional_vars, ast.Name):
                tgt, src = node.optional_vars.id, node.context_expr
            if tgt is None or tgt in rooted:
                continue
            kind = chain_kind(src)
            if kind is not None:
                rooted[tgt] = kind
                changed = True

    findings: List[Finding] = []

    def flag(kind: str, line: int, what: str) -> None:
        if kind == "snap":
            findings.append(Finding(
                "snapshot-write", fn.path, line,
                f"{fn.qual}: {what} mutates snapshot-reachable state "
                f"inside a snapshot-reader — under the parallel sweep "
                f"this write races every concurrent reader; move it "
                f"behind a mutation seam or waive with the "
                f"serializing lock/phase"))
        else:
            findings.append(Finding(
                "shared-cache-unkeyed", fn.path, line,
                f"{fn.qual}: {what} mutates shared instance/module "
                f"state inside a snapshot-reader — concurrent sweep "
                f"calls share this cache unsynchronized; key it per "
                f"sweep, guard it, or waive with the lock/phase"))

    def render(expr) -> str:
        try:
            return ast.unparse(expr)
        except Exception:  # noqa: BLE001 — unparse is best-effort
            return "<expr>"

    for node in ast.walk(fn.node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    kind = chain_kind(t.value)
                    if kind is not None:
                        flag(kind, node.lineno,
                             f"assignment to {render(t)}")
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    kind = chain_kind(t.value)
                    if kind is not None:
                        flag(kind, node.lineno, f"del {render(t)}")
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                name = func.attr
                if name in MUTATORS:
                    kind = chain_kind(func.value)
                    if kind is not None:
                        flag(kind, node.lineno,
                             f"{render(func)}(...) [known mutator]")
                elif name in HEAP_FNS and node.args:
                    kind = chain_kind(node.args[0])
                    if kind is not None:
                        flag(kind, node.lineno,
                             f"heapq.{name} on {render(node.args[0])}")
            elif isinstance(func, ast.Name) and func.id in HEAP_FNS \
                    and node.args:
                kind = chain_kind(node.args[0])
                if kind is not None:
                    flag(kind, node.lineno,
                         f"{func.id} on {render(node.args[0])}")
    return findings


# -- entry points -----------------------------------------------------

def build_program(paths) -> Program:
    prog = Program()
    for path in paths:
        if os.path.isfile(path):
            if in_domain(path):
                with open(path, encoding="utf-8") as f:
                    prog.add_source(path, f.read())
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(root, fname)
                if not in_domain(fpath):
                    continue
                with open(fpath, encoding="utf-8") as f:
                    prog.add_source(fpath, f.read())
    return prog


def check_paths(paths) -> List[Finding]:
    """Analyze every .py under *paths* as one ownership domain."""
    return build_program(paths).analyze()


def check_sources(sources: Dict[str, str]) -> List[Finding]:
    """Analyze an in-memory file set (the broken-fixture tests)."""
    prog = Program()
    for path, src in sources.items():
        prog.add_source(path, src)
    return prog.analyze()

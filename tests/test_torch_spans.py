"""The port's profiler ranges (`volcano_tpu_torch.workloads.spans`) on
the CPU with the tiny config: free when no profiler runs, and under
`torch.profiler` each forward part's ops inside its range and each
backward node inside the `.bwd` range of exactly the parts whose
forward made it."""

import ast
import contextlib
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from perfbench.metrics import _spans as span_readers
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import serve as tserve
from volcano_tpu_torch.workloads import spans
from volcano_tpu_torch.workloads import train as tt

REPO = Path(__file__).resolve().parents[1]
EVAL = "autograd::engine::evaluate_function: "


def _cfg(**kw):
    return tm.tiny_config(**kw)


def _params(cfg):
    return tm.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.device("cpu"))


def _tokens(cfg, b=2, t=16):
    return torch.randint(0, cfg.vocab_size, (b, t),
                         generator=torch.Generator().manual_seed(1))


def _events(fn, tmp):
    """The complete events of a CPU profile of fn(), sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0)))


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["cat"] == "user_annotation" and e["name"] == name]


def _inside(ts, ranges):
    return any(a <= ts <= b for a, b in ranges)


def _nodes(loss):
    """The names of the autograd graph's nodes, depth first from loss."""
    out, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        out.append(node.name())
        todo.extend(n for n, _ in node.next_functions)
    return out


@pytest.fixture(scope="module")
def train_trace(tmp_path_factory):
    """One bf16 train step under the profiler (after one untraced)."""
    cfg = _cfg(dtype=torch.bfloat16)
    params = _params(cfg)
    opt = tt.make_optimizer()
    state = opt.init(params)
    step = tt.make_train_step(cfg, opt)
    batch = {"tokens": _tokens(cfg)}
    step(params, state, batch)
    return cfg, _events(lambda: step(params, state, batch),
                        tmp_path_factory.mktemp("train"))


@pytest.fixture(scope="module")
def moe_trace(tmp_path_factory):
    """One bf16 train step of the tiny MoE model (every odd block's MLP
    routed) under the profiler."""
    cfg = _cfg(n_experts=4, moe_capacity_factor=1.5, dtype=torch.bfloat16)
    params = _params(cfg)
    opt = tt.make_optimizer()
    state = opt.init(params)
    step = tt.make_train_step(cfg, opt)
    batch = {"tokens": _tokens(cfg)}
    return cfg, _events(lambda: step(params, state, batch),
                        tmp_path_factory.mktemp("moe"))


@pytest.fixture(scope="module")
def forward_trace(tmp_path_factory):
    cfg = _cfg(dtype=torch.bfloat16)
    params, tokens = _params(cfg), _tokens(cfg)

    def fwd():
        with torch.inference_mode():
            tm.forward(params, tokens, cfg)
    return cfg, _events(fwd, tmp_path_factory.mktemp("forward"))


# -- (a) free without a profiler ----------------------------------------

@pytest.mark.parametrize("name", spans.NAMES)
def test_span_is_one_shared_null_context_without_a_profiler(name):
    assert not spans.profiling()
    ctx = spans.span(name)
    assert isinstance(ctx, contextlib.nullcontext)
    assert ctx is spans.span("vtp::other")


@pytest.mark.parametrize("case", ["no_profiler", "no_grad", "no_requires",
                                  "profiled"])
def test_markers_leave_their_tensors_alone(case):
    x = torch.ones(3, requires_grad=case != "no_requires")
    with contextlib.ExitStack() as stack:
        if case != "no_profiler":
            stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        if case == "no_grad":
            stack.enter_context(torch.no_grad())
        bwd = spans.mark_in(x, "vtp::norm")
        y = x * 2
        z = spans.mark_out(y, bwd)
    assert z is y
    assert (bwd is None) == (case != "profiled")


def _stripped(monkeypatch):
    null = contextlib.nullcontext()
    for mod in (tm, tt):
        monkeypatch.setattr(mod, "span", lambda name: null)
    monkeypatch.setattr(tm, "mark_in", lambda x, name: None)
    monkeypatch.setattr(tm, "mark_out", lambda out, bwd: out)


def test_graphs_traced_or_not_match_the_stripped(monkeypatch):
    cfg = _cfg()
    params, batch = _params(cfg), {"tokens": _tokens(cfg)}
    leaves = tt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    plain = _nodes(tm.loss_fn(leaves, batch, cfg))
    with monkeypatch.context() as m:
        _stripped(m)
        assert _nodes(tm.loss_fn(leaves, batch, cfg)) == plain
    # the backward ranges hook nodes and add none
    with profile(activities=[ProfilerActivity.CPU]):
        assert _nodes(tm.loss_fn(leaves, batch, cfg)) == plain


def test_untraced_steps_equal_the_stripped_steps(monkeypatch):
    cfg = _cfg()
    batch = {"tokens": _tokens(cfg)}

    def three_steps():
        params = _params(cfg)
        opt = tt.make_optimizer(warmup_steps=1)
        state = opt.init(params)
        step = tt.make_train_step(cfg, opt)
        losses = [step(params, state, batch)[2]["loss"] for _ in range(3)]
        return losses, tt.value_and_grad(params, batch, cfg)[1]

    with monkeypatch.context() as m:
        _stripped(m)
        want_losses, want_grads = three_steps()
    losses, grads = three_steps()
    assert [float(x) for x in losses] == [float(x) for x in want_losses]
    for g, w in zip(tt.leaves(grads), tt.leaves(want_grads)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_traced_step_computes_the_untraced_loss_and_grads(dtype):
    cfg = _cfg(dtype=dtype)
    params, batch = _params(cfg), {"tokens": _tokens(cfg)}
    want_loss, want_grads = tt.value_and_grad(params, batch, cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        loss, grads = tt.value_and_grad(params, batch, cfg)
    assert torch.equal(loss, want_loss)
    for g, w in zip(tt.leaves(grads), tt.leaves(want_grads)):
        assert torch.equal(g, w)


# -- (b) under the profiler ------------------------------------------------

TRAIN_NAMES = [n for n in spans.NAMES if n != "vtp::serve.batch"]


@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_a_train_step_opens_every_span_it_reaches(train_trace, name):
    _, events = train_trace
    assert _ranges(events, name), name


@pytest.mark.parametrize("name", [p for p in spans.PARTS if p != "vtp::loss"]
                         + ["vtp::block"])
def test_an_inference_forward_opens_its_parts_and_no_backward(
        forward_trace, name):
    _, events = forward_trace
    assert _ranges(events, name)
    assert not _ranges(events, name + ".bwd")


# each part's characteristic forward op: every call of it lies inside
# one of the part's ranges
PART_OPS = [("vtp::norm", "aten::rsqrt"), ("vtp::rotary", "aten::cos"),
            ("vtp::rotary", "aten::sin"), ("vtp::attn.core", "aten::einsum"),
            ("vtp::mlp", "aten::silu"), ("vtp::loss", "aten::logsumexp"),
            ("vtp::embed", "aten::index")]


@pytest.mark.parametrize("trace_name, part, op", [
    (trace, part, op) for trace in ("train_trace", "forward_trace")
    for part, op in PART_OPS
    if (trace, part) != ("forward_trace", "vtp::loss")])
def test_forward_ops_fall_inside_their_part(request, trace_name, part, op):
    cfg, events = request.getfixturevalue(trace_name)
    forward = _ranges(events, "vtp::forward") or [(-1e30, 1e30)]
    calls = [e["ts"] for e in events if e["cat"] == "cpu_op" and
             e["name"] == op and _inside(e["ts"], forward)]
    assert calls
    assert all(_inside(ts, _ranges(events, part)) for ts in calls)


@pytest.mark.parametrize("trace_name", ["train_trace", "forward_trace"])
def test_the_head_holds_the_last_matmul_alone(request, trace_name):
    _, events = request.getfixturevalue(trace_name)
    forward = _ranges(events, "vtp::forward") or [(-1e30, 1e30)]
    calls = [e["ts"] for e in events if e["cat"] == "cpu_op" and
             e["name"] == "aten::matmul" and _inside(e["ts"], forward)]
    head = _ranges(events, "vtp::head")
    assert [ts for ts in calls if _inside(ts, head)] == calls[-1:]


@pytest.mark.parametrize("trace_name", ["train_trace", "forward_trace"])
def test_each_weight_cast_has_its_range(request, trace_name):
    cfg, events = request.getfixturevalue(trace_name)
    casts = _ranges(events, "vtp::cast")
    # q, k, v, o and the MLP's three a block, and the head
    assert len(casts) == 7 * cfg.n_layers + 1
    for a, b in casts:
        inner = [e for e in events if e["cat"] == "cpu_op" and
                 e["name"] == "aten::to" and a <= e["ts"] <= b]
        assert len(inner) == 1


def _made_in(events):
    """{sequence number: the forward op that made the node}: the last op
    inside `vtp::forward` recorded with that number."""
    forward = _ranges(events, "vtp::forward")
    out = {}
    for e in events:
        seq = (e.get("args") or {}).get("Sequence number")
        if seq is not None and e["cat"] == "cpu_op" and \
                not e["name"].startswith(EVAL) and _inside(e["ts"], forward):
            out[seq] = e
    return out


def _parts_over(ts, events, suffix=""):
    return {p for p in spans.PARTS if _inside(ts, _ranges(events, p + suffix))}


@pytest.mark.parametrize("trace_name", ["train_trace", "moe_trace"])
@pytest.mark.parametrize("part", spans.PARTS)
def test_backward_nodes_fall_in_the_bwd_ranges_of_their_parts(
        request, trace_name, part):
    _, events = request.getfixturevalue(trace_name)
    made = _made_in(events)
    backward = _ranges(events, "vtp::backward")
    # each node's own event (its engine wrapper starts before the hooks)
    nodes = [e for e in events if e["cat"] == "cpu_op" and
             not e["name"].startswith(EVAL) and
             _inside(e["ts"], backward) and
             (e.get("args") or {}).get("Sequence number") in made]
    hits = 0
    for node in nodes:
        fwd = made[node["args"]["Sequence number"]]
        in_fwd = part in _parts_over(fwd["ts"], events)
        in_bwd = part in _parts_over(node["ts"], events, ".bwd")
        assert in_fwd == in_bwd, (part, node["name"], fwd["name"])
        hits += in_fwd
    assert hits, part


# -- (c) the batched replica -----------------------------------------------

@pytest.mark.parametrize("max_batch, batches", [(1, 7), (3, 3), (8, 1)])
def test_batched_server_opens_one_range_a_batch(tmp_path, max_batch,
                                                batches):
    server = tserve.BatchedServer(
        tserve.synthetic_forward(base_ms=0.2, per_item_ms=0.0),
        max_batch=max_batch, slo_ms=1e9)

    def serve():
        for i in range(7):
            server.offer(float(i))
        assert server.drain() == 7
    events = _events(serve, tmp_path)
    ranges = _ranges(events, "vtp::serve.batch")
    assert len(ranges) == batches
    assert all(b - a >= 200 for a, b in ranges)     # the forward's 0.2 ms


# -- (d) the benchmark reads only these names ---------------------------------

READERS = sorted((REPO / "perfbench" / "metrics").glob("*.py"))


@pytest.mark.parametrize("path", READERS, ids=lambda p: p.name)
def test_every_span_a_reader_reads_is_a_program_span(path):
    literals = {n.value for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value.startswith(span_readers.PREFIX)}
    assert literals <= set(spans.NAMES) | {span_readers.PREFIX}
    name = None if path.stem.startswith("_") else \
        harness.reader(path.stem).__globals__.get("SPAN")
    if name in spans.PARTS:
        assert name + ".bwd" in spans.NAMES
    assert span_readers.BATCH in spans.NAMES
    assert all(n.startswith(span_readers.PREFIX) for n in spans.NAMES)

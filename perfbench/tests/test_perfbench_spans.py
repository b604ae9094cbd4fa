"""The readers of the program's own spans on a small canned profiler
trace: nested forward parts on the main thread, their `.bwd` ranges on
the autograd engine's thread, the optimizer's span, and operations
launched outside every span."""

import numpy as np
import pytest

from perfbench import cells, harness, trace

US = 1e-6
MAIN, ENGINE = 1, 2


def ev(cat, name, ts, dur, corr=None, tid=MAIN):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def rng(name, ts, dur, tid=MAIN):
    return ev("user_annotation", name, ts, dur, tid=tid)


def kernel(ts, dur, launch_ts, corr, tid=MAIN):
    return [ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 2, corr, tid),
            ev("kernel", "vectorized_elementwise_kernel", ts, dur, corr)]


SPANS = [
    rng("vtp::forward", 0, 500),
    rng("vtp::block", 10, 390),
    rng("vtp::norm", 20, 40),
    rng("vtp::attn", 60, 240),
    rng("vtp::cast", 70, 10),
    rng("vtp::rotary", 100, 40),
    rng("vtp::loss", 420, 60),
    rng("vtp::backward", 500, 700),
    rng("vtp::loss.bwd", 510, 50, ENGINE),
    rng("vtp::rotary.bwd", 700, 40, ENGINE),
    rng("vtp::cast.bwd", 800, 20, ENGINE),
    rng("vtp::norm.bwd", 1000, 50, ENGINE),
    rng("vtp::adamw", 1300, 400),
    rng("vtp::adamw.clip", 1300, 100),
    rng("vtp::adamw.leaves", 1400, 300),
]

OPS = [
    *kernel(40, 10, 30, 1),                 # norm
    *kernel(80, 5, 75, 2),                  # cast, inside attn
    *kernel(120, 20, 110, 3),               # rotary, inside attn
    *kernel(450, 30, 430, 4),               # loss
    *kernel(530, 15, 520, 5, ENGINE),       # loss.bwd
    *kernel(720, 8, 710, 6, ENGINE),        # rotary.bwd
    *kernel(810, 4, 805, 7, ENGINE),        # cast.bwd
    *kernel(1020, 12, 1010, 8, ENGINE),     # norm.bwd
    *kernel(1360, 40, 1350, 9),             # adamw.clip
    *kernel(1510, 60, 1500, 10),            # adamw.leaves
    *kernel(360, 5, 350, 13),               # a residual add: block only
    *kernel(610, 6, 600, 14, ENGINE),       # in the backward, no part's
    *kernel(1810, 50, 1800, 11),            # outside every span
    ev("gpu_memset", "Memset (Device)", 1900, 10, 12),   # no launch
]

EVENTS = [ev("user_annotation", trace.WINDOW, 0, 2000), *SPANS, *OPS]
TOTAL_US = 10 + 5 + 20 + 30 + 15 + 8 + 4 + 12 + 40 + 60 + 5 + 6 + 50 + 10


def context(events, workload="dsllm7b-8l.train-4k", **counters):
    return harness.Context(cells.cell(workload), counters,
                           trace.parse(events), 989e12, 3.35e12)


@pytest.fixture
def train_ctx():
    return context(EVENTS, steps=2)


def read(name, ctx):
    return harness.reader(name)(ctx)


@pytest.mark.parametrize("name, device_us", [
    ("norm_ms.train", 10 + 12),
    ("rotary_ms.train", 20 + 8),
    ("weight_cast_ms.train", 5 + 4),
    ("loss_ms_per_step", 30 + 15),
    ("adamw_ms_per_step", 40 + 60),
])
def test_part_readers_per_step(train_ctx, name, device_us):
    assert read(name, train_ctx) == pytest.approx(1e-3 * device_us / 2)


def test_unspanned_share(train_ctx):
    # inside `vtp::forward`, `vtp::block` or `vtp::backward` alone counts
    # as unspanned, as do the op outside every span and the memset
    assert read("unspanned_share.train", train_ctx) == pytest.approx(
        100.0 * (5 + 6 + 50 + 10) / TOTAL_US)


@pytest.mark.parametrize("name", ["norm_ms.serve", "rotary_ms.serve",
                                  "weight_cast_ms.serve"])
def test_serving_part_readers_per_batch(name):
    # a served batch's forward alone: no `.bwd` range to add
    fwd = [e for e in EVENTS if not e["name"].endswith(".bwd")]
    ctx = context(fwd, "dsllm7b.serve-2k", batches=4)
    one = {"norm_ms.serve": 10, "rotary_ms.serve": 20,
           "weight_cast_ms.serve": 5}[name]
    assert read(name, ctx) == pytest.approx(1e-3 * one / 4)


def serving(batch_spans, sizes, latency_ms):
    events = [ev("user_annotation", trace.WINDOW, 0, 4000),
              *(rng("vtp::serve.batch", a, b - a) for a, b in batch_spans),
              *kernel(150, 900, 140, 1)]
    return context(events, "dsllm7b.serve-2k", batches=len(sizes),
                   batch_sizes=sizes, latency_ms=latency_ms)


def test_queue_wait_pairs_requests_to_batches_in_order():
    # batches of 2 and 1 whose spans last 1.0 and 0.5 ms
    ctx = serving([(100, 1100), (1200, 1700)], [2, 1], [5.0, 4.0, 3.0])
    assert read("serve_queue_wait_p95_ms", ctx) == pytest.approx(
        float(np.percentile([4.0, 3.0, 2.5], 95)))


@pytest.mark.parametrize("spans, sizes", [
    ([(100, 1100)], [2, 1]),                    # a batch without a span
    ([(100, 1100), (1200, 1700)], [2, 2]),      # more requests than latencies
])
def test_queue_wait_is_none_where_spans_and_batches_disagree(spans, sizes):
    assert read("serve_queue_wait_p95_ms",
                serving(spans, sizes, [5.0, 4.0, 3.0])) is None


NEW = ("norm_ms.train", "rotary_ms.train", "weight_cast_ms.train",
       "loss_ms_per_step", "adamw_ms_per_step", "unspanned_share.train",
       "norm_ms.serve", "rotary_ms.serve", "weight_cast_ms.serve",
       "unspanned_share.serve", "serve_queue_wait_p95_ms")


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_programs_spans(name):
    # a program without the ranges: the window and kernels, no vtp:: span
    bare = [e for e in EVENTS if not e["name"].startswith("vtp::")]
    ctx = context(bare, steps=2, batches=2, batch_sizes=[1, 1],
                  latency_ms=[1.0, 2.0])
    assert read(name, ctx) is None
    ctx.trace = None
    assert read(name, ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_are_declared_with_their_cells(name):
    declared = {m["name"]: m for m in cells.benchmark()["per_layer"]}
    assert declared[name]["source"] == "program_span"
    side = "dsllm7b.serve-2k" if declared[name]["moves"] == "serve_p95_ms" \
        else "dsllm7b-8l.train-4k"
    assert declared[name]["workloads"] == [side]

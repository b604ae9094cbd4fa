"""Each per-layer reader on a small canned profiler trace, and the trace
reading itself (the window, launches, the busy union, the breakdown)."""

import pytest

from perfbench import cells, flops, harness, trace

US = 1e-6


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def kernel(name, ts, dur, launch_ts, corr):
    return [ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 2, corr),
            ev("kernel", name, ts, dur, corr)]


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 1000),
    ev("user_annotation", "perfbench::optimizer", 600, 300),
    ev("cpu_op", "aten::item", 850, 140),
    *kernel("sm90_xmma_gemm_bf16bf16", 10, 200, 5, 1),
    *kernel("flash_fwd_bf16_kernel", 210, 50, 8, 2),
    *kernel("flash_bwd_dq_bf16_kernel", 260, 40, 9, 3),
    *kernel("flash_bwd_dkv_bf16_kernel", 300, 60, 10, 4),
    *kernel("vectorized_elementwise_kernel", 360, 100, 11, 5),
    *kernel("vectorized_elementwise_kernel", 650, 100, 640, 6),
    *kernel("reduce_kernel", 750, 50, 700, 7),
    ev("gpu_memset", "Memset (Device)", 5, 5, 8),
    # before the window: not counted
    *kernel("sm90_xmma_gemm_bf16bf16", -500, 100, -510, 9),
]


@pytest.fixture
def ctx():
    cell = cells.cell("dsllm7b-8l.train-4k")
    t = trace.parse(EVENTS)
    counters = {"steps": 2, "window_s": 1000 * US, "step_flops": 1e9,
                "attention_shape": (1, 256, 2, 128),
                "flash_kernels": ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"),
                "window_peak_bytes": 3 * 2 ** 30,
                "optimizer_span": "perfbench::optimizer"}
    return harness.Context(cell, counters, t, 989e12, 3.35e12)


def test_parse(ctx):
    t = ctx.trace
    assert t.window == (0.0, 1000 * US)
    assert len(t.in_window()) == 8
    # busy: [5, 460] and [650, 800]
    assert t.busy_s() == pytest.approx((455 + 150) * US)
    assert [op.name for op in t.launched_in("perfbench::optimizer")] == \
        ["vectorized_elementwise_kernel", "reduce_kernel"]
    with pytest.raises(ValueError):
        trace.parse(EVENTS[1:])


def test_breakdown(ctx):
    b = ctx.trace.breakdown()
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops["vectorized_elementwise_kernel"] == pytest.approx(200 * US)
    assert ops["sm90_xmma_gemm_bf16bf16"] == pytest.approx(200 * US)
    assert len(ops) == 7
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # [0, 5] and [460, 650] lie in no host call but the window; [800,
    # 1000]'s middle is in aten::item
    assert gaps["aten::item"] == pytest.approx(200 * US)
    assert gaps["host: no traced call"] == pytest.approx(195 * US)


def read(name, ctx):
    return harness.reader(name)(ctx)


def test_readers(ctx):
    assert read("train_mfu", ctx) == pytest.approx(
        100 * 2e9 / (1000 * US) / 989e12)
    assert read("matmul_ms_per_step", ctx) == pytest.approx(0.1)
    assert read("optimizer_ms_per_step", ctx) == pytest.approx(0.075)
    # the elementwise kernel at 360 and the memset
    assert read("elementwise_ms_per_step", ctx) == pytest.approx(0.0525)
    assert read("device_idle.train", ctx) == pytest.approx(39.5)
    assert read("device_peak_mem.train", ctx) == pytest.approx(3.0)
    bound = sum(flops.bound(*flops.flash_costs(k, 1, 256, 2, 128), 989e12,
                            3.35e12)[0]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    assert read("flash_roofline.train", ctx) == pytest.approx(
        100 * bound / (150 * US))


def test_serving_readers(ctx):
    ctx.counters = {"requests": 30, "batches": 5, "max_batch": 8,
                    "window_s": 2.0, "request_flops": 1e12,
                    "forward_ms": [100.0, 110.0],
                    "attention_shape": (8, 256, 2, 128),
                    "flash_kernels": ("flash_fwd",)}
    assert read("serve_batch_fill", ctx) == pytest.approx(75.0)
    assert read("serve_forward_ms", ctx) == pytest.approx(105.0)
    assert read("serve_mfu", ctx) == pytest.approx(100 * 15e12 / 989e12)
    one = flops.bound(*flops.flash_costs("flash_fwd", 8, 256, 2, 128),
                      989e12, 3.35e12)[0]
    assert read("flash_roofline.serve", ctx) == pytest.approx(
        100 * one / (50 * US))


def test_readers_find_nothing_without_a_trace(ctx):
    ctx.trace = None
    for name in ("optimizer_ms_per_step", "matmul_ms_per_step",
                 "elementwise_ms_per_step", "flash_roofline.train",
                 "device_idle.train"):
        assert read(name, ctx) is None
    ctx.trace = trace.parse([ev("user_annotation", trace.WINDOW, 0, 10)])
    assert read("flash_roofline.train", ctx) is None
    assert read("device_idle.train", ctx) is None


def test_every_metric_has_a_reader():
    for m in cells.benchmark()["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_split_name_shares_its_quantitys_reader():
    for family in ("device_idle", "flash_roofline"):
        paths = {harness.reader_path(f"{family}.{side}")
                 for side in ("train", "serve")}
        assert paths == {cells.PKG / "metrics" / f"{family}.py"}
    assert harness.reader_path("device_peak_mem.train").name == \
        "device_peak_mem.train.py"

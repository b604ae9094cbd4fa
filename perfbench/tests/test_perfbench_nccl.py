"""The four-card cell's readers on a canned profiler trace: the NCCL
kernels' time a step, the part no other kernel hides, the busy time
averaged over the ranks, and the flash roofline at split head dims."""

import pytest

from perfbench import cells, flops, harness, trace
from perfbench.drivers import train_mesh
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_metrics import US, ev, kernel

EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 1000),
    *kernel("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
            0, 100, -5, 1),
    *kernel("sm90_xmma_gemm_bf16bf16", 100, 200, 50, 2),
    # a reduce-scatter half under a kernel of another stream
    *kernel("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 250, 100, 60, 3),
    *kernel("flash_bwd_dkv_bf16_kernel", 400, 100, 70, 4),
    # a copy does not hide a collective
    *kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 600, 50, 80, 5),
    ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 600, 50, 6),
    # past the window's end: 40 of its 80 count as exposed
    *kernel("ncclKernel_AllGather", 960, 80, 90, 7),
]


@pytest.fixture
def ctx():
    name = "dsllm7b.train-4k-fsdp4"
    cell = cells.cell(name, tiny.with_pending(name))
    counters = {"steps": 2, "window_s": 1000 * US, "step_flops": 1e9,
                "attention_shape": (1, 4096, 16, 192, 128, 16),
                "flash_kernels": ("flash_bwd_dkv",),
                "window_peak_bytes": 40 * 2 ** 30}
    return harness.Context(cell, counters, trace.parse(EVENTS), 989e12,
                           3.35e12)


def read(name, ctx):
    return harness.reader(name)(ctx)


def test_nccl_ms_per_step(ctx):
    # 100 + 100 + 50 + 80 (whole durations, as the other kernel groups)
    assert read("nccl_ms_per_step", ctx) == pytest.approx(0.165)


def test_nccl_exposed_ms_per_step(ctx):
    # 100 + 50 (half of the reduce-scatter) + 50 + 40 (clipped)
    assert read("nccl_exposed_ms_per_step", ctx) == pytest.approx(0.12)


def test_no_nccl_kernel_reads_nothing(ctx):
    ctx.trace = trace.parse([e for e in EVENTS
                             if "ccl" not in e["name"]])
    assert read("nccl_ms_per_step", ctx) is None
    assert read("nccl_exposed_ms_per_step", ctx) is None
    ctx.trace = None
    assert read("nccl_ms_per_step", ctx) is None


def test_the_flash_roofline_reads_split_head_dims(ctx):
    one = flops.bound(*flops.flash_costs("flash_bwd_dkv", 1, 4096, 16, 192,
                                         2, 128, 16), 989e12, 3.35e12)[0]
    assert read("flash_roofline.train", ctx) == pytest.approx(
        100 * one / (100 * US))


def test_busy_time_is_the_mean_over_the_ranks(ctx):
    t = ctx.trace
    mesh = train_mesh.MeshTrace(t.device, t.host, t.window, [0.0005, 0.0007])
    assert mesh.busy_s() == pytest.approx((t.busy_s() + 0.0012) / 3)
    ctx.trace = mesh
    assert read("device_idle.train", ctx) == pytest.approx(
        100 * (1 - mesh.busy_s() / mesh.window_s))

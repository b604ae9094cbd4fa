"""The last line: its keys, the end-to-end metrics of an untraced run,
the per-layer ones and the device's busy time of a traced run, and the
checks last, also as the last lines of standard error."""

import json

from perfbench import cells, harness, trace
from perfbench.tests.test_perfbench_metrics import EVENTS


def outcome(tr=None):
    return harness.Outcome(
        end_to_end={"train_tokens_per_s": 12345.6789, "setup_s": 20.5},
        counters={"steps": 2, "window_s": 0.001, "step_flops": 1e9,
                  "attention_shape": (1, 256, 2, 128),
                  "flash_kernels": ("flash_fwd",),
                  "window_peak_bytes": 2 ** 30,
                  "optimizer_span": "perfbench::optimizer"},
        attempted=2, failed=0, memory_peak_bytes=5 * 2 ** 30, correct=True,
        checks={"loss_gap": {"value": 1e-5, "limit": 1e-3}}, trace=tr)


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_untraced_line():
    cell = cells.cell("dsllm7b-8l.train-4k")
    line = harness.result(outcome(), cell, DEVICE, None)
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert back["metrics"] == {
        "train_tokens_per_s": {"value": 12345.6789, "unit": "tokens/s"},
        "setup_s": {"value": 20.5, "unit": "s"}}
    assert back["device"]["memory_peak_bytes"] == 5 * 2 ** 30
    assert "busy_s" not in back["device"]


def test_traced_line():
    cell = cells.cell("dsllm7b-8l.train-4k")
    tr = trace.parse(EVENTS)
    ctx = harness.Context(cell, outcome().counters, tr, 989e12, 3.35e12)
    back = json.loads(json.dumps(harness.result(outcome(tr), cell,
                                                   DEVICE, ctx)))
    assert list(back)[-1] == "checks"
    assert set(back["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "train_mfu" in back["metrics"]
    assert back["device"]["busy_s"] > 0 and back["device"]["window_s"] > 0
    assert len(back["breakdown"]["device_ops"]) <= 10
    assert len(back["breakdown"]["idle_gaps"]) <= 10


def test_check_lines():
    lines = harness.check_lines({"loss_gap": {"value": 2e-5, "limit": 1e-3}})
    assert lines == ["check loss_gap: 2e-05 (limit 0.001)"]

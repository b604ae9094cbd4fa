"""Every per-layer reader the two single-card cells had before the
four-card cell came reads the same numbers, bit for bit, from the same
canned traces and counters: `readers_before.json` holds what the readers
read at the commit before (each value's `repr`, or the error raised)."""

import json
from pathlib import Path

import pytest

from perfbench import cells, harness, trace
from perfbench.tests import test_perfbench_metrics as tm
from perfbench.tests import test_perfbench_spans as ts

BEFORE = json.loads((Path(__file__).parent / "readers_before.json")
                    .read_text())
NAMES = ["train_mfu", "optimizer_ms_per_step", "elementwise_ms_per_step",
  "matmul_ms_per_step", "flash_roofline.train", "device_idle.train",
  "device_peak_mem.train", "serve_mfu", "flash_roofline.serve",
  "device_idle.serve", "serve_forward_ms", "serve_batch_fill", "norm_ms.train",
  "rotary_ms.train", "weight_cast_ms.train", "loss_ms_per_step",
  "adamw_ms_per_step", "unspanned_share.train", "norm_ms.serve",
  "rotary_ms.serve", "weight_cast_ms.serve", "unspanned_share.serve",
  "serve_queue_wait_p95_ms"]
TRAIN = {"steps": 2, "window_s": 1000e-6, "step_flops": 1e9,
         "attention_shape": (1, 256, 2, 128),
         "flash_kernels": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
         "window_peak_bytes": 3 * 2 ** 30, "optimizer_span": "perfbench::optimizer"}
SERVE = {"requests": 30, "batches": 5, "max_batch": 8, "window_s": 2.0,
         "request_flops": 1e12, "forward_ms": [100.0, 110.0],
         "attention_shape": (8, 2048, 32, 128), "flash_kernels": ("flash_fwd",),
         "batch_sizes": [6, 6, 6, 6, 6], "latency_ms": [float(i) for i in range(30)],
         "window_peak_bytes": 2 ** 30, "optimizer_span": "perfbench::optimizer"}
CASES = {"metrics_train": (tm.EVENTS, "dsllm7b-8l.train-4k", TRAIN),
         "spans_train": (ts.EVENTS, "dsllm7b-8l.train-4k", TRAIN),
         "metrics_serve": (tm.EVENTS, "dsllm7b.serve-2k", SERVE),
         "spans_serve": (ts.EVENTS, "dsllm7b.serve-2k", SERVE)}


def reading(case, name):
    events, workload, counters = CASES[case]
    ctx = harness.Context(cells.cell(workload), dict(counters),
                          trace.parse(events), 989e12, 3.35e12)
    try:
        return repr(harness.reader(name)(ctx))
    except Exception as e:           # noqa: BLE001 -- compared by name
        return "error " + type(e).__name__


@pytest.mark.parametrize("key", sorted(BEFORE))
def test_the_reader_reads_what_it_read(key):
    case, name = key.split("/")
    assert reading(case, name) == BEFORE[key]


def test_every_reader_is_covered():
    assert {k.split("/")[1] for k in BEFORE} == set(NAMES)
    assert len(BEFORE) == len(NAMES) * len(CASES)

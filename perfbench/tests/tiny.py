"""Tiny cells for the CPU tests: the real mixes and limits at small
sizes, so that a test drives every step of a run in seconds."""

from __future__ import annotations

import copy

from perfbench import cells

BENCH = cells.benchmark()


def with_pending(name: str, bench=None):
    """`bench` (BENCHMARK.json by default) with the entries of the
    pending cell `name` (`perfbench/pending/<name>.json`) added."""
    bench = copy.deepcopy(cells.benchmark() if bench is None else bench)
    pending = cells.load_json(cells.PKG / "pending" / f"{name}.json")
    bench["workloads"].append(pending["workload"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in pending["listed_in"]:
            m["workloads"].append(name)
    bench["per_layer"] += pending["per_layer"]
    return bench


def config(dtype: str = "float32"):
    return {"name": "tiny", "hidden_size": 256, "intermediate_size": 384,
         "max_position_embeddings": 256, "num_attention_heads": 2,
         "num_hidden_layers": 2, "num_key_value_heads": 2,
         "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "torch_dtype": dtype,
         "vocab_size": 512}


def cell(workload: str, dtype: str = "float32") -> cells.Cell:
    """`workload`'s cell with its mix cut to tiny shapes."""
    real = cells.cell(workload, BENCH)
    mix = copy.deepcopy(real.mix)
    if mix["driver"] == "serve":
        mix.update(seq_len=256, max_batch=4, rate_per_s=20.0,
                   check_requests=4, check_positions=16)
    else:
        mix.update(batch=2, seq_len=256, pool_batches=8)
    return cells.Cell(workload, 1, config(dtype), mix, real.limits,
                      real.per_layer, real.end_to_end)

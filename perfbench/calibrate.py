"""The readings the limits of `correct` are set from, at a cell's size.

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control 1,2,3] [--fault 1,2,3] [--out <file.jsonl>]

The cell's driver takes the readings (`readings` in
`perfbench/drivers/<driver>.py`).  For each seed of `--seeds`: what the
program's timed path produces (the training step's proof steps, or the
replica's forward over the sampled requests, side by side in its padded
batch) against the f32 reference; these give the lower readings.  For
each seed of `--control`: the reference in fp8 put in the program's
place (the control); for `--fault` (training cells): the reference with
half of the batch left out, the mean taken over the rest.  One JSON line
a reading.  No window is run: the numbers are the ones a run compares.

    python3 -m perfbench.calibrate --workload <train cell> --size 1,2,3

runs two steps of the program at each batch size and prints its peak
memory, or that it ran out.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from perfbench import cells, inputs
from perfbench.drivers import common
from perfbench.drivers import train as dtrain


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def driver(cell):
    """The module of the cell's driver (`perfbench/drivers/<driver>.py`)."""
    return importlib.import_module(f"perfbench.drivers.{cell.driver}")


def readings(cell, seed: int, control: bool, fault: bool, lower: bool,
             device, seconds: float):
    """[(what, numbers)] of one seed, from the cell's driver's
    `readings`: the program's (`lower`), the control's and the faults'
    the driver has, each against the f32 reference."""
    return driver(cell).readings(cell, seed, control, fault, lower, device,
                                 seconds)


def size(cell, batches, device):
    from volcano_tpu_torch.workloads import train
    s, mix = cell.sizes, cell.mix
    for b in batches:
        params = state = step = None
        try:
            torch.cuda.reset_peak_memory_stats(device)
            params = inputs.make_params(s, 1, device)
            opt = dtrain.make_optimizer(mix["optimizer"])
            state = opt.init(params)
            step = train.make_train_step(common.model_config(s), opt)
            pool = inputs.token_pool(1, inputs.TOKENS, (2, b, mix["seq_len"]),
                                     s.vocab, device)
            t0 = time.perf_counter()
            for i in range(2):
                step(params, state, {"tokens": pool[i]})
            torch.cuda.synchronize(device)
            print(json.dumps({"batch": b, "peak_bytes":
                              torch.cuda.max_memory_allocated(device),
                              "reserved_bytes":
                              torch.cuda.max_memory_reserved(device),
                              "two_steps_s": time.perf_counter() - t0}),
                  flush=True)
        except torch.OutOfMemoryError as e:
            print(json.dumps({"batch": b, "oom": str(e)[:300]}), flush=True)
        del params, state, step
        common.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--size", default="")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window whose requests are sampled (serving)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.size:
        size(cell, _ints(args.size), device)
        return 0
    lower, control, fault = (set(_ints(x)) for x in
                             (args.seeds, args.control, args.fault))
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for seed in sorted(lower | control | fault):
            t0 = time.perf_counter()
            got = readings(cell, seed, seed in control, seed in fault,
                           seed in lower, device, args.seconds)
            for what, numbers in got:
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "what": what, "numbers": numbers,
                                   "s": round(time.perf_counter() - t0, 1)})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

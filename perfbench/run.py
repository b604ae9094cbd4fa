"""Run one cell of the benchmark and print its result as the last line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` also
`breakdown`, and last `checks`, each number that decided `correct`
beside its limit (also the last lines of standard error).  With no CUDA
device, too few of them, a program that cannot be imported, or a JAX
module loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from perfbench import cells, harness, peaks  # noqa: E402

# the build caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(cells.ROOT / rel)
    try:
        cell = cells.cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        return fail(f"no such cell: {e}")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA devices; "
                    f"{torch.cuda.device_count()} found")
    try:
        driver = importlib.import_module(f"perfbench.drivers.{cell.driver}")
        importlib.import_module("volcano_tpu_torch.workloads.train")
    except ImportError as e:
        return fail(f"cannot import the program or the driver: {e}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(device)
    flop_peak, byte_peak = peaks.peaks(kind)
    power = peaks.power_limit()
    print(f"perfbench: {cell.name} seed {args.seed} on {kind}, power limit "
          f"{power}", file=sys.stderr, flush=True)
    outcome = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules loaded that a run may not hold: {bad}", 3)
    ctx = harness.Context(cell, outcome.counters, outcome.trace, flop_peak,
                          byte_peak) if args.trace else None
    line = harness.result(outcome, cell, {"platform": "gpu", "kind": kind,
                                          "count": cell.chips,
                                          "power_limit": power},
                          ctx)
    for text in harness.check_lines(outcome.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

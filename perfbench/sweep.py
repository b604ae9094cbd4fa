"""The serving knee: the highest offered rate whose backlog does not
grow over a window.  Run once, when a serving cell is defined, and
write 80% of the knee into its mix as `rate_per_s`.

    python3 -m perfbench.sweep --workload <serving cell> \\
        --loads 0.7,0.9,1.0,1.1 --seconds 15 --seed 1 [--max-batch 8,16]

For each `--max-batch` (the mix's by default): one set-up, the peak
memory and the capacity, max_batch over the mean forward of three full
batches; then each load's window in turn, offered at that share of the
capacity: one JSON line a load with the rate, the requests, the p50 and
p95 in ms, and the growth, the median latency of the window's last
quarter of requests over its first quarter's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from perfbench import arrivals, cells, inputs
from perfbench.drivers import common
from perfbench.drivers import serve as dserve


def _floats(text: str):
    return [float(x) for x in text.split(",") if x]


def sweep(cell, mb: int, loads, seconds: float, seed: int, device) -> None:
    s, t = cell.sizes, cell.mix["seq_len"]
    common.reset_peak(device)
    params = inputs.make_params(s, seed, device)
    warm = inputs.token_pool(seed, inputs.REQUESTS, (mb, t), s.vocab, device)
    fwd = dserve.Forward(params, common.model_config(s), warm, mb, {},
                         device)
    for i in range(5):                 # two to warm up, three timed
        if i == 2:
            fwd.reset()
        fwd.next = 0
        fwd(mb)
    forward_s = float(np.mean([a.elapsed_time(b) for a, b in fwd.events]))
    forward_s /= 1e3
    capacity = mb / forward_s
    print(json.dumps({"max_batch": mb, "forward_ms": forward_s * 1e3,
                      "capacity_per_s": capacity,
                      "peak_bytes": common.peak_bytes(device)}), flush=True)
    rates = [round(x * capacity, 2) for x in loads]
    most = max(len(arrivals.poisson_schedule(r, seconds)) for r in rates)
    fwd.pool = inputs.token_pool(seed, inputs.REQUESTS, (max(most, mb), t),
                                 s.vocab, device)
    _, serve = dserve._program()
    for load, rate in zip(loads, rates):
        fwd.reset()
        server = serve.BatchedServer(fwd, max_batch=mb, slo_ms=1e9,
                                     now=time.perf_counter)
        due = arrivals.poisson_schedule(rate, seconds)
        t0 = time.perf_counter()
        dserve.serve_window(server, [t0 + d for d in due],
                            cell.mix["batch_window_s"])
        lat = np.array([(fwd.done[j] - t0 - due[j]) * 1e3
                        for j in range(len(due))])
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "max_batch": mb, "load": load, "rate_per_s": rate,
            "requests": len(lat), "window_s": time.perf_counter() - t0,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "fill": len(lat) / (len(fwd.sizes) * mb),
            "forward_ms": float(np.mean([a.elapsed_time(b)
                                         for a, b in fwd.events])),
            "peak_bytes": common.peak_bytes(device)}), flush=True)
    common.sync(device)
    del fwd, params
    common.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--loads", required=True,
                    help="offered rates as shares of the capacity")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-batch", default="")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for mb in _floats(args.max_batch) or [cell.mix["max_batch"]]:
        sweep(cell, int(mb), _floats(args.loads), args.seconds, args.seed,
              device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

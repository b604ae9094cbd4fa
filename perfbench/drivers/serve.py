"""The serving driver: the port's batched replica under open-loop load.

The window drives `volcano_tpu_torch.workloads.serve.BatchedServer`
over a forward built as `serve.torch_forward` builds it: one fixed
[max_batch, seq_len] token buffer, each batch's requests copied into its
first rows (the rest is padding), `model.forward` under
`torch.inference_mode`, then a synchronise.  (`torch_forward` itself
draws its own weights and serves one fixed token batch, so the driver
builds the same forward over the seed's weights and each request's own
tokens.)  Requests are due at the cell's Poisson schedule
(`perfbench.arrivals`), offered by `serve.run`'s loop: a batch is
served when it fills or when the next request is further out than the
batching window.  Each request is timed from when it was due to the
synchronise after its batch; `serve_p95_ms` is over every request due
in the window.

A sample of the requests, drawn from the seed, keeps its logits at
seeded positions; after the window the reference computes them again.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import arrivals, cells, compare, flops, inputs
from perfbench.drivers import common
from perfbench.harness import Outcome
from perfbench.reference import decoder
from perfbench.trace import WINDOW, capture, span

FORWARD_SPAN = "perfbench::forward"
WAIT_SPAN = "perfbench::arrival_wait"
CHECK = 4          # host stream of the sample
REF_ROWS = 4       # requests the reference runs at once


def _program():
    from volcano_tpu_torch.workloads import model, serve
    return model, serve


def accepts(config: Dict[str, Any]) -> None:
    """Raises where the dense block cannot run `config` (`cells.sizes`)."""
    cells.sizes(config)


def sample(seed: int, n_requests: int, mix, t: int):
    """{request: its sorted positions (the last included)}."""
    rng = inputs.host_rng(seed, CHECK)
    picked = rng.sample(range(n_requests), min(mix["check_requests"],
                                               n_requests))
    out = {}
    for j in sorted(picked):
        pos = rng.sample(range(t - 1), mix["check_positions"] - 1)
        out[j] = sorted(pos) + [t - 1]
    return out


class Forward:
    """forward_fn(n) for `BatchedServer`: the next n requests in order."""

    def __init__(self, params, cfg, pool, max_batch: int, keep, device):
        self.params, self.cfg, self.pool = params, cfg, pool
        self.keep = {j: torch.tensor(p, device=device)
                     for j, p in keep.items()}
        self.buf = pool[:max_batch].clone()
        self.device = device
        self.next = 0
        self.done: Dict[int, float] = {}
        self.answers: Dict[int, torch.Tensor] = {}
        self.events: List = []
        self.sizes: List[int] = []

    def __call__(self, n: int):
        model, _ = _program()
        k, self.next = self.next, self.next + n
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with span(FORWARD_SPAN):
            self.buf[:n].copy_(self.pool[k:k + n])
            with torch.inference_mode():
                logits = model.forward(self.params, self.buf, self.cfg)
                for j in range(k, k + n):
                    if j in self.keep:
                        self.answers[j] = logits[j - k, self.keep[j]]
            if cuda:
                ev[1].record()
            common.sync(self.device)
        now = time.perf_counter()
        for j in range(k, k + n):
            self.done[j] = now
        if cuda:
            self.events.append(ev)
        self.sizes.append(n)
        return logits

    def reset(self):
        self.next = 0
        self.done.clear()
        self.answers.clear()
        self.events.clear()
        self.sizes.clear()


def serve_window(server, due_abs: List[float], batch_window_s: float):
    """`serve.run`'s loop over one window's arrivals."""
    for arrival in due_abs:
        while server.queue and \
                arrival - time.perf_counter() > batch_window_s:
            server.serve_batch()
        pause = arrival - time.perf_counter()
        if pause > 0:
            with span(WAIT_SPAN):
                time.sleep(pause)
        server.offer(arrival)
        if len(server.queue) >= server.max_batch:
            server.serve_batch()
    server.drain()


def reference_answers(cell, seed: int, pool, keep, kind: str, device):
    """{request: f32 logits at its kept positions} from the reference."""
    s = cell.sizes
    decoder.no_tf32()
    params = inputs.make_params(s, seed, device)
    out = {}
    js = sorted(keep)
    for a in range(0, len(js), REF_ROWS):
        part = js[a:a + REF_ROWS]
        pos = torch.tensor([keep[j] for j in part], device=device)
        logits = decoder.logits_at(params, pool[part], pos, s,
                                   decoder.Precision(kind))
        for j, row in zip(part, logits):
            out[j] = row
    del params
    return out


def numbers(answers, ref) -> Dict[str, float]:
    return {"logit_err": max(compare.rel_err(answers[j], ref[j])
                             for j in ref)}


def readings(cell, seed: int, control: bool, fault: bool, lower: bool,
             device, seconds: float):
    """`perfbench.calibrate`'s readings: the program's forward over the
    requests a `seconds` window samples and the fp8 control, each
    against the f32 reference (a served cell has no half-batch fault:
    `fault` is not used)."""
    s, mix = cell.sizes, cell.mix
    t, mb = mix["seq_len"], mix["max_batch"]
    n = len(arrivals.poisson_schedule(mix["rate_per_s"], seconds))
    pool = inputs.token_pool(seed, inputs.REQUESTS, (max(n, mb), t), s.vocab,
                             device)
    keep = sample(seed, n, mix, t)
    out = []
    ref = reference_answers(cell, seed, pool, keep, "f32", device)
    if lower:
        # the sampled requests side by side in the window's padded batch
        # (a row's logits do not depend on its neighbours)
        js = sorted(keep)
        params = inputs.make_params(s, seed, device)
        rows = torch.cat([pool[js], pool[:mb]])    # the padding after
        fwd = Forward(params, common.model_config(s), rows, mb,
                      {i: keep[j] for i, j in enumerate(js)}, device)
        for a in range(0, len(js), mb):
            fwd(min(mb, len(js) - a))
        answers = {js[i]: x for i, x in fwd.answers.items()}
        del fwd, params
        common.free(device)
        out.append(("program", numbers(answers, ref)))
    if control:
        ctl = reference_answers(cell, seed, pool, keep, "fp8", device)
        out.append(("control", numbers(ctl, ref)))
    return out


def run(cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> Outcome:
    s, mix = cell.sizes, cell.mix
    t, mb = mix["seq_len"], mix["max_batch"]
    cfg = common.model_config(s)
    _, serve = _program()
    due = arrivals.poisson_schedule(mix["rate_per_s"], seconds)
    n = len(due)
    pool = inputs.token_pool(seed, inputs.REQUESTS, (max(n, mb), t), s.vocab,
                             device)
    keep = sample(seed, n, mix, t)
    params = inputs.make_params(s, seed, device)
    fwd = Forward(params, cfg, pool, mb, keep, device)
    for _ in range(2):                 # warm up the one shape served
        fwd(mb)
    fwd.reset()
    server = serve.BatchedServer(fwd, max_batch=mb, slo_ms=1e9,
                                 now=time.perf_counter)
    common.sync(device)
    setup_peak = common.peak_bytes(device)
    common.reset_peak(device)
    setup_s = time.perf_counter() - t_start
    box: Dict[str, Any] = {}

    def window():
        with span(WINDOW):
            t0 = time.perf_counter()
            serve_window(server, [t0 + d for d in due], mix["batch_window_s"])
            box["t0"], box["window_s"] = t0, time.perf_counter() - t0

    trace = capture(window, cell.name) if trace_on else window()
    window_peak = common.peak_bytes(device)
    t0 = box["t0"]
    lat_ms = [(fwd.done[j] - (t0 + due[j])) * 1e3 for j in range(n)
              if j in fwd.done]
    forward_ms = [a.elapsed_time(b) for a, b in fwd.events]
    answers = {j: fwd.answers[j] for j in keep if j in fwd.answers}
    failed = n - len(lat_ms)
    served = fwd.sizes[:]
    del fwd, server, params
    common.free(device)

    ref = reference_answers(cell, seed, pool, keep, "f32", device)
    nums = numbers(answers, ref) if len(answers) == len(keep) \
        else {"logit_err": float("nan")}
    ok, checks = compare.judge(nums, cell.limits)
    return Outcome(
        end_to_end={"serve_p95_ms": float(np.percentile(lat_ms, 95)),
                    "setup_s": setup_s},
        counters={"requests": len(lat_ms), "batches": len(served),
                  "batch_sizes": served, "max_batch": mb,
                  "window_s": box["window_s"], "forward_ms": forward_ms,
                  "request_flops": flops.forward_flops(s, 1, t),
                  "attention_shape": (mb, t, s.n_heads, s.head_dim),
                  "flash_kernels": ("flash_fwd",),
                  "latency_ms": lat_ms,
                  "window_peak_bytes": window_peak},
        attempted=n, failed=failed,
        memory_peak_bytes=max(setup_peak, window_peak),
        correct=ok and failed == 0, checks=checks, trace=trace)

"""The training driver: the port's step over a fixed window.

Set-up builds one step object, `volcano_tpu_torch.workloads.train.
make_train_step(cfg, train.make_optimizer(...))`, with its params and
AdamW state, drives it through the mix's `proof_steps` on the pool's
first batches (the same call and feed as the window's), reads what the
comparison needs (each loss; the first gradient from the first moment
after step 1; each leaf's change after the last), and hands the same
object to the window.  The window runs steps, a fresh batch of the pool
each, until `seconds` have passed, then synchronises:
`train_tokens_per_s` is every token trained over the window's length.

After the window, with the program's state freed, the reference runs
the same steps on the same inputs in f32 (`perfbench.reference`).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict

import torch

from perfbench import cells, compare, flops, inputs
from perfbench.drivers import common
from perfbench.harness import Outcome
from perfbench.reference import decoder
from perfbench.trace import WINDOW, capture, span

OPTIMIZER_SPAN = "perfbench::optimizer"
STEP_SPAN = "perfbench::step"


def _program():
    from volcano_tpu_torch.workloads import train
    return train


def accepts(config: Dict[str, Any]) -> None:
    """Raises where the dense block cannot run `config` (`cells.sizes`)."""
    cells.sizes(config)


def make_optimizer(opt: Dict[str, float]):
    return _program().make_optimizer(lr=opt["lr"],
                                     weight_decay=opt["weight_decay"],
                                     warmup_steps=opt["warmup_steps"])


def _annotated(fn, name):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapped


def prove(step, params, state, pool, n: int) -> Dict[str, Any]:
    """n steps on the pool's first batches: each step's loss and each
    leaf's first gradient as the optimizer took it (read from its first
    moment mu = (1 - b1) g after step 1)."""
    b1 = _program().B1
    got: Dict[str, Any] = {"losses": []}
    for i in range(n):
        params, state, m = step(params, state, {"tokens": pool[i]})
        got["losses"].append(float(m["loss"]))
        if i == 0:
            got["first"] = {k: float(v.float().norm()) / (1 - b1)
                            for k, v in inputs.named(state["mu"])}
    return got


def reference(cell, seed: int, batches, kind: str = "f32", device=None
              ) -> Dict[str, Any]:
    """The reference's steps from the seed's params over `batches`:
    `decoder.train`'s readings and `change`, each leaf's change."""
    s = cell.sizes
    decoder.no_tf32()
    params = inputs.make_params(s, seed, device)
    got = decoder.train(params, batches, s, cell.mix["optimizer"],
                        decoder.Precision(kind))
    got["change"] = inputs.change_norms(params, s, seed)
    del params
    common.free(device)
    return got


def judged(cell, seed: int, prog, batches, device):
    """(correct, checks) of the program's readings against the f32
    reference's on the same batches."""
    ref = reference(cell, seed, batches, "f32", device)
    return compare.judge(compare.train_numbers(prog, ref), cell.limits)


def program_readings(cell, seed: int, device) -> Dict[str, Any]:
    """The program's proof readings alone (for `perfbench.calibrate`),
    with `change`; state freed."""
    s, mix = cell.sizes, cell.mix
    cfg = common.model_config(s)
    pool = inputs.token_pool(seed, inputs.TOKENS,
                             (mix["proof_steps"], mix["batch"],
                              mix["seq_len"]), s.vocab, device)
    params = inputs.make_params(s, seed, device)
    opt = make_optimizer(mix["optimizer"])
    state = opt.init(params)
    step = _program().make_train_step(cfg, opt)
    got = prove(step, params, state, pool, mix["proof_steps"])
    got["change"] = inputs.change_norms(params, s, seed)
    del params, state, step, opt
    common.free(device)
    return got


def readings(cell, seed: int, control: bool, fault: bool, lower: bool,
             device, seconds: float = 0.0):
    """`perfbench.calibrate`'s readings: the program's proof steps, the
    fp8 control and the half-batch fault, each against the f32
    reference (`seconds` is not used: no window runs)."""
    mix = cell.mix
    pool = inputs.token_pool(seed, inputs.TOKENS,
                             (mix["proof_steps"], mix["batch"],
                              mix["seq_len"]), cell.sizes.vocab, device)
    out = []

    def against(side, got):
        ref = reference(cell, seed, pool, "f32", device)
        out.append((side, compare.train_numbers(got, ref)))

    if lower:
        against("program", program_readings(cell, seed, device))
    if control:
        against("control", reference(cell, seed, pool, "fp8", device))
    if fault:
        # the reference with half the batch in the program's place,
        # against the whole batch's reference
        half = pool[:, :max(1, mix["batch"] // 2)]
        got = reference(cell, seed, half, "f32", device)
        ref = reference(cell, seed, pool, "f32", device)
        out.append(("fault_half_batch", compare.train_numbers(got, ref)))
    return out


def run(cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> Outcome:
    s, mix = cell.sizes, cell.mix
    b, t, n_proof = mix["batch"], mix["seq_len"], mix["proof_steps"]
    cfg = common.model_config(s)
    pool = inputs.token_pool(seed, inputs.TOKENS, (mix["pool_batches"], b, t),
                             s.vocab, device)
    params = inputs.make_params(s, seed, device)
    opt = make_optimizer(mix["optimizer"])
    state = opt.init(params)
    step = _program().make_train_step(cfg, opt)
    prog = prove(step, params, state, pool, n_proof)
    prog["change"] = inputs.change_norms(params, s, seed)
    if trace_on:
        opt.update = _annotated(opt.update, OPTIMIZER_SPAN)
    common.sync(device)
    setup_peak = common.peak_bytes(device)
    common.reset_peak(device)
    setup_s = time.perf_counter() - t_start

    done: Dict[str, Any] = {"losses": []}

    def window():
        i = n_proof
        with span(WINDOW):
            t0 = time.perf_counter()
            while True:
                with span(STEP_SPAN):
                    _, _, m = step(params, state,
                                   {"tokens": pool[i % len(pool)]})
                done["losses"].append(m["loss"])
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            common.sync(device)
            done["window_s"] = time.perf_counter() - t0

    trace = capture(window, cell.name) if trace_on else window()
    n = len(done["losses"])
    window_peak = common.peak_bytes(device)
    failed = int((~torch.isfinite(torch.stack(done["losses"]))).sum())
    batches = pool[:n_proof].clone()
    del params, state, step, opt, pool, done["losses"]
    common.free(device)

    ok, checks = judged(cell, seed, prog, batches, device)
    tokens = n * b * t
    return Outcome(
        end_to_end={"train_tokens_per_s": tokens / done["window_s"],
                    "setup_s": setup_s},
        counters={"steps": n, "window_s": done["window_s"],
                  "tokens": tokens, "step_flops": flops.train_flops(s, b, t),
                  "attention_shape": (b, t, s.n_heads, s.head_dim),
                  "flash_kernels": ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"),
                  "window_peak_bytes": window_peak,
                  "optimizer_span": OPTIMIZER_SPAN},
        attempted=n, failed=failed,
        memory_peak_bytes=max(setup_peak, window_peak),
        correct=ok and failed == 0,
        checks=checks, trace=trace)

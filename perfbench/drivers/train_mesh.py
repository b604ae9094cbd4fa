"""The training driver on several cards: the port's sharded step over a
fixed window, one process a card.

`run` starts one process a rank (`launch`), rank r on `cuda:<r>`, joined
in a process group over `tcp://127.0.0.1:<port>` (NCCL on the card, gloo
on the CPU), and waits for them under a deadline, the mix's
`deadline_s` past the window's `seconds`: past it, or as soon as one
rank fails, it kills them all and raises, so the run prints no result.
A rank dies with the process that started it.  Each rank:

- builds the port's mesh (`mesh.make_mesh`, fsdp over every rank) and
  the step the worker builds, `train.make_train_step(cfg,
  train.make_optimizer(...), mesh)`, over the seed's params
  (`inputs.make_params`) laid out by `model.distribute`, each rank
  keeping a copy of its shards only;
- keeps its rows of each global batch of the pool
  (`train.batch_sharding`) and drives the step through the mix's
  `proof_steps`: each loss, and each leaf's first gradient (from AdamW's
  first moment) and its change after the last step, each leaf gathered
  whole in turn;
- runs the window: steps on fresh batches until `seconds` have passed
  on some rank's clock (the ranks agree on the count by an all-reduce of
  a flag after each step, read one step late, so the host never waits
  for the card to drain), then a barrier and a synchronise.  With a
  trace every rank runs under the profiler and parses its own trace,
  all at once: rank 0's is the cell's, handed over pickled; the others
  give their device's busy time, which is averaged with rank 0's
  (`MeshTrace`).

`train_tokens_per_s` is every rank's tokens over rank 0's window.  After
the ranks have exited, the reference (`perfbench.reference.decoder`,
f32) runs the same proof steps in this process on the global batches,
with a copy of the params on each card and a block of each batch's rows
(`decoder.train_replicas`, a thread a card), and the program's readings
are judged against it.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import multiprocessing
import multiprocessing.connection
import os
import pickle
import signal
import socket
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from perfbench import cells, compare, flops, inputs, trace
from perfbench.drivers import common
from perfbench.drivers import train as dtrain
from perfbench.harness import Outcome
from perfbench.reference import decoder
from perfbench.trace import WINDOW, span

STEP_SPAN = dtrain.STEP_SPAN


def accepts(config: Dict[str, Any]) -> None:
    """Raises where the dense block cannot run `config` (`cells.sizes`)."""
    cells.sizes(config)


@dataclasses.dataclass
class MeshTrace(trace.Trace):
    """Rank 0's trace, with the other ranks' device busy seconds: the
    busy time is the mean over the ranks."""
    others_busy: List[float] = dataclasses.field(default_factory=list)

    def busy_s(self) -> float:
        return (super().busy_s() + sum(self.others_busy)) / \
            (1 + len(self.others_busy))


def log(job: Dict[str, Any], what: str) -> None:
    """A line on standard error: `what`, at seconds since the run began."""
    print(f"perfbench: {what} at {time.time() - job['started']:.1f} s",
          file=sys.stderr, flush=True)


def out_dir() -> Path:
    return cells.ROOT / "build" / "perfbench"


def _whole(x):
    """A DTensor gathered whole on every rank; a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def change_norms(params: Dict[str, Any], s: cells.Sizes, seed: int,
                 device) -> Dict[str, float]:
    """`inputs.change_norms` over leaves that are sharded (each gathered
    whole in turn, on every rank) or on several devices (each compared
    where it lies); the draws are made on `device`."""
    leaves = inputs.layout(s)
    by_name = dict(inputs.named(params))
    total = inputs.n_random(leaves)
    buf = torch.empty(min(inputs.CHUNK, total), dtype=torch.float32,
                      device=device)
    drawn = None
    out = {}
    for x in leaves:
        p = _whole(by_name[x.name]).float().reshape(-1)
        if x.std is None:
            out[x.name] = math.sqrt(float((p - 1.0).square().sum()))
            continue
        sq = 0.0
        first = x.offset // inputs.CHUNK
        last = (x.offset + x.numel - 1) // inputs.CHUNK
        for c in range(first, last + 1):
            lo = c * inputs.CHUNK
            n = min(inputs.CHUNK, total - lo)
            if drawn != c:
                inputs._draw_chunk(seed, c, n, buf[:n])
                drawn = c
            a, b = max(lo, x.offset), min(lo + n, x.offset + x.numel)
            p0 = (buf[a - lo:b - lo] * x.std).to(p.device)
            sq += float((p[a - x.offset:b - x.offset] - p0).square().sum())
        out[x.name] = math.sqrt(sq)
        del p
    return out


# -- one rank -------------------------------------------------------------

def _die_with_parent() -> None:
    """SIGKILL this process when the process that started it ends."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _device(rank: int, device_type: str):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))
    return torch.device("cpu")


def rank_main(rank: int, job: Dict[str, Any]) -> None:
    """One rank of `launch`: its readings and timings, written to
    `job["out"]/<cell>.rank<r>.json`."""
    _die_with_parent()
    device = _device(rank, job["device_type"])
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{job['port']}",
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=job["deadline_s"]))
    try:
        got = _work(rank, job, device)
    finally:
        dist.destroy_process_group()
    path = Path(job["out"]) / f"{job['cell'].name}.rank{rank}.json"
    path.write_text(json.dumps(got))


def _work(rank: int, job: Dict[str, Any], device) -> Dict[str, Any]:
    from torch.distributed.tensor import DTensor
    from volcano_tpu_torch.workloads import mesh as mesh_lib
    from volcano_tpu_torch.workloads import model, train
    cell, world, seed = job["cell"], job["world"], job["seed"]
    s, mix = cell.sizes, cell.mix
    cfg = dataclasses.replace(common.model_config(s), remat=mix["remat"])
    mesh = mesh_lib.make_mesh({"fsdp": world}, device.type)
    gb, t = world * mix["rank_batch"], mix["seq_len"]
    rows = train.batch_sharding(mesh).rows(gb)
    pool = inputs.token_pool(seed, inputs.TOKENS, (mix["pool_batches"], gb, t),
                             s.vocab, device)[:, rows].contiguous()
    if rank == 0:
        log(job, "ranks joined")
    params = train.tree_map(
        lambda x: DTensor.from_local(x.to_local().clone(), x.device_mesh,
                                     x.placements, run_check=False),
        model.distribute(inputs.make_params(s, seed, device), mesh))
    common.free(device)
    opt = dtrain.make_optimizer(mix["optimizer"])
    state = opt.init(params)
    step = train.make_train_step(cfg, opt, mesh)
    prog: Dict[str, Any] = {"losses": []}
    for i in range(mix["proof_steps"]):
        params, state, m = step(params, state, {"tokens": pool[i]})
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["first"] = {k: float(_whole(v).float().norm()) / (1 - train.B1)
                             for k, v in inputs.named(state["mu"])}
    prog["change"] = change_norms(params, s, seed, device)
    if rank == 0:
        log(job, f"{mix['proof_steps']} proof steps read")
    got: Dict[str, Any] = {"rank": rank}
    if rank == 0:
        got["prog"] = prog
    if not job["window"]:
        return got

    common.sync(device)
    got["setup_peak"] = common.peak_bytes(device)
    common.reset_peak(device)
    losses: List[torch.Tensor] = []

    def window():
        i = mix["proof_steps"]
        flags: List[torch.Tensor] = []
        with span(WINDOW):
            t0 = time.perf_counter()
            got["window_start"] = time.time()
            while True:
                with span(STEP_SPAN):
                    _, _, m = step(params, state,
                                   {"tokens": pool[i % len(pool)]})
                losses.append(m["loss"])
                i += 1
                over = float(time.perf_counter() - t0 >= job["seconds"])
                flag = torch.full((), over, device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                flags.append(flag)
                if len(flags) > 1 and float(flags[-2]) > 0:
                    break
            dist.barrier()
            common.sync(device)
            got["window_s"] = time.perf_counter() - t0

    dist.barrier()
    common.sync(device)
    if job["trace"]:
        path = Path(job["out"]) / f"{cell.name}.rank{rank}.trace.json"
        _profiled(window, path)
        if rank == 0:
            log(job, "window closed, traces written")
        tr = read_trace(path)
        if rank:
            got["busy_s"] = tr.busy_s()
        else:
            with open(parsed_trace(job["out"], cell.name), "wb") as f:
                pickle.dump(tr, f, protocol=pickle.HIGHEST_PROTOCOL)
        del tr
    else:
        window()
        if rank == 0:
            log(job, "window closed")
    got["window_peak"] = common.peak_bytes(device)
    got["steps"] = len(losses)
    got["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    return got


def _profiled(window, path: Path) -> None:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        window()
    prof.export_chrome_trace(str(path))


def parsed_trace(out, workload: str) -> Path:
    """Where rank 0 leaves its trace, parsed (a pickled `trace.Trace`)."""
    return Path(out) / f"{workload}.rank0.trace.pickle"


def load_trace(path: Path) -> trace.Trace:
    """The pickled trace at `path`; the file is deleted."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        os.unlink(path)


def read_trace(path: Path) -> trace.Trace:
    """The Chrome trace at `path`, parsed; the file is deleted."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return trace.parse(data.get("traceEvents", data)
                       if isinstance(data, dict) else data)


# -- the ranks together ----------------------------------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def join(procs, deadline_s: float) -> None:
    """Wait for every process to exit 0.  Past the deadline, or as soon
    as one exits otherwise, kill them all and raise."""
    end = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with "
                                   f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {[r for r, c in enumerate(codes) if c is None]} "
                    f"still running after {deadline_s:.0f} s")
            multiprocessing.connection.wait(
                [p.sentinel for p, c in zip(procs, codes) if c is None],
                timeout=min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()


def launch(cell, seed: int, seconds: float, trace_on: bool,
           device_type: str, window: bool = True, target=None,
           out: Optional[Path] = None, started: Optional[float] = None
           ) -> List[Dict[str, Any]]:
    """Run `target(rank, job)` (by default `rank_main`) in one process a
    rank and return each rank's readings, rank 0 first."""
    target = rank_main if target is None else target
    mix = cell.mix
    world = mix["ranks"]
    out = out_dir() if out is None else Path(out)
    out.mkdir(parents=True, exist_ok=True)
    deadline_s = mix["deadline_s"] + (seconds if window else 0.0)
    job = {"cell": cell, "seed": seed, "seconds": seconds,
           "trace": trace_on, "window": window, "world": world,
           "port": free_port(), "device_type": device_type,
           "deadline_s": deadline_s, "out": str(out),
           "started": time.time() if started is None else started}
    files = [out / f"{cell.name}.rank{r}.json" for r in range(world)]
    for f in files:
        f.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, job)) for r in range(world)]
    for p in procs:
        p.start()
    join(procs, deadline_s)
    got = []
    for f in files:
        got.append(json.loads(f.read_text()))
        f.unlink()
    return got


# -- the reference ---------------------------------------------------------

def cards(cell, device) -> List[torch.device]:
    """The devices the ranks ran on, in rank order."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", r) for r in range(cell.mix["ranks"])]
    return [torch.device("cpu")] * cell.mix["ranks"]


def proof_batches(cell, seed: int, device) -> torch.Tensor:
    """The global batches of the proof steps, as the ranks drew them."""
    mix = cell.mix
    gb = mix["ranks"] * mix["rank_batch"]
    pool = inputs.token_pool(seed, inputs.TOKENS,
                             (mix["pool_batches"], gb, mix["seq_len"]),
                             cell.sizes.vocab, device)
    return pool[:mix["proof_steps"]].clone()


def replicas(cell, seed: int, devices) -> List[Dict[str, Any]]:
    """The seed's params drawn on the first device and copied to each
    other one (`decoder.train_replicas`)."""
    first = inputs.make_params(cell.sizes, seed, devices[0])
    out = [first]
    for dev in devices[1:]:
        out.append({k: v.to(dev, copy=True) if k != "blocks" else
                    [{n: x.to(dev, copy=True) for n, x in blk.items()}
                     for blk in v] for k, v in first.items()})
    return out


def reference(cell, seed: int, batches, kind: str, devices
              ) -> Dict[str, Any]:
    """The reference's steps from the seed's params over `batches`, a
    replica a device (`decoder.train_replicas`): its readings and
    `change`."""
    s = cell.sizes
    decoder.no_tf32()
    reps = replicas(cell, seed, devices)
    with ThreadPoolExecutor(len(reps)) as pool:
        # a thread a device, so that the devices take their rows at once
        got = decoder.train_replicas(reps, batches, s, cell.mix["optimizer"],
                                     decoder.Precision(kind), pool.map)
    got["change"] = change_norms(reps[0], s, seed, devices[0])
    del reps
    common.free(devices[0])
    return got


def readings(cell, seed: int, control: bool, fault: bool, lower: bool,
             device, seconds: float = 0.0):
    """`perfbench.calibrate`'s readings: the ranks' proof steps (no
    window), the fp8 control and the half-batch fault, each against the
    f32 reference, computed once."""
    prog = launch(cell, seed, 0.0, False, torch.device(device).type,
                  window=False)[0]["prog"] if lower else None
    devices = cards(cell, device)
    batches = proof_batches(cell, seed, devices[0])
    ref = reference(cell, seed, batches, "f32", devices)
    out = []
    if lower:
        out.append(("program", compare.train_numbers(prog, ref)))
    if control:
        got = reference(cell, seed, batches, "fp8", devices)
        out.append(("control", compare.train_numbers(got, ref)))
    if fault:
        half = batches[:, :max(1, batches.shape[1] // 2)]
        got = reference(cell, seed, half, "f32", devices)
        out.append(("fault_half_batch", compare.train_numbers(got, ref)))
    return out


def run(cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float) -> Outcome:
    s, mix = cell.sizes, cell.mix
    started = time.time() - (time.perf_counter() - t_start)
    ranks = launch(cell, seed, seconds, trace_on, torch.device(device).type,
                   started=started)
    job = {"started": started}
    r0 = ranks[0]
    tr = None
    if trace_on:
        t0 = load_trace(parsed_trace(out_dir(), cell.name))
        tr = MeshTrace(t0.device, t0.host, t0.window,
                       [r["busy_s"] for r in ranks[1:]])
        log(job, "rank 0's trace read")
    devices = cards(cell, device)
    ref = reference(cell, seed, proof_batches(cell, seed, devices[0]), "f32",
                    devices)
    log(job, "reference done")
    ok, checks = compare.judge(compare.train_numbers(r0["prog"], ref),
                               cell.limits)
    b, t, n = mix["rank_batch"], mix["seq_len"], r0["steps"]
    tokens = n * b * t * mix["ranks"]
    window_peak = max(r["window_peak"] for r in ranks)
    return Outcome(
        end_to_end={"train_tokens_per_s": tokens / r0["window_s"],
                    "setup_s": r0["window_start"] - started},
        counters={"steps": n, "window_s": r0["window_s"], "tokens": tokens,
                  "step_flops": flops.train_flops(s, b, t),
                  "attention_shape": (b, t, s.n_heads, s.head_dim),
                  "flash_kernels": ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"),
                  "window_peak_bytes": window_peak},
        attempted=n, failed=r0["failed"],
        memory_peak_bytes=max(max(r["setup_peak"], r["window_peak"])
                              for r in ranks),
        correct=ok and r0["failed"] == 0, checks=checks, trace=tr)

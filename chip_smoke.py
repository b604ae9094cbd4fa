"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases: (1) the device and its power limit; (2) build the CUDA kernels
from `volcano_tpu_torch/csrc`; (3) hold the flash-forward kernel against
its plain PyTorch version at every shape and dtype it serves; (4) time
the kernel, its plain version and, as a yardstick only,
`scaled_dot_product_attention` at the serving shape; (5) the same two
checks for the backward kernels: dQ and the Delta it writes against
`flash_bwd_dq_plain` and `bwd_delta`, dK/dV (on that Delta) against
`flash_bwd_plain`, with the backward of `scaled_dot_product_attention`
as the yardstick;
(6) full-width parity of the model's flash path against its eager
attention path in f32, on logits and on every parameter's gradient;
(7) the serving slice: the flagship d2048-L8 model in bf16 behind
`BatchedServer` at batch 8 x 2048 tokens, with the kernel's launches
counted, then the replica entry point `serve.run`; (8) the training
slice: six steps of the flagship d2048-L8 model in bf16 at batch
8 x 2048 through `train.make_train_step`, with every kernel's launches
counted, the step time, tokens/s and model FLOP/s, a profile of one
step, and the remat check; (9) the scheduled worker as a vcjob's
container runs it, `python -m volcano_tpu_torch.workloads.worker` on
nccl, seeing this one card (`CUDA_VISIBLE_DEVICES`), so its launcher
runs one rank: a fresh run, a resume from a step-5 checkpoint, and the
refusal to resume from a stamp newer than every checkpoint, each with
one JSON line and one progress stream; (10) `phase_sharded`: the same
flagship training at full width through the sharded mesh step (params
and AdamW state as DTensors laid out by `model.param_shardings`, the
forward on the local shards) over a one-rank nccl group with mesh
fsdp 1 x tp 1, its memory after init and its peak, checkpointed at
step 3 (8.0 GB of f32 params, mu and nu through
`torch.distributed.checkpoint`), restored into fresh state and
continued: losses, launches, bit-identical state, save and restore
rates, and the mesh step's cost over the plain step; (11) `phase_sp`:
with two or more GPUs, the flagship trained with its sequence over sp 2
on nccl, Ulysses (the flash kernels inside) against phase_train's
one-card flash step and the ring against a one-card eager step; on one
GPU it prints that it did not run, and why; (12) `phase_moe`: the MoE
flagship (`flagship_moe_config`, 4 experts in the odd layers, top-2,
capacity 1.5, 1.272 G params) trained for six steps at batch 8 x 2048
with every kernel's launches counted, its step time, tokens/s and MFU
(experts counted by the slots they process), memory, a no-grad
forward, two more steps with dense dispatch, and one f32 step at 2
layers on the card against the CPU (gradients and routes); (13)
`phase_pp`: phase_train's model, weights and batch through the GPipe
step at pp 1 on a one-rank nccl group, 4 microbatches, held against
phase_train's losses and norms; (14) `phase_schedule`: the port's
control plane on this machine -- its node (the GPUs torch sees, the
product as GPU Feature Discovery names it) verified Healthy by three
syncs of the node agent's GPU chip collector and health handler; a
backlog of 128 vcjobs in two queues (1- and 8-GPU single-host jobs,
gangs of 4, 16 and 32 hosts, every third gang capped at its IB fabric)
scheduled under the default conf onto 1024 simulated HGX H100 hosts in
32 fabrics until a cycle binds nothing, with each cycle's wall time and
the invariants of what is bound; and a vcjob with the torch and svc job
plugins scheduled onto this node and launched as the port's worker on
cuda with the env the plugins injected; (15) `phase_wire`: half that
fleet and backlog (512 hosts, 64 vcjobs) scheduled by the port's
control plane as separate processes that meet only at the state
server over HTTP (`python -m
volcano_tpu_torch.server` over a durable data dir with a bearer token,
`python -m volcano_tpu_torch --components controllers` and `...
--components scheduler --leader-elect`), this script as kubectl and as
the kubelet: the invariants read back from the server, a vcjob bound
over the wire and run on cuda,
the server's GPU guard refusing an overcommitting bind and a stale pod
write, and a kill -9 of the server with its recovery (every acked bind
kept, the clients resynced, the job still Running), each with its host
times and the WAL's fsyncs; (16) `phase_preempt`: phase_schedule's
settled fleet under the default conf with gangpreempt, preempt and
reclaim before backfill -- a spot layer of research jobs that run with
one pod of eight fills three research-only fabrics whose jobs finished
(the backlog runs at its gang floor, which preemption never breaks),
then a PriorityClass above both, a prod gang of 32 whole hosts held to
one IB fabric and 8 8-GPU single-host jobs in research, then prod's
weight raised from 2 to 3 and 8 such jobs in prod; then, with
gangreclaim on the conf and the weights turned to research 3, prod 1,
a research gang of 32 hosts held to one NVLink domain that prod's
fillers hold -- with evictions and GPUs taken back by action, each
cycle's ms by action, each preemptor's submit-to-bound s and the
invariants read after every cycle; (17) `phase_failover`: a vcjob on this card trains the worker's
tiny f32 model on cuda and checkpoints every 2 steps, the node agent
reports the card's host Failed over its K ticks, the failover
controller drains the job with one restart, quarantines the NVLink
domain and stamps the last checkpoint step, and once the host is
healthy and the quarantine lifted the job rebinds to the card, where
the port's worker resumes at the stamped step; its loss is held
against the uninterrupted run's (1e-4 relative); (18) `phase_cli`: a
deploy bundle rendered by `python -m volcano_tpu_torch.bundle` for 4 IB
fabrics of 32 HGX H100 hosts, its server, controllers and scheduler
started from its units, its cluster-init.sh registering the hosts
through the port's vtpctl, then a queue, a one-GPU job from YAML
pinned to this card, a 16-host gang held to one fabric, the views,
vsuspend/vresume and vcancel, each a `python -m
volcano_tpu_torch.cli.vtpctl --server` call; the card job's pod run as
the worker on cuda; the live /metrics held to the bundle's label
schema; (19) `phase_federation`: a global state server, two regional
GPU planes (`local` with this machine's node, `remote` cheaper) and
`python -m volcano_tpu_torch.federation.router` as processes; 12
16-host gangs and a one-GPU job on this card admitted across both,
the card job's steps folded into the router's learned goodput, then
remote's server killed with SIGKILL: the loss detected, its gangs
requeued with the attempt bumped and rebound in local as far as it
has room, no acked step lost.

The kernel phases (3)-(5) also hold and time the kernels at the shapes
beyond d in {128, 256} and t % 128 == 0 (d = 384 and 512 on the
CUDA-core kernels, t = 192 and 197 with partial tiles) and at one
rank's Ulysses shapes, [8, 2048, 4, 128] and [2, 8192, 4, 128].

Any failure raises, so the exit code is not 0.  Without a GPU it exits
non-zero before printing any result.  The last line is the device
record `{"ok": true, "device": {...}}`; the line before it holds the
kernels' numbers, and the one before that the worker's and the sharded
run's.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import torch

# Published peaks (NVIDIA data sheets, dense): (bf16 FLOP/s, bytes/s)
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}
SLICE_SHAPE = (8, 2048, 16, 128)          # b, t, h, d of the serving slice
SLICE_REQUESTS = 40
RANK_SHAPES = ((4, 2048, 8, 128), (2, 2048, 16, 128))
# shapes beyond d in {128, 256} and t % 128 == 0: t an odd multiple of
# 64, d = 384 and 512 (the CUDA-core kernels), t % 4 != 0 (lse and Delta
# in padded rows)
EXTRA_SHAPES = ((1, 192, 2, 128), (1, 256, 2, 384), (1, 256, 2, 512),
                (1, 197, 2, 128))
# one rank's flash call under Ulysses: the flagship's 16 heads over sp 4
# at batch 8 x 2048, the long-context run at batch 2 x 8192, and
# phase_sp's 16 heads over sp 2
ULYSSES_SHAPES = ((8, 2048, 4, 128), (2, 8192, 4, 128), (8, 2048, 8, 128))
ATOL_F32 = 1e-4   # f32: the kernel and the plain version differ only in sum order
# bf16 out: both sides compute in f32 and round once to bf16, and one bf16
# step is 2^-8 of the value, so a sum-order difference can move a value
# by one step; the forward, dQ and dK/dV kernels also round P (and dS) to
# bf16 before their second products. 1e-2 absolute plus 1e-2 relative
# covers both (the worst case measured uses three quarters of it).
TOL_BF16 = 1e-2
ATOL_PARITY = 2e-3  # f32 logits, flash vs eager attention over 2 layers
# f32 gradients, flash vs eager attention over 2 layers: sum order only,
# but the backward's sums cancel, so each leaf is held relative to its
# largest gradient
GRAD_PARITY_SHARE = 1e-3
# remat against no remat: the same ops on the same values, but for the
# order in which scatter-adds (the embedding's gradient) accumulate
REMAT_SHARE = 1e-5
# the flagship with its sequence over sp 2 against the one-card step,
# bf16 (tests/test_torch_gpu.py's RTOL_SP_BF16, where the readings are)
RTOL_SP_BF16 = dict(losses=1.5e-4, norms=7e-4)
SP_STEPS = 4          # lr(0) = 0: steps 3 and 4 follow real updates
# the MoE flagship: steps with capacity dispatch, then with dense dispatch
MOE_DENSE_STEPS = 2
# the MoE step at 2 layers in f32 on the card against the CPU: each
# gradient leaf within this share of its largest value (sum order and the
# f32 CUDA-core attention against the plain version; the routes must be
# identical, so no token changes expert)
MOE_PARITY_SHARE = 1e-3
MOE_PARITY_BATCH = (2, 256)
# the pipelined flagship at pp 1 against phase_train's step, bf16: the
# same ops on microbatches of 2 rows, so cuBLAS tiles the products
# otherwise and each weight's gradient is rounded to bf16 a microbatch
# before the f32 sum.  Stated before the first run from the nearest
# readings, the sp paths' (tests/test_torch_gpu.py's RTOL_SP_BF16: the
# products on a share of the rows, the gradients summed in pieces), at
# the same bounds
RTOL_PP_BF16 = dict(losses=1.5e-4, norms=7e-4)
PP_MICROBATCHES = 4
TRAIN_STEPS = 6
TRAIN_BATCH = 8
RESUME_STEPS = 5      # the mesh run; checkpointed after step SAVE_STEP
SAVE_STEP = 3
WORKER_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_qkv(shape, dtype, seed, fused=False):
    """Three [b, t, h, d] tensors; with `fused`, strided views of one
    [b, t, 3, h, d] tensor, as a fused qkv projection gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        b, t, h, d = shape
        x = torch.randn((b, t, 3, h, d), generator=g, device="cuda")
        return list(x.to(dtype).unbind(2))
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def phase_device():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false\n")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    return name, smi


def ptxas_report(text):
    """{(kernel, head dim): (registers, spill store bytes)} of the bf16
    kernels, from ptxas' -v output in the build log."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        k = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv)_bf16_kernel"
                      r"ILi(\d+)E", name or "")
        if not k:
            continue
        key = (k.group(1), int(k.group(2)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            report[key] = (None, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[key] = (int(m.group(1)), report.get(key, (0, 0))[1])
    return report


def phase_build(build):
    """Build the kernels and print ptxas' report; fails if a bf16 kernel
    spills or ptxas serialises a wgmma ("Performance Loss")."""
    t0 = time.monotonic()
    build.load_library()
    log(f"[build] kernels built and loaded in {time.monotonic() - t0:.1f} s "
        f"({build.build_dir()})")
    text = build.build_log()
    loss = []
    for line in text.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "error", "Performance Loss")):
            log(f"[build] {line.strip()}")
        if "Performance Loss" in line:
            loss.append(line.strip())
    report = ptxas_report(text)
    for (kern, d), (regs, spill) in sorted(report.items()):
        log(f"[build] {kern} bf16 d={d}: {regs} registers at entry, "
            f"{spill} bytes spilled")
    spilled = sorted(key for key, (_, spill) in report.items() if spill)
    if len(report) != 6 or spilled or loss:
        raise AssertionError(f"ptxas: {len(report)} of 6 bf16 kernels "
                             f"reported, spills in {spilled}, {loss}")
    return report


def kernel_cases():
    """(shape, dtype, causal, fused): fused cases take q/k/v (and dO) as
    strided views of one [b, t, 3, h, d] tensor, so the kernels' TMA
    tensor maps meet non-contiguous strides.  The per-rank shapes of the
    sharded step (RANK_SHAPES) and of Ulysses (ULYSSES_SHAPES) are held
    here because the one-card phases launch the kernels at the full
    SLICE_SHAPE only."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for shape in ((2, 256, 2, 128), (1, 384, 4, 128),
                          (1, 256, 2, 256)) + EXTRA_SHAPES:
                cases.append((shape, dtype, causal, False))
    cases.append(((2, 256, 2, 128), torch.bfloat16, True, True))
    cases.append(((1, 256, 2, 256), torch.bfloat16, False, True))
    cases.append(((1, 256, 2, 384), torch.bfloat16, True, True))
    cases.append((SLICE_SHAPE, torch.bfloat16, True, False))
    # one rank's launch of the flagship's global batch on 4 GPUs: fsdp 2
    # x tp 2 (4 rows, 8 heads) and fsdp 4 (2 rows, 16 heads), and Ulysses
    for shape in RANK_SHAPES + ULYSSES_SHAPES:
        cases.append((shape, torch.bfloat16, True, False))
    return cases


def case_tag(shape, dtype, causal, fused):
    return (f"{list(shape)} {str(dtype)[6:]} causal={causal}"
            + (" fused-qkv views" if fused else ""))


def bound(flops, nbytes, flop_peak, byte_peak):
    op_ms, byte_ms = flops / flop_peak * 1e3, nbytes / byte_peak * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def phase_kernel_vs_plain(fa):
    """Kernel against its plain version for out and lse; returns the
    max out error at the serving shape."""
    slice_err = None
    for i, (shape, dtype, causal, fused) in enumerate(kernel_cases()):
        q, k, v = rand_qkv(shape, dtype, seed=100 + i, fused=fused)
        out, lse = fa._launch(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tag = case_tag(shape, dtype, causal, fused)
        log(f"[kernel] {tag}: max|out err| {err:.3e}, "
            f"max|lse err| {lse_err:.3e}")
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref_out, atol=ATOL_F32,
                                       rtol=0.0)
        else:
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=TOL_BF16, rtol=TOL_BF16)
        torch.testing.assert_close(lse, ref_lse, atol=ATOL_F32, rtol=0.0)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"non-finite kernel output at {tag}")
        if shape == SLICE_SHAPE and not fused:
            slice_err = err
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return slice_err


def fwd_timing(fa, shape, flop_peak, byte_peak, iters=20):
    """The forward kernel, its plain version and SDPA at a bf16 causal
    shape, beside the kernel's bound."""
    b, t, h, d = shape
    q, k, v = rand_qkv(shape, torch.bfloat16, seed=7)
    kernel_ms = cuda_time_ms(lambda: fa._launch(q, k, v, True), iters=iters)
    plain_ms = cuda_time_ms(lambda: fa.flash_fwd_plain(q, k, v, True),
                            iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # views, no copy
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=iters)
    # the causal work this input needs: t(t+1)/2 scores a (batch, head),
    # two products of 2*d FLOP each
    flops = 4.0 * b * h * d * t * (t + 1) / 2
    nbytes = 4 * b * t * h * d * 2 + b * h * t * 4   # q,k,v,out + lse
    bound_ms, bound_by = bound(flops, nbytes, flop_peak, byte_peak)
    log(f"[timing] {list(shape)} bf16 causal: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops:.4e} FLOP, {nbytes:.4e} B)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_timing(fa, flop_peak, byte_peak):
    """fwd_timing at the serving shape, which the kernels line reports,
    then at EXTRA_SHAPES and ULYSSES_SHAPES, logged only."""
    res = fwd_timing(fa, SLICE_SHAPE, flop_peak, byte_peak)
    for shape in EXTRA_SHAPES + ULYSSES_SHAPES:
        fwd_timing(fa, shape, flop_peak, byte_peak)
    return res


def full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_parity(model):
    full_f32()
    cfg_flash = model.flagship_config(n_layers=2, dtype=torch.float32)
    cfg_eager = model.flagship_config(n_layers=2, dtype=torch.float32,
                                      use_flash_attention=False)
    params = model.init_params(
        cfg_flash, torch.Generator(device="cuda").manual_seed(3), "cuda")
    tokens = torch.randint(0, cfg_flash.vocab_size, (2, 2048), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    with torch.inference_mode():
        l_flash = model.forward(params, tokens, cfg_flash)
        l_eager = model.forward(params, tokens, cfg_eager)
    err = (l_flash - l_eager).abs().max().item()
    log(f"[parity] flagship d2048 n_layers=2 f32, tokens [2, 2048]: "
        f"max|logits flash - eager| {err:.3e} (tolerance {ATOL_PARITY})")
    if not torch.isfinite(l_flash).all():
        raise AssertionError("non-finite logits on the flash path")
    torch.testing.assert_close(l_flash, l_eager, atol=ATOL_PARITY, rtol=0.0)
    del params, l_flash, l_eager
    torch.cuda.empty_cache()
    return err


def phase_bwd_vs_plain(fa):
    """The dQ kernel against `flash_bwd_dq_plain` for dq and against
    `bwd_delta` for the Delta it writes, and the dK/dV kernel, on that
    Delta, against `flash_bwd_plain` for dk and dv; on the forward
    kernel's out and lse. Returns the largest error of each kernel at
    the training shape."""
    slice_err = None
    for i, (shape, dtype, causal, fused) in enumerate(kernel_cases()):
        q, k, v = rand_qkv(shape, dtype, seed=200 + i, fused=fused)
        # the middle one: in a fused case a view that starts inside its
        # tensor, so the TMA base is offset too
        do = rand_qkv(shape, dtype, seed=300 + i, fused=fused)[1]
        out, lse = fa._launch(q, k, v, causal)
        dq, delta = fa._launch_dq(q, k, v, out, do, lse, causal)
        dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        ref_dq, _ = fa.flash_bwd_dq_plain(q, k, v, out, do, lse, causal)
        ref_delta = fa.bwd_delta(out, do)
        _, ref_dk, ref_dv = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
        got, ref = (dq, dk, dv), (ref_dq, ref_dk, ref_dv)
        errs = [(x.float() - r.float()).abs().max().item()
                for x, r in zip(got, ref)]
        delta_err = (delta - ref_delta).abs().max().item()
        tag = case_tag(shape, dtype, causal, fused)
        big = max(r.float().abs().max().item() for r in ref)
        log(f"[bwd kernel] {tag}: max|err| dq {errs[0]:.3e}, dk "
            f"{errs[1]:.3e}, dv {errs[2]:.3e} (max|grad| {big:.3e}); "
            f"delta {delta_err:.3e} (max|delta| "
            f"{ref_delta.abs().max().item():.3e})")
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(x.float()).all():
                raise AssertionError(f"non-finite {name} at {tag}")
            if dtype == torch.float32:
                torch.testing.assert_close(x, r, atol=ATOL_F32, rtol=0.0)
            else:
                torch.testing.assert_close(x.float(), r.float(),
                                           atol=TOL_BF16, rtol=TOL_BF16)
        # Delta: f32 sums of the same products in another order
        torch.testing.assert_close(delta, ref_delta, atol=ATOL_F32, rtol=0.0)
        if shape == SLICE_SHAPE and not fused:
            slice_err = {"dq": errs[0], "dkv": max(errs[1:]),
                         "delta": delta_err}
        del q, k, v, do, out, lse, delta, dq, dk, dv, got, ref, ref_delta
    torch.cuda.empty_cache()
    return slice_err


def bwd_timing(fa, shape, flop_peak, byte_peak, iters=20, profile=False):
    """The dQ and dK/dV kernels alone, the whole `flash_bwd`, the plain
    versions and, as the yardstick of the two kernels together, the
    backward of `scaled_dot_product_attention` (grad of a stored
    output), at a bf16 causal shape; with `profile`, one `flash_bwd`
    under the profiler, which must run the two kernels and nothing
    else."""
    b, t, h, d = shape
    q, k, v = rand_qkv(shape, torch.bfloat16, seed=17)
    do = rand_qkv(shape, torch.bfloat16, seed=18)[0]
    out, lse = fa._launch(q, k, v, True)
    _, delta = fa._launch_dq(q, k, v, out, do, lse, True)
    dq_ms = cuda_time_ms(
        lambda: fa._launch_dq(q, k, v, out, do, lse, True), iters=iters)
    dkv_ms = cuda_time_ms(
        lambda: fa._launch_dkv(q, k, v, do, lse, delta, True), iters=iters)
    bwd_ms = cuda_time_ms(
        lambda: fa.flash_bwd(q, k, v, out, lse, do, True), iters=iters)
    if profile:
        # what one flash_bwd runs on the device: the two kernels and
        # nothing else (Delta comes from the dQ kernel, not a torch op)
        _, by_name = profile_kernels(
            lambda: fa.flash_bwd(q, k, v, out, lse, do, True))
        if not by_name:
            log("[bwd timing] the profiler saw no device kernels: what "
                "flash_bwd runs is not measured")
        elif sorted(kernel_group(n) for n in by_name) != ["flash_bwd_dkv",
                                                          "flash_bwd_dq"]:
            raise AssertionError(f"flash_bwd ran {sorted(by_name)}")
        else:
            log(f"[bwd timing] flash_bwd runs {sorted(by_name)} and "
                "nothing else")
    dq_plain_ms = cuda_time_ms(
        lambda: fa.flash_bwd_dq_plain(q, k, v, out, do, lse, True), iters=3,
        warmup=1)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, True), iters=3,
        warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), iters=iters)
    pairs = b * h * t * (t + 1) / 2
    tensor = b * t * h * d * 2
    rows = b * h * t * 4
    # dQ: S, dP, dQ products; reads q,k,v,do,out,lse, writes dq,delta
    dq_bound = bound(3 * 2.0 * d * pairs, 6 * tensor + 2 * rows,
                     flop_peak, byte_peak)
    # dK/dV: S, dP, dV, dK products; reads q,k,v,do,lse,delta, writes dk,dv
    dkv_bound = bound(4 * 2.0 * d * pairs, 6 * tensor + 2 * rows,
                      flop_peak, byte_peak)
    log(f"[bwd timing] {list(shape)} bf16 causal: dq kernel "
        f"{dq_ms:.4f} ms (bound {dq_bound[0]:.4f}, {dq_bound[1]}), dkv "
        f"kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f}, "
        f"{dkv_bound[1]}); flash_bwd whole {bwd_ms:.4f} ms against sdpa "
        f"backward {library_ms:.4f} ms ({bwd_ms / library_ms:.3f}x); plain "
        f"dq {dq_plain_ms:.4f} ms, plain dq, dk, dv {plain_ms:.4f} ms")
    del q, k, v, do, out, lse, delta, qt, kt, vt, ref, dot
    torch.cuda.empty_cache()
    return {"dq": dict(ms=dq_ms, bound_ms=dq_bound[0],
                       bound_by=dq_bound[1], plain_ms=dq_plain_ms),
            "dkv": dict(ms=dkv_ms, bound_ms=dkv_bound[0],
                        bound_by=dkv_bound[1], plain_ms=plain_ms),
            "library_ms": library_ms, "bwd_ms": bwd_ms}


def phase_bwd_timing(fa, flop_peak, byte_peak):
    """bwd_timing at the training shape, which the kernels line reports,
    with the profile; then at EXTRA_SHAPES and ULYSSES_SHAPES, logged
    only."""
    res = bwd_timing(fa, SLICE_SHAPE, flop_peak, byte_peak, profile=True)
    for shape in EXTRA_SHAPES + ULYSSES_SHAPES:
        bwd_timing(fa, shape, flop_peak, byte_peak)
    return res


def leaf_items(tree):
    out = [(k, x) for k, x in tree.items() if k != "blocks"]
    for i, blk in enumerate(tree["blocks"]):
        out += [(f"blocks.{i}.{k}", x) for k, x in blk.items()]
    return out


def worst_leaf_share(grads, ref):
    """max over leaves of max|g - ref| / max|ref|, and its leaf."""
    shares = [((a.float() - b.float()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30), name)
              for (name, a), (_, b) in zip(leaf_items(grads),
                                           leaf_items(ref))]
    return max(shares)


def phase_grad_parity(model, train):
    """loss_fn and its gradient for every param leaf, flash path against
    the eager path, flagship widths at 2 layers, f32 (no TF32), tokens
    [2, 2048]."""
    full_f32()
    cfg_flash = model.flagship_config(n_layers=2, dtype=torch.float32)
    cfg_eager = model.flagship_config(n_layers=2, dtype=torch.float32,
                                      use_flash_attention=False)
    params = model.init_params(
        cfg_flash, torch.Generator(device="cuda").manual_seed(3), "cuda")
    t = SLICE_SHAPE[1]
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(4), cfg_flash, 2, t)
    loss_f, g_flash = train.value_and_grad(params, batch, cfg_flash)
    loss_e, g_eager = train.value_and_grad(params, batch, cfg_eager)
    share, leaf = worst_leaf_share(g_flash, g_eager)
    dloss = abs(loss_f.item() - loss_e.item())
    log(f"[grad parity] flagship d2048 n_layers=2 f32, tokens [2, {t}]: "
        f"loss flash {loss_f.item():.6f} eager {loss_e.item():.6f}; "
        f"max|dgrad| / max|grad| {share:.3e} at {leaf} (tolerance "
        f"{GRAD_PARITY_SHARE})")
    if not all(torch.isfinite(g).all() for _, g in leaf_items(g_flash)):
        raise AssertionError("non-finite gradients on the flash path")
    if dloss > ATOL_PARITY or share > GRAD_PARITY_SHARE:
        raise AssertionError("flash and eager gradients disagree")
    del params, g_flash, g_eager
    torch.cuda.empty_cache()
    return share


def profile_kernels(fn):
    """(host wall ms, {kernel name: (device ms, launches)}) of fn() under
    torch.profiler; the window ends with a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    return wall_ms, by_name


def kernel_group(name: str) -> str:
    low = name.lower()
    for key in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if key in low:
            return key
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "elementwise"


def log_top(tag, by_name, n=10):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    for name, (ms, k) in top:
        log(f"[{tag}]   {ms:9.3f} ms  x{k:<4d} {name[:110]}")


def profile_forward(fwd, batch):
    """Device time of one forward by kernel, from torch.profiler: the
    flash kernel, the matmuls (cuBLAS) and the rest; and the device's
    idle share of the forward's host wall time."""
    wall_ms, by_name = profile_kernels(lambda: fwd(batch))
    if not by_name:
        log("[profile] the profiler saw no device kernels: not measured")
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    groups = {"flash_fwd": 0.0, "matmul": 0.0, "elementwise": 0.0}
    for name, (ms, _) in by_name.items():
        groups[kernel_group(name)] += ms
    log(f"[profile] one forward: host wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})"
                    for k, v in groups.items()))
    log_top("profile", by_name)


def phase_slice(model, serve, fa):
    b, t, h, d = SLICE_SHAPE
    cfg = model.flagship_config()
    t0 = time.monotonic()
    fwd = serve.torch_forward(max_batch=b, cfg=cfg, seq_len=t)
    log(f"[slice] flagship d2048-L8 bf16 built and warmed in "
        f"{time.monotonic() - t0:.1f} s")
    forwards, logits = [], []

    def counted(n):
        t1 = time.monotonic()
        out = fwd(n)
        forwards.append((time.monotonic() - t1) * 1e3)
        logits.append(out)
        del logits[:-1]
        return out

    server = serve.BatchedServer(counted, max_batch=b, slo_ms=1000.0)
    fa.flash_fwd.launches = 0
    now = time.monotonic()
    for _ in range(SLICE_REQUESTS):
        server.offer(now)
    served = server.drain()
    launches = fa.flash_fwd.launches
    out = logits[-1]
    log(f"[slice] requests offered {SLICE_REQUESTS}, answered "
        f"{server.requests}, forwards {len(forwards)}, flash launches "
        f"{launches}; p50 {server.latency.p50_ms:.3f} ms, p99 "
        f"{server.latency.p99_ms:.3f} ms; forward ms "
        f"{[round(x, 3) for x in forwards]}")
    if served != SLICE_REQUESTS or server.requests != SLICE_REQUESTS:
        raise AssertionError("not every offered request was answered")
    if launches != cfg.n_layers * len(forwards):
        raise AssertionError(f"{launches} flash launches for "
                             f"{len(forwards)} forwards of {cfg.n_layers} "
                             "layers")
    if tuple(out.shape) != (b, t, cfg.vocab_size) or \
            not torch.isfinite(out.float()).all():
        raise AssertionError("serving logits are not finite "
                             f"[{b}, {t}, {cfg.vocab_size}]")
    # steady forwards: the first may still carry one-off costs
    forward_ms = sorted(forwards[1:])[len(forwards[1:]) // 2]
    del logits, out, server
    profile_forward(fwd, b)
    del fwd
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    res = serve.run({"SERVE_MODE": "torch", "SERVE_DEVICE": "cuda",
                     "SERVE_DURATION_S": "2"})
    log(f"[slice] serve.run SERVE_MODE=torch (tiny config) "
        f"{time.monotonic() - t0:.1f} s: {json.dumps(res)}")
    if res["requests"] <= 0:
        raise AssertionError("serve.run answered no request")
    return dict(launches=launches, forwards=len(forwards),
                forward_ms=forward_ms)


def launch_counts(fa):
    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd.launches_dq,
            "flash_bwd_dkv": fa.flash_bwd.launches_dkv}


def zero_counts(fa):
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches_dq = 0
    fa.flash_bwd.launches_dkv = 0


def model_flops(cfg, params, b, t):
    """Model FLOP of one training step by the reference bench's
    accounting (bench.py `_train_one_config`): 6 x matmul params x
    tokens, the embedding lookup excluded and the head included, plus 3x
    the causal attention forward."""
    total = sum(x.numel() for _, x in leaf_items(params))
    matmul_params = total - cfg.vocab_size * cfg.d_model
    attn_fwd = cfg.n_layers * 4.0 * b * cfg.n_heads * t * t * \
        cfg.head_dim / 2
    return 6.0 * matmul_params * b * t + 3.0 * attn_fwd, total


def profile_step(train, cfg, optimizer, params, state, batch):
    """One training step under torch.profiler, in the two calls
    `train_step` makes: the value and gradient of the loss, then the
    optimizer's update.  Device time by kernel group and the device's
    idle share of the step's host wall time."""
    grads = {}

    def grad():
        grads["g"] = train.value_and_grad(params, batch, cfg)[1]

    wall_g, by_g = profile_kernels(grad)
    wall_u, by_u = profile_kernels(
        lambda: optimizer.update(params, grads.pop("g"), state))
    if not by_g or not by_u:
        log("[train profile] the profiler saw no device kernels: not "
            "measured")
        return None
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "elementwise": 0.0}
    for name, (ms, _) in by_g.items():
        groups[kernel_group(name)] += ms
    groups["optimizer"] = sum(ms for ms, _ in by_u.values())
    busy = sum(groups.values())
    wall = wall_g + wall_u
    log(f"[train profile] one step: host wall {wall:.3f} ms (loss and "
        f"grad {wall_g:.3f}, update {wall_u:.3f}), device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                    for k, v in groups.items()))
    log_top("train profile", by_g)
    log_top("train profile optimizer", by_u, n=5)
    return dict(groups, wall_ms=wall, busy_ms=busy)


def phase_train(model, train, fa, flop_peak):
    """The training slice: flagship d2048-L8 bf16, batch 8 x 2048, the
    reference's optimizer defaults, TRAIN_STEPS steps through
    make_train_step, launches counted per step."""
    t = SLICE_SHAPE[1]
    cfg = model.flagship_config()
    t0 = time.monotonic()
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    optimizer = train.make_optimizer()
    state = optimizer.init(params)
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(6), cfg, TRAIN_BATCH, t)
    step = train.make_train_step(cfg, optimizer)
    torch.cuda.synchronize()
    log(f"[train] flagship d2048-L8 bf16, batch {TRAIN_BATCH} x {t}: "
        f"params and optimizer state ready in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    step_ms, losses, norms, per_step = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = launch_counts(fa)
        if i < 2:
            snapshot = [x.detach().clone() for _, x in leaf_items(params)]
        t1 = time.monotonic()
        params, state, metrics = step(params, state, batch)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t1) * 1e3)
        after = launch_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
        norms.append(norm)
        if i < 2:
            same = all(torch.equal(a, x) for a, (_, x) in
                       zip(snapshot, leaf_items(params)))
            del snapshot
            if same != (i == 0):
                raise AssertionError(
                    f"params after step {i + 1} are "
                    f"{'unchanged' if same else 'changed'}: lr(0) = 0 "
                    "must leave them as they are, lr(1) > 0 must move them")
    launches = launch_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] losses {losses}; grad norms {norms}; step ms "
        f"{[round(x, 3) for x in step_ms]}; launches per step {per_step}; "
        f"peak memory {peak_gb:.2f} GB")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("non-finite loss or grad norm")
    want = {k: cfg.n_layers for k in launches}
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want}")
    steady = sorted(step_ms[1:])
    med_ms = steady[len(steady) // 2]
    flops, n_params = model_flops(cfg, params, TRAIN_BATCH, t)
    tflops = flops / med_ms / 1e9
    res = dict(launches=launches, steps=TRAIN_STEPS, step_ms=med_ms,
               losses=losses, norms=norms,
               tokens_per_s=TRAIN_BATCH * t / med_ms * 1e3,
               model_tflops=tflops, mfu_bf16_dense=tflops * 1e12 / flop_peak,
               params_m=n_params / 1e6, peak_gb=peak_gb)
    log(f"[train] median steady step {med_ms:.3f} ms, tokens/s "
        f"{res['tokens_per_s']:.1f}, model {flops:.4e} FLOP a step "
        f"(bench.py accounting, {n_params / 1e6:.1f} M params) = "
        f"{tflops:.1f} TFLOP/s, mfu_bf16_dense {res['mfu_bf16_dense']:.4f}")
    res["profile"] = profile_step(train, cfg, optimizer, params, state,
                                  batch)
    del params, state, batch
    torch.cuda.empty_cache()
    return res


def phase_remat(model, train, fa):
    """The gradient of one step at n_layers=2 with remat against the same
    step without it: the forward kernel runs twice a layer with remat,
    and the gradients agree."""
    cfg = model.flagship_config(n_layers=2)
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(8), cfg, 2, SLICE_SHAPE[1])
    zero_counts(fa)
    loss, grads = train.value_and_grad(params, batch, cfg)
    plain_counts = launch_counts(fa)
    zero_counts(fa)
    loss_r, grads_r = train.value_and_grad(
        params, batch, model.flagship_config(n_layers=2, remat=True))
    remat_counts = launch_counts(fa)
    share, leaf = worst_leaf_share(grads_r, grads)
    log(f"[remat] n_layers=2 bf16, tokens [2, {SLICE_SHAPE[1]}]: launches "
        f"without remat {plain_counts}, with remat {remat_counts}; loss "
        f"{loss.item():.6f} / {loss_r.item():.6f}; max|dgrad| / max|grad| "
        f"{share:.3e} at {leaf} (tolerance {REMAT_SHARE})")
    want = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    if remat_counts != want or plain_counts != dict(want, flash_fwd=2):
        raise AssertionError("remat launch counts are off")
    if share > REMAT_SHARE or loss.item() != loss_r.item():
        raise AssertionError("remat gradients differ")
    del params, grads, grads_r
    torch.cuda.empty_cache()
    return share


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_worker(extra):
    """`python -m volcano_tpu_torch.workloads.worker` as the one pod of a
    one-pod job that sees card 0 alone (CUDA_VISIBLE_DEVICES), so its
    launcher runs one rank on it (WORKER_DEVICE unset): (exit code,
    stdout, stderr, wall seconds)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORKER_DEVICE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(TPU_WORKER_ID="0", NUM_PROCESSES="1", WORKER_STEPS="3",
               CUDA_VISIBLE_DEVICES=os.environ.get(
                   "CUDA_VISIBLE_DEVICES", "0").split(",")[0],
               COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, env.get("PYTHONPATH")) if p))
    env.update({k: str(v) for k, v in extra.items()})
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.workloads.worker"],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=WORKER_TIMEOUT_S)
    return res.returncode, res.stdout, res.stderr, time.monotonic() - t0


def worker_result(rc, out, err):
    """The pod's one JSON line, the last of its stdout."""
    if rc != 0:
        raise AssertionError(f"worker exited {rc}:\n{err[-3000:]}")
    lines = out.strip().splitlines()
    found = [line for line in lines if line.startswith("{")]
    if len(found) != 1 or lines[-1] != found[0]:
        raise AssertionError(f"the pod printed {len(found)} JSON lines, "
                             f"want one as its last line:\n{out[-2000:]}")
    return json.loads(found[0])


def progress_streams(folder):
    """The progress records under `folder`: the pod's one stream, and no
    temporary file left behind."""
    names = os.listdir(folder)
    if len(names) != 1:
        raise AssertionError(f"progress files {names}: want the pod's one")
    with open(os.path.join(folder, names[0])) as f:
        return json.load(f)


def phase_worker(model, train, checkpoint, worker):
    """The worker as the scheduler launches it, on nccl: a fresh run of 3
    steps; a resume from a step-5 checkpoint of its state (start_step 5,
    progress step 8); and, stamped at step 7, the refusal to rewind."""
    keys = {"process_id", "num_processes", "device_count", "collective_sum",
            "loss", "start_step", "slice_id", "num_slices"}
    tmp = tempfile.mkdtemp(prefix="vtp-worker-")
    try:
        progress = os.path.join(tmp, "progress", "vtp-w0.json")
        rc, out, err, fresh_s = launch_worker({"VTP_PROGRESS_FILE": progress})
        fresh = worker_result(rc, out, err)
        record = progress_streams(os.path.dirname(progress))
        log(f"[worker] fresh run {fresh_s:.3f} s: {json.dumps(fresh)}; "
            f"progress {json.dumps(record)}")
        if set(fresh) != keys or not (
                fresh["collective_sum"] == fresh["device_count"] == 1) or \
                not math.isfinite(fresh["loss"]) or \
                (record["step"], record["examples"]) != (3, 3.0):
            raise AssertionError("the fresh worker run is off")

        cfg = worker.worker_config()
        params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cuda")
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save(ckpt, 5, params, train.make_optimizer().init(params))
        del params
        rc, out, err, resume_s = launch_worker({
            "VTP_PROGRESS_FILE": progress, "VTP_CHECKPOINT_DIR": ckpt,
            "VTP_RESUME_STEP": 5})
        resumed = worker_result(rc, out, err)
        record = progress_streams(os.path.dirname(progress))
        log(f"[worker] resumed from step 5 in {resume_s:.3f} s: "
            f"{json.dumps(resumed)}; progress {json.dumps(record)}")
        # the checkpoint holds the worker's fresh state, so the loss too
        # is the fresh run's
        if resumed["start_step"] != 5 or record["step"] != 8 or \
                resumed["loss"] != fresh["loss"]:
            raise AssertionError("the resumed worker run is off")

        rc, out, err, refuse_s = launch_worker({
            "VTP_CHECKPOINT_DIR": ckpt, "VTP_RESUME_STEP": 7})
        lost = [line for line in err.splitlines() if "lost data" in line]
        log(f"[worker] stamped at step 7: exit {rc} in {refuse_s:.3f} s; "
            f"{lost[-1] if lost else err[-500:]}")
        if rc == 0 or not lost or out.strip():
            raise AssertionError("the worker did not refuse to rewind")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(fresh_s=fresh_s, resume_s=resume_s, refuse_s=refuse_s,
                loss=fresh["loss"])


def state_leaves(train, params, state):
    """This rank's tensors of params, mu and nu (the local shards of
    DTensors)."""
    return [train.local(x) for _, x in leaf_items(params)] + \
        [train.local(x) for key in ("mu", "nu")
         for _, x in leaf_items(state[key])]


def time_reduction(train, mesh, params, batch, cfg):
    """Device ms of the mean all-reduce of one step's gradients over the
    data group, as the mesh step runs it (`train.all_reduce_mean`, flat
    buckets) and, for comparison only, as one in-place all_reduce and
    divide a leaf."""
    import torch.distributed as dist
    _, grads = train.value_and_grad(params, batch, cfg, mesh)
    g_list = [train.local(g) for _, g in leaf_items(grads)]
    data = train.data_mesh(mesh)
    group, n = data.get_group(), data.size()

    def per_leaf():
        for g in g_list:
            dist.all_reduce(g, group=group)
            g.div_(n)

    out = dict(reduce_ms=cuda_time_ms(
                   lambda: train.all_reduce_mean(g_list, mesh), iters=5),
               reduce_per_leaf_ms=cuda_time_ms(per_leaf, iters=5),
               grad_gb=sum(g.numel() * g.element_size()
                           for g in g_list) / 1e9)
    del grads, g_list
    torch.cuda.empty_cache()
    return out


def phase_sharded(model, train, fa, bootstrap, mesh_lib, checkpoint, tr):
    """phase_train's run through the sharded mesh step over a one-rank
    nccl group with mesh fsdp 1 x tp 1: params and AdamW state are
    DTensors laid out by `model.param_shardings`, the forward runs on
    their local shards.  RESUME_STEPS steps, saved through DCP after
    SAVE_STEP, restored into fresh state through `resume_state` with the
    stamp SAVE_STEP, and continued.  Losses 1-5 equal phase_train's bit
    for bit (at one rank every gather is skipped and the reductions are
    the identity, so the step runs phase_train's ops), every step
    launches each kernel n_layers times, the restored state is
    bit-identical to the saved one, and the continued losses equal the
    uninterrupted run's.  Prints the memory after init and the peak."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    t = SLICE_SHAPE[1]
    cfg = model.flagship_config()
    bootstrap.initialize({"TPU_WORKER_ID": "0", "NUM_PROCESSES": "1"},
                         device="cuda")
    tmp = tempfile.mkdtemp(prefix="vtp-resume-")
    try:
        mesh = mesh_lib.make_mesh({"fsdp": 1, "tp": 1})
        optimizer = train.make_optimizer()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params, state, placements = train.init_sharded(
            torch.Generator(device="cuda").manual_seed(5), cfg, mesh,
            optimizer)
        torch.cuda.synchronize()
        init_gb = (torch.cuda.memory_allocated() - base) / 1e9
        if not all(isinstance(x, DTensor) for x in
                   [x for _, x in leaf_items(params)] +
                   [x for k in ("mu", "nu") for _, x in leaf_items(state[k])]):
            raise AssertionError("the sharded state is not all DTensors")
        log(f"[sharded] placements of wq, wo, embed on {mesh.mesh_dim_names}"
            f": {placements['blocks'][0]['wq']}, "
            f"{placements['blocks'][0]['wo']}, {placements['embed']}; "
            f"memory after init {init_gb:.3f} GB")
        batch = train.synthetic_batch(
            torch.Generator(device="cuda").manual_seed(6), cfg, TRAIN_BATCH,
            t, mesh)
        step = train.make_train_step(cfg, optimizer, mesh)
        leaves = state_leaves(train, params, state)
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        free = shutil.disk_usage(tmp).free
        axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"[sharded] flagship d2048-L8 bf16 on mesh {axes} over "
            f"{dist.get_backend()}, world {dist.get_world_size()}: state "
            f"{nbytes / 1e9:.3f} GB in {len(leaves)} tensors; "
            f"{free / 1e9:.1f} GB free under {tmp}")
        if free < 1.05 * nbytes:
            raise RuntimeError(
                f"not enough disk for the checkpoint: {free / 1e9:.1f} GB "
                f"free under {tmp}, the state is {nbytes / 1e9:.3f} GB")

        def run(steps, per_step, losses, step_ms):
            nonlocal params, state
            for _ in range(steps):
                before = launch_counts(fa)
                t1 = time.monotonic()
                params, state, metrics = step(params, state, batch)
                losses.append(metrics["loss"].item())
                torch.cuda.synchronize()
                step_ms.append((time.monotonic() - t1) * 1e3)
                after = launch_counts(fa)
                per_step.append({k: after[k] - before[k] for k in after})

        per_step, losses, step_ms = [], [], []
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa)
        run(SAVE_STEP, per_step, losses, step_ms)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        torch.cuda.synchronize()
        t1 = time.monotonic()
        checkpoint.save(tmp, SAVE_STEP, params, state)
        save_s = time.monotonic() - t1
        # the same state to host memory alone: the device-to-host share
        # of the save
        t1 = time.monotonic()
        saved = [x.detach().to("cpu", copy=True)
                 for x in state_leaves(train, params, state)]
        host_copy_s = time.monotonic() - t1
        saved_count = state["count"]
        run(RESUME_STEPS - SAVE_STEP, per_step, losses, step_ms)
        launches = launch_counts(fa)
        del params, state, leaves
        torch.cuda.empty_cache()

        # a restarted gang: fresh state from another seed, then resume
        params, state, _ = train.init_sharded(
            torch.Generator(device="cuda").manual_seed(55), cfg, mesh,
            optimizer)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        params, state, start = checkpoint.resume_state(
            params, state, environ={"VTP_CHECKPOINT_DIR": tmp,
                                    "VTP_RESUME_STEP": str(SAVE_STEP)})
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t1
        restored_count = state["count"]
        same = [torch.equal(x.detach().cpu(), y) for x, y in
                zip(state_leaves(train, params, state), saved)]
        del saved
        resumed, resumed_ms = [], []
        zero_counts(fa)
        run(RESUME_STEPS - SAVE_STEP, per_step, resumed, resumed_ms)
        launches_resumed = launch_counts(fa)
        reduce_ms = time_reduction(train, mesh, params, batch, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    steady = sorted(step_ms[1:])
    med_ms = steady[len(steady) // 2]
    res = dict(state_gb=nbytes / 1e9, memory_after_init_gb=init_gb,
               peak_gb=peak_gb, save_s=save_s,
               save_gbps=nbytes / save_s / 1e9, host_copy_s=host_copy_s,
               restore_s=restore_s,
               restore_gbps=nbytes / restore_s / 1e9, mesh_step_ms=med_ms,
               plain_step_ms=tr["step_ms"],
               overhead_ms=med_ms - tr["step_ms"], losses=losses,
               resumed_losses=resumed,
               train_losses=tr["losses"][:RESUME_STEPS],
               start_step=start, **reduce_ms,
               launches={k: launches[k] + launches_resumed[k]
                         for k in launches})
    log(f"[sharded] losses {losses}; phase_train's {tr['losses']}; step ms "
        f"{[round(x, 3) for x in step_ms]}; launches per step {per_step}; "
        f"memory after init {init_gb:.3f} GB, peak over steps 1-"
        f"{SAVE_STEP} {peak_gb:.3f} GB (phase_train's peak "
        f"{tr['peak_gb']:.3f} GB)")
    log(f"[sharded] saved step {SAVE_STEP} in {save_s:.3f} s "
        f"({res['save_gbps']:.3f} GB/s; the state to host memory alone "
        f"{host_copy_s:.3f} s), restored in {restore_s:.3f} s "
        f"({res['restore_gbps']:.3f} GB/s), start_step {start}; "
        f"{sum(same)} of {len(same)} tensors bit-identical, count "
        f"{restored_count} (saved {saved_count}); "
        f"resumed losses {resumed} against {losses[SAVE_STEP:]}; step ms "
        f"{[round(x, 3) for x in resumed_ms]}")
    log(f"[sharded] mesh step median {med_ms:.3f} ms against phase_train's "
        f"{tr['step_ms']:.3f} ms: {res['overhead_ms']:+.3f} ms; the "
        f"gradient reduction alone {reduce_ms['reduce_ms']:.3f} ms in "
        f"256 MB buckets, {reduce_ms['reduce_per_leaf_ms']:.3f} ms with "
        "one collective a leaf")
    want = {k: cfg.n_layers for k in launches}
    if losses != tr["losses"][:RESUME_STEPS]:
        raise AssertionError("the sharded step's losses differ from "
                             "phase_train's")
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want}")
    if start != SAVE_STEP or not all(same) or restored_count != saved_count:
        raise AssertionError("the restored state is not the saved one")
    if resumed != losses[SAVE_STEP:]:
        raise AssertionError("the resumed losses differ from the "
                             "uninterrupted run's")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    del params, state, batch
    torch.cuda.empty_cache()
    return res


# one rank of phase_sp: the flagship bf16 L8 at batch TRAIN_BATCH x 2048
# from phase_train's seeds, with the sequence over sp; the launch counts
# set to 0 just before the steps and read just after; every rank prints
# one JSON line
RANK_SP = r"""
import importlib, json, sys, time
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
fa = importlib.import_module("volcano_tpu_torch.workloads.ops.flash_attention")
flags, batch, seq, steps = (json.loads(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), int(sys.argv[4]))
bootstrap.initialize(device="cuda")
mesh = mesh_lib.make_mesh({"sp": dist.get_world_size()}, "cuda")
cfg = tm.flagship_config(**flags)
gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
opt = tt.make_optimizer()
params, state, _ = tt.init_sharded(gen(5), cfg, mesh, opt)
data = tt.synthetic_batch(gen(6), cfg, batch, seq, mesh)
step = tt.make_train_step(cfg, opt, mesh)
fa.flash_fwd.launches = 0
fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
losses, norms, ms = [], [], []
for _ in range(steps):
    t0 = time.monotonic()
    params, state, m = step(params, state, data)
    losses.append(m["loss"].item()); norms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    ms.append((time.monotonic() - t0) * 1e3)
print(json.dumps({"rank": dist.get_rank(), "tokens": list(data["tokens"].shape),
                  "losses": losses, "norms": norms, "step_ms": ms,
                  "launches": [fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
                               fa.flash_bwd.launches_dkv]}))
dist.destroy_process_group()
"""


def run_sp_ranks(flags, n):
    """RANK_SP on n ranks, one a GPU (LOCAL_RANK), over nccl: each
    rank's JSON line."""
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORKER_DEVICE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                         "CUDA_VISIBLE_DEVICES")}
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, base.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SP, json.dumps(flags), str(TRAIN_BATCH),
         str(SLICE_SHAPE[1]), str(SP_STEPS)],
        env=dict(base, TPU_WORKER_ID=str(r), NUM_PROCESSES=str(n),
                 LOCAL_RANK=str(r), COORDINATOR_ADDRESS=f"127.0.0.1:{port}"),
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"sp rank exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def phase_sp(model, train, tr):
    """With 2 or more GPUs, the flagship d2048-L8 bf16 at batch 8 x 2048
    trained for SP_STEPS steps with its sequence over sp 2 on nccl, from
    phase_train's weights and batch: Ulysses (each rank's flash kernels
    at [8, 2048, 8, 128], n_layers launches of each a step) against
    phase_train's one-card flash step, and the ring (no kernel) against
    the one-card eager step, losses and grad norms within RTOL_SP_BF16.
    On one GPU it says that it did not run, and why."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[sp] not run: phase_sp needs 2 GPUs and this machine has {n}; "
            "tests/test_torch_gpu.py holds sp on 4")
        return None
    t = SLICE_SHAPE[1]
    cfg = model.flagship_config(use_flash_attention=False)
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    optimizer = train.make_optimizer()
    state = optimizer.init(params)
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(6), cfg, TRAIN_BATCH, t)
    step = train.make_train_step(cfg, optimizer)
    eager = {"losses": [], "norms": []}
    for _ in range(SP_STEPS):
        params, state, m = step(params, state, batch)
        eager["losses"].append(m["loss"].item())
        eager["norms"].append(m["grad_norm"].item())
    del params, state, batch
    torch.cuda.empty_cache()
    flash = {"losses": tr["losses"][:SP_STEPS],
             "norms": tr["norms"][:SP_STEPS]}
    res = {}
    for name, flags, ref, want in (
            ("ulysses", {"use_ulysses_attention": True}, flash,
             cfg.n_layers * SP_STEPS),
            ("ring", {"use_ring_attention": True}, eager, 0)):
        ranks = run_sp_ranks(flags, 2)
        gaps = {k: max(abs(a - b) / abs(b) for a, b in
                       zip(ranks[0][k], ref[k])) for k in ("losses", "norms")}
        log(f"[sp] {name} over sp 2, flagship d2048-L8 bf16 at batch "
            f"{TRAIN_BATCH} x {t}: ranks {json.dumps(ranks)}; one card "
            f"{json.dumps(ref)}; largest relative gap {gaps} (tolerance "
            f"{RTOL_SP_BF16})")
        if any(r["launches"] != [want] * 3 for r in ranks):
            raise AssertionError(f"{name}: launches {[r['launches'] for r in ranks]}"
                                 f", want {want} of each kernel")
        if any(r[k] != ranks[0][k] for r in ranks for k in ("losses", "norms")):
            raise AssertionError(f"{name}: the ranks' losses differ")
        if any(gaps[k] > RTOL_SP_BF16[k] for k in gaps):
            raise AssertionError(f"{name} over sp differs from one card")
        res[name] = dict(gaps=gaps, step_ms=ranks[0]["step_ms"],
                         launches=ranks[0]["launches"])
    return res


def moe_model_flops(cfg, params, b, t):
    """Model FLOP of one MoE training step, phase_train's accounting
    (`model_flops`) with the experts counted by the slots they process:
    each MoE layer runs its SwiGLU products (3 d x ff MACs a row, times 6
    for the forward and backward) on b x E x C rows (C the capacity; t
    under dense dispatch), not on tokens x E by their parameters, which
    at capacity 1.5, top-2 and 4 experts would count 4/3 of the work."""
    expert = {"moe_gate", "moe_up", "moe_down"}
    total = sum(x.numel() for _, x in leaf_items(params))
    experts = sum(x.numel() for name, x in leaf_items(params)
                  if name.split(".")[-1] in expert)
    matmul_params = total - experts - cfg.vocab_size * cfg.d_model
    moe_layers = sum(1 for blk in params["blocks"] if "router" in blk)
    k = min(cfg.expert_top_k, cfg.n_experts)
    slots = t if cfg.moe_capacity_factor <= 0 else max(1, math.ceil(
        cfg.moe_capacity_factor * t * k / cfg.n_experts))
    expert_flops = moe_layers * 6.0 * 3 * cfg.d_model * cfg.d_ff * b * \
        cfg.n_experts * slots
    attn_fwd = cfg.n_layers * 4.0 * b * cfg.n_heads * t * t * \
        cfg.head_dim / 2
    return 6.0 * matmul_params * b * t + expert_flops + 3.0 * attn_fwd, total


def train_steps(step, params, state, batch, fa, n):
    """n steps of `step`: (params, state, losses, norms, step ms, launches
    a step)."""
    losses, norms, step_ms, per_step = [], [], [], []
    for _ in range(n):
        before = launch_counts(fa)
        t1 = time.monotonic()
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t1) * 1e3)
        after = launch_counts(fa)
        per_step.append({k: after[k] - before[k] for k in after})
    return params, state, losses, norms, step_ms, per_step


def moe_parity(model, train, moe):
    """One f32 MoE step's loss and gradients (flagship widths, 2 layers,
    layer 1 routed, capacity 1.5, batch MOE_PARITY_BATCH) on the card
    against the CPU from the same weights and tokens: each gradient leaf
    within MOE_PARITY_SHARE of its largest, and every token routed to the
    same experts."""
    full_f32()
    cfg = model.flagship_moe_config(n_layers=2, dtype=torch.float32)
    b, t = MOE_PARITY_BATCH
    params = model.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    batch = train.synthetic_batch(torch.Generator().manual_seed(10), cfg, b, t)
    routes = {}
    orig = moe.top_k

    def recording(probs, k):
        vals, idx = orig(probs, k)
        routes.setdefault(probs.device.type, []).append(idx.cpu())
        return vals, idx

    moe.top_k = recording
    try:
        loss_c, g_cpu = train.value_and_grad(params, batch, cfg)
        on_card = train.tree_map(lambda x: x.to("cuda"), params)
        loss_g, g_card = train.value_and_grad(
            on_card, {"tokens": batch["tokens"].to("cuda")}, cfg)
    finally:
        moe.top_k = orig
    g_card = train.tree_map(lambda x: x.cpu(), g_card)
    share, leaf = worst_leaf_share(g_card, g_cpu)
    same = len(routes["cpu"]) == len(routes["cuda"]) == 1 and \
        torch.equal(routes["cpu"][0], routes["cuda"][0])
    moved = int((routes["cpu"][0] != routes["cuda"][0]).any(-1).sum())
    log(f"[moe parity] flagship widths, 2 layers (layer 1 MoE) f32, tokens "
        f"[{b}, {t}], capacity {cfg.moe_capacity_factor}: loss card "
        f"{loss_g.item():.6f} cpu {loss_c.item():.6f}; max|dgrad| / "
        f"max|grad| {share:.3e} at {leaf} (tolerance {MOE_PARITY_SHARE}); "
        f"routes identical {same} ({moved} tokens differ)")
    if not same or share > MOE_PARITY_SHARE or \
            abs(loss_g.item() - loss_c.item()) > ATOL_PARITY:
        raise AssertionError("the MoE step on the card differs from the CPU")
    del params, on_card, g_card, g_cpu
    torch.cuda.empty_cache()
    return dict(grad_share=share, loss_card=loss_g.item(),
                loss_cpu=loss_c.item())


def phase_moe(model, train, moe, fa, flop_peak):
    """The MoE flagship (`flagship_moe_config`: d2048-L8, 4 experts in
    layers 1, 3, 5, 7, top-2, capacity 1.5, bf16, flash, remat off) at
    batch 8 x 2048: TRAIN_STEPS steps through make_train_step with every
    kernel's launches counted (n_layers of each a step: the MoE blocks
    keep their attention), step ms, tokens/s and MFU by
    `moe_model_flops`, memory after init and at peak; a no-grad
    forward's ms; MOE_DENSE_STEPS more steps with dense dispatch; and
    the f32 card-against-CPU check (`moe_parity`)."""
    t = SLICE_SHAPE[1]
    cfg = model.flagship_moe_config()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    optimizer = train.make_optimizer()
    state = optimizer.init(params)
    torch.cuda.synchronize()
    init_gb = (torch.cuda.memory_allocated() - base) / 1e9
    batch = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(6), cfg, TRAIN_BATCH, t)
    step = train.make_train_step(cfg, optimizer)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    params, state, losses, norms, step_ms, per_step = train_steps(
        step, params, state, batch, fa, TRAIN_STEPS)
    launches = launch_counts(fa)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    steady = sorted(step_ms[1:])
    med_ms = steady[len(steady) // 2]
    flops, n_params = moe_model_flops(cfg, params, TRAIN_BATCH, t)
    tflops = flops / med_ms / 1e9
    log(f"[moe] flagship MoE d2048-L8 bf16 (4 experts in the odd layers, "
        f"top-2, capacity 1.5), batch {TRAIN_BATCH} x {t}: losses {losses}; "
        f"grad norms {norms}; step ms {[round(x, 3) for x in step_ms]}; "
        f"launches per step {per_step}; memory after init {init_gb:.3f} GB, "
        f"peak {peak_gb:.3f} GB")
    log(f"[moe] median steady step {med_ms:.3f} ms, tokens/s "
        f"{TRAIN_BATCH * t / med_ms * 1e3:.1f}, model {flops:.4e} FLOP a "
        f"step (experts by slots, {n_params / 1e6:.1f} M params) = "
        f"{tflops:.1f} TFLOP/s, mfu_bf16_dense {tflops * 1e12 / flop_peak:.4f}")
    want = {k: cfg.n_layers for k in launches}
    if any(c != want for c in per_step):
        raise AssertionError(f"MoE launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("non-finite MoE loss or grad norm")

    with torch.inference_mode():
        fwd_ms = []
        for _ in range(4):
            t1 = time.monotonic()
            logits = model.forward(params, batch["tokens"], cfg)
            torch.cuda.synchronize()
            fwd_ms.append((time.monotonic() - t1) * 1e3)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("non-finite MoE serving logits")
        del logits
    forward_ms = sorted(fwd_ms[1:])[1]
    profile = profile_step(train, cfg, optimizer, params, state, batch)

    dense_cfg = model.flagship_moe_config(moe_capacity_factor=0.0)
    dense_step = train.make_train_step(dense_cfg, optimizer)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    params, state, d_losses, d_norms, d_ms, d_per_step = train_steps(
        dense_step, params, state, batch, fa, MOE_DENSE_STEPS)
    d_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    d_flops, _ = moe_model_flops(dense_cfg, params, TRAIN_BATCH, t)
    log(f"[moe] no-grad forward ms {[round(x, 3) for x in fwd_ms]}; dense "
        f"dispatch, {MOE_DENSE_STEPS} more steps: losses {d_losses}, grad "
        f"norms {d_norms}, step ms {[round(x, 3) for x in d_ms]} "
        f"({d_flops / d_ms[-1] / 1e9:.1f} TFLOP/s by slots), launches per "
        f"step {d_per_step}, peak {d_peak_gb:.3f} GB")
    if any(c != want for c in d_per_step) or \
            not all(math.isfinite(x) for x in d_losses + d_norms):
        raise AssertionError("the dense-dispatch MoE steps are off")
    del params, state, batch
    torch.cuda.empty_cache()
    parity = moe_parity(model, train, moe)
    return dict(launches=launches, steps=TRAIN_STEPS, step_ms=med_ms,
                losses=losses, norms=norms,
                tokens_per_s=TRAIN_BATCH * t / med_ms * 1e3,
                model_tflops=tflops,
                mfu_bf16_dense=tflops * 1e12 / flop_peak,
                params_m=n_params / 1e6, memory_after_init_gb=init_gb,
                peak_gb=peak_gb, forward_ms=forward_ms,
                dense_losses=d_losses, dense_norms=d_norms,
                dense_step_ms=d_ms, dense_peak_gb=d_peak_gb, parity=parity,
                profile=profile)


def profile_pp_step(step, params, state, batch):
    """One more pipelined step under torch.profiler: device time by
    kernel group (the optimizer's among the elementwise kernels) and the
    device's idle share of the step's host wall time."""
    wall, by_name = profile_kernels(lambda: step(params, state, batch))
    if not by_name:
        log("[pp profile] the profiler saw no device kernels: not measured")
        return None
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "elementwise": 0.0}
    for name, (ms, _) in by_name.items():
        groups[kernel_group(name)] += ms
    busy = sum(groups.values())
    log(f"[pp profile] one step: host wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                    for k, v in groups.items()))
    log_top("pp profile", by_name)
    return dict(groups, wall_ms=wall, busy_ms=busy)


def phase_pp(model, train, pipeline, fa, bootstrap, tr):
    """phase_train's model, weights and batch through
    `pipeline.make_pipelined_train_step` on a one-rank nccl group at
    pp 1 with PP_MICROBATCHES microbatches: TRAIN_STEPS steps, losses and
    norms against phase_train's within RTOL_PP_BF16, PP_MICROBATCHES x
    n_layers launches of each kernel a step, step ms against
    phase_train's, memory after init and at peak."""
    import torch.distributed as dist
    t = SLICE_SHAPE[1]
    cfg = model.flagship_config()
    bootstrap.initialize({"TPU_WORKER_ID": "0", "NUM_PROCESSES": "1"},
                         device="cuda")
    try:
        mesh = pipeline.make_pp_mesh(1, device_type="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params = model.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
        outer, stages = pipeline.distribute_stages(
            *pipeline.stack_stage_params(params, 1), mesh)
        del params
        optimizer = train.make_optimizer()
        state = optimizer.init(pipeline.joined(outer, stages))
        torch.cuda.synchronize()
        init_gb = (torch.cuda.memory_allocated() - base) / 1e9
        batch = train.synthetic_batch(
            torch.Generator(device="cuda").manual_seed(6), cfg, TRAIN_BATCH, t)
        pp_step = pipeline.make_pipelined_train_step(cfg, mesh, optimizer,
                                                     PP_MICROBATCHES)

        def step(params, state, batch):
            o, s, state, m = pp_step(params[0], params[1], state, batch)
            return (o, s), state, m

        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa)
        _, _, losses, norms, step_ms, per_step = train_steps(
            step, (outer, stages), state, batch, fa, TRAIN_STEPS)
        launches = launch_counts(fa)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        profile = profile_pp_step(step, (outer, stages), state, batch)
    finally:
        dist.destroy_process_group()
    steady = sorted(step_ms[1:])
    med_ms = steady[len(steady) // 2]
    gaps = {k: max(abs(a - b) / abs(b) for a, b in zip(got, tr[k]))
            for k, got in (("losses", losses), ("norms", norms))}
    log(f"[pp] flagship d2048-L8 bf16 through the pipelined step at pp 1, "
        f"{PP_MICROBATCHES} microbatches of {TRAIN_BATCH // PP_MICROBATCHES}"
        f" x {t}: losses {losses}; grad norms {norms}; phase_train's "
        f"{tr['losses']}, {tr['norms']}; largest relative gap {gaps} "
        f"(tolerance {RTOL_PP_BF16}); step ms {[round(x, 3) for x in step_ms]}"
        f" (median {med_ms:.3f} against phase_train's {tr['step_ms']:.3f}); "
        f"launches per step {per_step}; memory after init {init_gb:.3f} GB, "
        f"peak {peak_gb:.3f} GB")
    want = {k: PP_MICROBATCHES * cfg.n_layers for k in launches}
    if any(c != want for c in per_step):
        raise AssertionError(f"pp launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses + norms) or \
            any(gaps[k] > RTOL_PP_BF16[k] for k in gaps):
        raise AssertionError("the pipelined step differs from phase_train's")
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=TRAIN_STEPS, step_ms=med_ms,
                plain_step_ms=tr["step_ms"], losses=losses, norms=norms,
                gaps=gaps, memory_after_init_gb=init_gb, peak_gb=peak_gb,
                profile=profile)


# -- phase_schedule: the control plane's scheduling path ---------------

# the cluster phase_schedule schedules: 32 InfiniBand fabrics of 32
# HGX H100 hosts (a DGX H100 SuperPOD scalable unit each), 8192 GPUs,
# beside this machine's own node
SCHED_HOSTS = 1024
SCHED_FABRIC_HOSTS = 32
SCHED_JOBS = 128
SCHED_MAX_CYCLES = 64
# the backlog's mix, one job of each in turn: (pods, GPUs a pod)
SCHED_MIX = ((1, 1), (1, 1), (1, 8), (4, 8), (4, 8), (16, 8), (32, 8),
             (32, 8))
# keeps the backlog off this machine's node; the end-to-end job
# tolerates it
LOCAL_TAINT = "volcano-tpu.io/smoke-local"
HOSTNAME_LABEL = "kubernetes.io/hostname"


def local_node():
    """This machine as a node of the port's control plane: the GPUs
    torch sees, GPU Feature Discovery's product label, and a
    single-host NVLink domain of its own."""
    from volcano_tpu_torch.api.goodput import GENERATION_LABEL, generation_of
    from volcano_tpu_torch.api.node_info import Node
    from volcano_tpu_torch.api.pod import Taint
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import (GPU_CLIQUE_LABEL,
                                             GPU_DOMAIN_SHAPE_LABEL,
                                             GPU_HOST_INDEX_LABEL,
                                             GPU_PRODUCT_LABEL)
    name = socket.gethostname()
    n_gpus = torch.cuda.device_count()
    labels = {
        GPU_PRODUCT_LABEL:
            torch.cuda.get_device_properties(0).name.replace(" ", "-"),
        GPU_CLIQUE_LABEL: name, GPU_DOMAIN_SHAPE_LABEL: f"1x{n_gpus}",
        GPU_HOST_INDEX_LABEL: "0", HOSTNAME_LABEL: name}
    labels[GENERATION_LABEL] = generation_of(labels)
    return Node(name=name, labels=labels,
                allocatable={"cpu": os.cpu_count() or 1, "memory": "64Gi",
                             GPU: n_gpus, "pods": 110},
                taints=[Taint(key=LOCAL_TAINT, value="true")])


def agent_verdict(cluster, node):
    """Three syncs of the port's node agent with the GPU chip collector
    (the driver's /dev/nvidia<N> nodes) and the GPU health handler
    alone: the verdict must be Healthy and the node uncordoned."""
    from volcano_tpu_torch.agent.agent import (AGENT_CORDONED_ANNOTATION,
                                               GPU_CHIPS_ANNOTATION,
                                               GPU_HEALTHY_LABEL, NodeAgent)
    from volcano_tpu_torch.agent.collect import (CompositeUsageProvider,
                                                 GpuChipCollector)
    from volcano_tpu_torch.agent.handlers import GpuHealthHandler
    collector = GpuChipCollector()
    agent = NodeAgent(cluster, node.name,
                      provider=CompositeUsageProvider([collector]),
                      handlers=[GpuHealthHandler])
    for _ in range(GpuHealthHandler.FAIL_SYNCS):
        agent.sync()
    seen = collector.collect(node.name)
    node = cluster.nodes[node.name]
    report = cluster.slicehealthreports.get(node.name)
    out = dict(declared=torch.cuda.device_count(),
               detected=seen.get("gpu_chips_detected", 0),
               healthy=seen.get("gpu_chips_healthy", 0),
               verdict=report.verdict if report else None,
               label=node.labels.get(GPU_HEALTHY_LABEL),
               chips=node.annotations.get(GPU_CHIPS_ANNOTATION),
               cordoned=node.unschedulable or
               AGENT_CORDONED_ANNOTATION in node.annotations)
    log(f"[schedule] agent on {node.name}: {out['detected']} GPU device "
        f"node(s) detected, {out['healthy']} healthy, torch sees "
        f"{out['declared']}; verdict {out['verdict']}, label "
        f"{out['label']}, cordoned {out['cordoned']}")
    if out["detected"] < out["declared"] or out["verdict"] != "Healthy" or \
            out["label"] != "true" or out["cordoned"]:
        raise AssertionError(f"the agent's verdict on this node: {out}")
    return out


def backlog_jobs(n=SCHED_JOBS):
    """`n` vcjobs over two queues in SCHED_MIX's turn: single-host
    jobs of 1 and 8 GPUs and gangs of 4, 16 and 32 whole hosts, every
    third gang with a hard topology capped at the IB fabric's tier."""
    from volcano_tpu_torch.api.pod import Container, Pod
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    jobs, gangs = [], 0
    for i in range(n):
        pods, gpus = SCHED_MIX[i % len(SCHED_MIX)]
        hard = False
        if pods > 1:
            hard = gangs % 3 == 0
            gangs += 1
        jobs.append(VCJob(
            name=f"bk{i:03d}", min_available=pods,
            queue=("research", "prod")[i % 2],
            network_topology=NetworkTopologySpec(highest_tier_allowed=2)
            if hard else None,
            tasks=[TaskSpec(name="worker", replicas=pods, template=Pod(
                name="t", containers=[Container(
                    requests={"cpu": 8, "memory": "32Gi", GPU: gpus})]))]))
    return jobs


def cycle_spans(hard_keys, seen):
    """The last scheduling cycle by the flight recorder's spans
    (volcano_tpu_torch/trace.py): ms by action, and the ms of the
    allocate action's job spans of the hard-topology gangs.  `seen`
    holds the trace numbers of earlier cycles."""
    from volcano_tpu_torch import trace
    doc = trace.recent_traces(1)[-1]
    if doc["seq"] in seen:
        raise AssertionError("the flight recorder kept no trace of the "
                             "last cycle")
    seen.add(doc["seq"])
    root = doc["root"]
    actions = {c["name"]: round(c["dur"] * 1e3, 3)
               for c in root.get("children", ()) if c["kind"] == "action"}
    hard = sum(j["dur"] for c in root.get("children", ())
               if c["name"] == "allocate"
               for j in c.get("children", ())
               if j["kind"] == "job" and j["labels"].get("job") in hard_keys)
    return dict(actions_ms=actions, hard_gangs_ms=hard * 1e3)


def schedule_backlog(cluster, mgr, sched, local_name):
    """Controller syncs, scheduling cycles and cluster ticks until a cycle
    binds nothing; the invariants of what is bound."""
    from volcano_tpu_torch.api.queue import Queue
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.api.types import JobPhase
    cluster.add_queue(Queue(name="research", weight=1))
    cluster.add_queue(Queue(name="prod", weight=2))
    jobs = [cluster.add_vcjob(j) for j in backlog_jobs()]
    hard_keys = {j.key for j in jobs if j.network_topology is not None}
    cycles, seen = [], set()
    while len(cycles) < SCHED_MAX_CYCLES:
        before = len(cluster.binds)
        t0 = time.perf_counter()
        mgr.sync_all()
        t1 = time.perf_counter()
        sched.run_once()
        t2 = time.perf_counter()
        cluster.tick()
        bound = len(cluster.binds) - before
        pods = [p for p in cluster.pods.values() if p.node_name]
        gpus = sum(Resource.from_resource_list(c.requests).get(GPU)
                   for p in pods for c in p.containers)
        running = sum(1 for j in jobs
                      if cluster.vcjobs[j.key].phase is JobPhase.RUNNING)
        cycles.append(dict(sync_ms=(t1 - t0) * 1e3, cycle_ms=(t2 - t1) * 1e3,
                           bound=bound, jobs_running=running,
                           gpus_bound=gpus, **cycle_spans(hard_keys, seen)))
        log(f"[schedule] cycle {len(cycles)}: controllers "
            f"{cycles[-1]['sync_ms']:.3f} ms, scheduler "
            f"{cycles[-1]['cycle_ms']:.3f} ms (actions "
            f"{cycles[-1]['actions_ms']}, hard-topology gangs' allocate "
            f"{cycles[-1]['hard_gangs_ms']:.3f} ms), {bound} pod(s) bound, "
            f"{running} job(s) running, {gpus:g} GPUs bound")
        if len(cycles) > 1 and bound == 0:
            break
    else:
        raise AssertionError(f"still binding after {SCHED_MAX_CYCLES} cycles")

    counts = backlog_invariants("[schedule]", jobs, cluster.pods,
                                cluster.nodes, local_name)
    return dict(cycles=cycles, **counts)


def backlog_invariants(tag, jobs, pods, nodes, local_name):
    """What is bound keeps the backlog's invariants: no gang bound in
    part, no hard-topology gang across IB fabrics, no single-host job
    across hosts, no node over its nvidia.com/gpu allocatable, no
    backlog pod on this machine's node, and some hard-topology gang
    placed.  Returns the counts of what is bound."""
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    owned = {}
    for p in pods.values():
        owned.setdefault(p.owner, []).append(p)
    partial, spread, straddle = [], [], []
    for job in jobs:
        bound = [p.node_name for p in owned.get(job.uid, ()) if p.node_name]
        if bound and len(bound) != job.min_available:
            partial.append(job.name)
        if bound and job.network_topology is not None and len({
                nodes[n].labels.get(IB_FABRIC_LABEL) for n in bound}) != 1:
            spread.append(job.name)
        if job.min_available == 1 and len(set(bound)) > 1:
            straddle.append(job.name)
    used = {}
    for p in pods.values():
        if p.node_name:
            used[p.node_name] = used.get(p.node_name, 0.0) + \
                p.resource_requests().get(GPU)
    over = sorted(n for n, g in used.items() if g > Resource.
                  from_resource_list(nodes[n].allocatable).get(GPU) + 1e-9)
    placed = {j.name for j in jobs if any(
        p.node_name for p in owned.get(j.uid, ()))}
    hard = [j.name for j in jobs if j.network_topology is not None]
    backlog = [p for j in jobs for p in owned.get(j.uid, ()) if p.node_name]
    log(f"{tag} {len(placed)} of {len(jobs)} jobs placed, "
        f"{len(set(hard) & placed)} of {len(hard)} hard-topology gangs; "
        f"partially bound gangs {partial}, hard gangs across fabrics "
        f"{spread}, single-host jobs across hosts {straddle}, nodes over "
        f"their GPUs {over}")
    if partial or spread or straddle or over or not set(hard) & placed:
        raise AssertionError("the backlog's placement breaks an invariant")
    if any(p.node_name == local_name for p in backlog):
        raise AssertionError("a backlog pod landed on this machine's node")
    return dict(jobs=len(jobs), jobs_placed=len(placed),
                hard_gangs=len(hard), hard_gangs_placed=len(set(hard) & placed),
                pods_bound=len(backlog),
                gpus_bound=sum(p.resource_requests().get(GPU)
                               for p in backlog))


def e2e_job(node):
    """A one-pod vcjob with the torch and svc job plugins, pinned to this
    machine's node by its hostname label."""
    from volcano_tpu_torch.api.pod import Container, Pod, Toleration
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    return VCJob(
        name="smoke", min_available=1, plugins={"torch": [], "svc": []},
        tasks=[TaskSpec(name="worker", replicas=1, template=Pod(
            name="t", node_selector={HOSTNAME_LABEL: node.name},
            tolerations=[Toleration(key=LOCAL_TAINT, operator="Exists")],
            containers=[Container(requests={"cpu": 4, GPU: 1})]))])


class PodWorker:
    """A bound pod launched as `python -m volcano_tpu_torch.workloads.worker`
    (or as `python <argv>`, with `extra` env) with the env the job plugins
    injected.  Only the coordinator's host (the svc plugin's DNS name,
    rewritten to 127.0.0.1) and CUDA_VISIBLE_DEVICES (as launch_worker
    sets it) are overridden: no WORKER_DEVICE, so it runs on cuda.  Its
    output goes to files, so it runs on while the caller does other
    work."""

    def __init__(self, pod, node, bootstrap,
                 argv=("-m", "volcano_tpu_torch.workloads.worker"), **extra):
        injected = dict(pod.containers[0].env)
        contract = {bootstrap.ENV_WORKER_ID, bootstrap.ENV_HOSTNAMES,
                    bootstrap.ENV_COORDINATOR, bootstrap.ENV_NUM_PROCESSES}
        if pod.node_name != node.name or not contract <= set(injected):
            raise AssertionError(f"the pod is on {pod.node_name!r} with env "
                                 f"{sorted(injected)}")
        self.pod, self.injected, self.bootstrap = pod, injected, bootstrap
        self.host, _, port = \
            injected[bootstrap.ENV_COORDINATOR].rpartition(":")
        env = {k: v for k, v in os.environ.items()
               if k not in contract and k not in (
                   "WORKER_DEVICE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                   bootstrap.ENV_SLICE_ID, bootstrap.ENV_NUM_SLICES)}
        env.update(injected)
        env.update({bootstrap.ENV_COORDINATOR: f"127.0.0.1:{port}",
                    "CUDA_VISIBLE_DEVICES": os.environ.get(
                        "CUDA_VISIBLE_DEVICES", "0").split(",")[0],
                    "PYTHONPATH": os.pathsep.join(
                        p for p in (REPO, os.environ.get("PYTHONPATH"))
                        if p)})
        env.update({k: str(v) for k, v in extra.items()})
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        # when a watcher saw the process exit (wait() may come later)
        self.exited = None
        self.t1 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=REPO, stdout=self.out,
            stderr=self.err, text=True)

    def wait(self):
        """(exit code, stdout, stderr, wall s from launch), once the
        process has exited."""
        try:
            self.proc.wait(timeout=max(
                1.0, WORKER_TIMEOUT_S - (time.monotonic() - self.t1)))
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError("the scheduled worker timed out")
        launch_s = (self.exited or time.monotonic()) - self.t1
        self.out.seek(0)
        self.err.seek(0)
        return self.proc.returncode, self.out.read(), self.err.read(), \
            launch_s

    def result(self, tag):
        """(injected names, wall s from launch to the worker's line, the
        line), once the worker has exited."""
        rc, out, err, launch_s = self.wait()
        out = worker_result(rc, out, err)
        injected = self.injected
        log(f"{tag} pod on {self.pod.node_name} with injected "
            f"{sorted(injected)} (coordinator {self.host} -> 127.0.0.1); "
            f"worker {launch_s:.3f} s to its line: {json.dumps(out)}")
        boot = self.bootstrap
        if (out["process_id"], out["num_processes"], out["device_count"]) \
                != (int(injected[boot.ENV_WORKER_ID]),
                    int(injected[boot.ENV_NUM_PROCESSES]), 1) or \
                out["process_id"] != 0 or out["num_processes"] != 1 or \
                not math.isfinite(out["loss"]):
            raise AssertionError("the scheduled worker's line is off")
        return sorted(injected), launch_s, out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def scheduled_worker(cluster, mgr, sched, node, bootstrap):
    """The end-to-end vcjob synced until Running, then its pod launched
    as the port's worker on cuda."""
    from volcano_tpu_torch.api.types import JobPhase
    t0 = time.monotonic()
    job = cluster.add_vcjob(e2e_job(node))
    syncs = 0
    while cluster.vcjobs[job.key].phase is not JobPhase.RUNNING:
        if syncs == 5:
            raise AssertionError(
                f"the end-to-end job is {cluster.vcjobs[job.key].phase} "
                f"after {syncs} cycles")
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
        syncs += 1
    schedule_s = time.monotonic() - t0
    (pod,) = [p for p in cluster.pods.values() if p.owner == job.uid]
    log(f"[schedule] end-to-end: Running after {syncs} cycle(s), "
        f"{schedule_s:.3f} s")
    injected, launch_s, out = PodWorker(pod, node, bootstrap).result(
        "[schedule] end-to-end:")
    return dict(schedule_s=schedule_s, cycles=syncs, launch_s=launch_s,
                injected=injected, result=out)


def gpu_fleet(node, hosts=SCHED_HOSTS):
    """`hosts` HGX H100 hosts in IB fabrics of SCHED_FABRIC_HOSTS, beside
    this machine's node, with the hypernode tree discovered."""
    from volcano_tpu_torch.simulator import make_gpu_cluster
    return make_gpu_cluster(
        [(f"hgx{i:04d}", "hgx-h100-8") for i in range(hosts)],
        ib_fabrics={f"hgx{i:04d}": f"su{i // SCHED_FABRIC_HOSTS:02d}"
                    for i in range(hosts)},
        extra_nodes=[node])


def phase_schedule(bootstrap):
    """The control plane's scheduling path on this machine: the card's
    node verified by the node agent, a backlog scheduled on a simulated
    SCHED_HOSTS-host GPU cluster beside it, and a vcjob scheduled onto
    the card and launched as the port's worker on cuda."""
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.webhooks.admission import default_admission
    node = local_node()
    t0 = time.monotonic()
    cluster = gpu_fleet(node)
    build_s = time.monotonic() - t0
    agent = agent_verdict(cluster, node)
    cluster.admission = default_admission()
    mgr = ControllerManager(cluster, enabled=["job", "queue"])
    sched = Scheduler(cluster, schedule_period=0)
    backlog = schedule_backlog(cluster, mgr, sched, node.name)
    e2e = scheduled_worker(cluster, mgr, sched, node, bootstrap)
    cycle_ms = [c["cycle_ms"] for c in backlog["cycles"]]
    log(f"[schedule] {SCHED_HOSTS} hosts + this node built in "
        f"{build_s:.3f} s; {len(cycle_ms)} cycles, scheduler ms "
        f"{[round(x, 3) for x in cycle_ms]}, "
        f"{backlog['cycles'][-1]['jobs_running']} jobs running, "
        f"{backlog['cycles'][-1]['gpus_bound']:g} GPUs bound")
    return dict(hosts=SCHED_HOSTS, gpus=SCHED_HOSTS * 8, build_s=build_s,
                agent=agent, backlog=backlog, end_to_end=e2e), \
        (cluster, mgr, sched, node)


# -- phase_wire: the control plane over the wire ------------------------

WIRE_PERIOD_S = 0.2     # the controller and scheduler processes' period
WIRE_POLL_S = 0.2       # kubectl's (and the kubelet's) polling period
WIRE_BOOT_S = 120       # a server boot, seed or WAL replay included
WIRE_TIMEOUT_S = 240    # each wait for the plane to converge
WIRE_GRACE_S = 5.0      # SIGTERM grace before SIGKILL at teardown
# the wire phase's depth: half phase_schedule's fleet and backlog, in
# the same fabrics and mix, which keeps the script near its time budget
WIRE_HOSTS = SCHED_HOSTS // 2
WIRE_JOBS = SCHED_JOBS // 2


class WirePlane:
    """The port's control plane as OS processes on this machine: the
    state server over a durable data dir with a bearer token, and the
    controller and scheduler processes that reach it only over HTTP,
    each with its metrics on a port of its own."""

    def __init__(self, workdir):
        import secrets
        self.workdir = workdir
        self.data_dir = os.path.join(workdir, "state")
        self.token = secrets.token_hex(16)
        self.token_file = os.path.join(workdir, "token")
        with open(self.token_file, "w") as f:
            f.write(self.token)
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.procs, self.logs, self.metrics_port = {}, {}, {}

    def spawn(self, name, *argv):
        self.logs[name] = os.path.join(self.workdir, f"{name}.log")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        with open(self.logs[name], "a") as f:
            self.procs[name] = subprocess.Popen(
                [sys.executable, *argv], stdout=f, stderr=subprocess.STDOUT,
                env=env, cwd=REPO)

    def start_server(self, seed=""):
        argv = ["-m", "volcano_tpu_torch.server", "--port", str(self.port),
                "--data-dir", self.data_dir, "--token-file", self.token_file]
        if seed:
            argv += ["--state", seed]
        self.spawn("server", *argv)
        self.until(self.healthy, WIRE_BOOT_S, "the state server's /healthz")

    def start_client(self, name, *argv):
        self.metrics_port[name] = free_port()
        self.spawn(name, "-m", "volcano_tpu_torch", "--cluster-url", self.url,
                   "--token-file", self.token_file, "--period",
                   str(WIRE_PERIOD_S), "--metrics-port",
                   str(self.metrics_port[name]), *argv)

    def healthy(self):
        import urllib.request
        try:
            with urllib.request.urlopen(self.url + "/healthz", timeout=2):
                return True
        except OSError:
            return False

    def check(self):
        for name, proc in self.procs.items():
            if proc.poll() is not None:
                raise AssertionError(f"{name} exited {proc.returncode}:\n"
                                     f"{self.tail(name)}")

    def until(self, cond, timeout, what):
        deadline = time.monotonic() + timeout
        while True:
            self.check()
            if cond():
                return
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out after {timeout} s waiting "
                                     f"for {what}\n" + "\n".join(
                                         self.tail(n) for n in self.procs))
            time.sleep(WIRE_POLL_S)

    def request(self, method, path, body=None):
        """(HTTP status, JSON body) of one call with the token."""
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.url + path, method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Authorization": f"Bearer {self.token}",
                     "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def metrics(self, name):
        """{series: value} of a process's /metrics; the server's is
        open, the clients' are on their own ports."""
        import urllib.request
        url = self.url + "/metrics" if name == "server" else \
            f"http://127.0.0.1:{self.metrics_port[name]}/metrics"
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                text = r.read().decode()
        except OSError:
            return {}
        out = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                series, _, value = line.rpartition(" ")
                out[series] = float(value)
        return out

    def kill9(self, name):
        proc = self.procs.pop(name)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def tail(self, name):
        with open(self.logs[name], errors="replace") as f:
            return f"---- {name} ----\n{f.read()[-3000:]}"

    def stop(self):
        """Clients before the server, SIGTERM then SIGKILL after the
        grace; every process reaped."""
        for name in reversed(list(self.procs)):
            proc = self.procs.pop(name)
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=WIRE_GRACE_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)


def series(metrics, name, **labels):
    """The sum of a family's series whose labels include `labels`."""
    total = 0.0
    for key, value in metrics.items():
        fam, _, rest = key.partition("{")
        if fam == name and all(f'{k}="{v}"' in rest
                               for k, v in labels.items()):
            total += value
    return total


def wire_read(plane):
    """The server's truth, decoded: (rv, epoch, pods, nodes, vcjobs)."""
    from volcano_tpu_torch.api import codec
    code, snap = plane.request("GET", "/snapshot")
    if code != 200:
        raise AssertionError(f"GET /snapshot: {code} {snap}")
    stores = snap["stores"]

    def decode(kind):
        return {k: codec.decode(v) for k, v in stores.get(kind, {}).items()}
    return (snap["rv"], snap.get("epoch", ""), decode("pod"), decode("node"),
            decode("vcjob"))


def gpus_on(pods, node):
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import TaskStatus
    return sum(p.resource_requests().get(GPU) for p in pods.values()
               if p.node_name == node and p.phase in (
                   TaskStatus.BOUND, TaskStatus.RUNNING))


def wire_backlog(plane, kubectl, node, smi):
    """The backlog submitted through kubectl with admission server-side;
    the scheduler process started once the controllers have created
    every pod; the kubelet's ticks until two scheduler cycles in a row
    bind nothing; the invariants read back from the server."""
    jobs, t0 = [], time.monotonic()
    for job in backlog_jobs(WIRE_JOBS):
        jobs.append(kubectl.add_vcjob(job))
    submit_s = time.monotonic() - t0
    uids, want = {j.uid for j in jobs}, sum(j.total_replicas() for j in jobs)
    plane.until(lambda: sum(1 for p in kubectl.pods.values()
                            if p.owner in uids) == want,
                WIRE_TIMEOUT_S, f"the controllers' {want} pods")
    pods_s = time.monotonic() - t0
    log(f"[wire] {len(jobs)} vcjobs submitted over the wire in "
        f"{submit_s:.3f} s; the controller process created their {want} "
        f"pods {pods_s:.3f} s after the first submit ({smi}; host times)")
    # the audit trail (on from its first read) stamps each bind as the
    # server applies it
    audit0 = plane.request("GET", "/audit")[1]["idx"]
    plane.start_client("scheduler", "--components", "scheduler",
                       "--leader-elect", "--holder", "s1")
    t0 = time.monotonic()
    last, changed_at_cycle, first_bind, last_bind = 0, 0, None, None
    while True:
        plane.check()
        kubectl.tick()                  # the kubelet: Bound -> Running
        cycles = series(plane.metrics("scheduler"),
                        "e2e_scheduling_latency_seconds_count")
        bound = sum(1 for p in kubectl.pods.values()
                    if p.owner in uids and p.node_name)
        now = time.monotonic()
        if bound != last:
            last, changed_at_cycle = bound, cycles
            first_bind = first_bind or now
            last_bind = now
        if bound and cycles >= changed_at_cycle + 2:
            break
        if now - t0 > WIRE_TIMEOUT_S:
            raise AssertionError(f"still binding after {WIRE_TIMEOUT_S} s")
        time.sleep(WIRE_POLL_S)
    sched = plane.metrics("scheduler")
    cycles = series(sched, "e2e_scheduling_latency_seconds_count")
    cycle_s = series(sched, "e2e_scheduling_latency_seconds_sum")
    rv, _, pods, nodes, vcjobs = wire_read(plane)
    counts = backlog_invariants("[wire]", [vcjobs[j.key] for j in jobs],
                                pods, nodes, node.name)
    stamps = bind_stamps(plane, audit0, {k for k, p in pods.items()
                                         if p.owner in uids})
    span = max(stamps) - min(stamps)
    binds_per_s = len(stamps) / span if span > 0 else float("inf")
    log(f"[wire] the scheduler process bound {counts['pods_bound']} pods "
        f"of {counts['jobs_placed']} jobs, {counts['gpus_bound']:g} GPUs: "
        f"kubectl saw the first bind {first_bind - t0:.3f} s and the last "
        f"{last_bind - t0:.3f} s after its start; the server applied "
        f"{len(stamps)} binds in {1e3 * span:.3f} ms (first to last audit "
        f"stamp, {binds_per_s:.1f} binds/s); {cycles:g} cycles, "
        f"{1e3 * cycle_s / max(cycles, 1):.3f} ms mean cycle wall; server "
        f"rv {rv} ({smi}; host times)")
    if len(stamps) != counts["pods_bound"]:
        raise AssertionError(f"{len(stamps)} binds audited for "
                             f"{counts['pods_bound']} bound pods")
    return dict(submit_s=submit_s, pods_created_s=pods_s,
                first_bind_s=first_bind - t0, last_bind_s=last_bind - t0,
                bind_span_ms=1e3 * span, binds_per_s=binds_per_s,
                cycles=cycles,
                mean_cycle_ms=1e3 * cycle_s / max(cycles, 1), **counts)


def bind_stamps(plane, since, keys):
    """The audit stamp of each pod's first write with a node, from the
    audit index `since` on."""
    stamps = {}
    while True:
        doc = plane.request("GET", f"/audit?since={since}")[1]
        if doc["lost"]:
            raise AssertionError("the audit ring dropped records")
        for rec in doc["records"]:
            if rec["kind"] == "pod" and rec.get("node") and \
                    rec["key"] in keys and rec["key"] not in stamps:
                stamps[rec["key"]] = rec["ts"]
        if doc["idx"] == since:
            return list(stamps.values())
        since = doc["idx"]


def wire_end_to_end(plane, kubectl, node, bootstrap, smi):
    """The end-to-end vcjob submitted through kubectl and bound by the
    scheduler process; this script as the kubelet reads the bound pod
    over the wire, posts it Running and launches its worker on cuda,
    which runs on while the guard and the crash are checked."""
    from volcano_tpu_torch.api.types import JobPhase, TaskStatus
    t0 = time.monotonic()
    job = kubectl.add_vcjob(e2e_job(node))

    def bound():
        return [p for p in kubectl.pods.values()
                if p.owner == job.uid and p.node_name]
    plane.until(bound, WIRE_TIMEOUT_S, "the end-to-end pod's bind")
    bound_s = time.monotonic() - t0
    (pod,) = bound()
    pod.phase = TaskStatus.RUNNING      # the kubelet started the container
    kubectl.put_object("pod", pod)
    running_s = time.monotonic() - t0
    worker = PodWorker(pod, node, bootstrap)
    plane.until(lambda: kubectl.vcjobs[job.key].phase is JobPhase.RUNNING,
                WIRE_TIMEOUT_S, "the end-to-end job's Running phase")
    job_running_s = time.monotonic() - t0
    log(f"[wire] end-to-end: submit -> bound {bound_s:.3f} s, -> Running "
        f"posted {running_s:.3f} s, -> the job Running {job_running_s:.3f} "
        f"s ({smi}; host times)")
    return dict(job=job, pod=pod, worker=worker, bound_s=bound_s,
                running_s=running_s, job_running_s=job_running_s)


def wire_guard(plane, kubectl, node, own, smi):
    """The server's GPU guard on this machine's node, filled by the
    end-to-end pod (and a filler pod where the node has more GPUs than
    that pod takes): one more 1-GPU pod's /bind and a stale Running
    1-GPU pod's PUT are refused with 409; the end-to-end pod's own
    booking rewritten is accepted; the node's bound GPUs unchanged."""
    from volcano_tpu_torch.api import codec
    from volcano_tpu_torch.api.pod import Toleration, make_pod
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.api.types import TaskStatus

    def pod(name, gpus, **kw):
        return make_pod(name, requests={"cpu": 1, GPU: gpus},
                        tolerations=[Toleration(key=LOCAL_TAINT,
                                                operator="Exists")], **kw)

    def put(obj, key=None):
        return plane.request("POST", "/objects/pod",
                             {"obj": codec.encode(obj), "key": key})[0]
    _, _, pods, nodes, _ = wire_read(plane)
    cap = Resource.from_resource_list(nodes[node.name].allocatable).get(GPU)
    free = cap - gpus_on(pods, node.name)
    if free > 0:
        if put(pod("smoke-filler", free)) != 200 or plane.request(
                "POST", "/bind", {"namespace": "default",
                                  "name": "smoke-filler",
                                  "node_name": node.name})[0] != 200:
            raise AssertionError("the filler pod's bind was refused")
    before = gpus_on(wire_read(plane)[2], node.name)
    if put(pod("smoke-extra", 1)) != 200:
        raise AssertionError("the extra pod's create was refused")
    bind, body = plane.request("POST", "/bind", {
        "namespace": "default", "name": "smoke-extra",
        "node_name": node.name})
    stale = put(pod("smoke-stale", 1, node_name=node.name,
                    phase=TaskStatus.RUNNING))
    own.phase = TaskStatus.RUNNING
    mine = put(own, own.key)
    after = gpus_on(wire_read(plane)[2], node.name)
    kubectl.delete_pod("default/smoke-extra")
    out = dict(node_gpus=cap, bound_gpus=before, bind_code=bind,
               stale_put_code=stale, own_put_code=mine, gpus_after=after)
    log(f"[wire] GPU guard on {node.name} ({cap:g} GPUs, {before:g} bound): "
        f"/bind of one more 1-GPU pod -> {bind} ({body.get('error')}); PUT "
        f"of a stale Running 1-GPU pod -> {stale}; the bound pod's own "
        f"booking rewritten -> {mine}; {after:g} GPUs bound after ({smi})")
    if (bind, stale, mine) != (409, 409, 200) or after != before or \
            before != cap:
        raise AssertionError(f"the GPU guard: {out}")
    return out


def wal_files(data_dir):
    return sorted((n, os.path.getsize(os.path.join(data_dir, n)))
                  for n in os.listdir(data_dir)
                  if n.startswith("wal-") and n.endswith(".log"))


def wire_crash(plane, kubectl, node, e2e, smi):
    """kill -9 of the server once every bind is acked, a boot on the same
    data dir, and the plane's recovery: every bound pod still bound, the
    resource version monotonic, the lease kept, both client processes
    resynced without a restart (their mirrors' resync counters move and
    a new job goes through them), the end-to-end job still Running."""
    from volcano_tpu_torch.api.pod import Container, Pod, Toleration
    from volcano_tpu_torch.api.queue import Queue
    from volcano_tpu_torch.api.types import JobPhase, TaskStatus
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    rv0, epoch0, pods0, _, _ = wire_read(plane)
    bound0 = {k: p.node_name for k, p in pods0.items() if p.node_name}
    server = plane.metrics("server")
    fsyncs = series(server, "server_wal_fsync_seconds_count")
    fsync_s = series(server, "server_wal_fsync_seconds_sum")
    dur0 = plane.request("GET", "/durability")[1]
    files = wal_files(plane.data_dir)
    resyncs0 = {n: series(plane.metrics(n), "mirror_resync_total")
                for n in ("controllers", "scheduler")}
    t0 = time.monotonic()
    plane.kill9("server")
    plane.start_server()
    rto_s = time.monotonic() - t0
    dur = plane.request("GET", "/durability")[1]
    rv1, epoch1, pods1, _, vcjobs1 = wire_read(plane)
    lost = sorted(k for k, n in bound0.items()
                  if k not in pods1 or pods1[k].node_name != n)
    base0, boot0 = epoch0.rsplit(".", 1)
    base1, boot1 = epoch1.rsplit(".", 1)
    lease = plane.request("GET", "/leases")[1].get("scheduler", {})
    log(f"[wire] kill -9 of the server after {len(bound0)} acked binds "
        f"(rv {rv0}; {fsyncs:g} WAL fsyncs, {1e3 * fsync_s:.3f} ms in "
        f"all, {1e3 * fsync_s / max(fsyncs, 1):.3f} ms each; WAL "
        f"{dur0.get('wal_records')} records, {dur0.get('wal_bytes')} bytes "
        f"in {len(files)} segment(s) {[f for f, _ in files]}): /healthz "
        f"again after {rto_s:.3f} s (the RTO), {dur.get('replay_records')} "
        f"WAL records replayed in {dur.get('replay_seconds')} s; rv {rv1}, "
        f"epoch {epoch0} -> {epoch1}; {len(lost)} bound pod(s) lost; lease "
        f"held by {lease.get('holder')} ({smi}; host times)")
    if lost or rv1 < rv0 or base1 != base0 or int(boot1) != int(boot0) + 1 \
            or lease.get("holder") != "s1":
        raise AssertionError("the restart lost acked state")
    plane.until(lambda: all(series(plane.metrics(n), "mirror_resync_total")
                            > resyncs0[n] for n in resyncs0),
                WIRE_TIMEOUT_S, "the client processes' resync")
    modes = {n: {m: series(plane.metrics(n), "mirror_resync_total", mode=m)
                 for m in ("delta", "full")} for n in resyncs0}
    t1 = time.monotonic()
    # a queue of its own: the default queue's share is the end-to-end
    # job's, which it holds (proportion's overused check)
    kubectl.add_queue(Queue(name="after-restart", weight=1))
    probe = kubectl.add_vcjob(VCJob(
        name="after-restart", min_available=1, queue="after-restart",
        tasks=[TaskSpec(
            name="worker", replicas=1, template=Pod(
                name="t", node_selector={HOSTNAME_LABEL: node.name},
                tolerations=[Toleration(key=LOCAL_TAINT,
                                        operator="Exists")],
                containers=[Container(requests={"cpu": "100m"})]))]))
    plane.until(lambda: any(p.owner == probe.uid and p.node_name
                            for p in kubectl.pods.values()),
                WIRE_TIMEOUT_S, "a job after the restart bound")
    probe_s = time.monotonic() - t1
    _, _, pods2, _, vcjobs2 = wire_read(plane)
    e2e_pod = pods2.get(e2e["pod"].key)
    running = vcjobs2[e2e["job"].key].phase is JobPhase.RUNNING and \
        e2e_pod is not None and e2e_pod.phase is TaskStatus.RUNNING
    log(f"[wire] after the restart: the clients resynced without a restart "
        f"(mirror resyncs by mode {modes}); a new job created and bound "
        f"through them in {probe_s:.3f} s; the end-to-end job "
        f"{vcjobs2[e2e['job'].key].phase.value}, its pod "
        f"{e2e_pod.phase.value if e2e_pod else None}")
    if not running:
        raise AssertionError("the end-to-end job is no longer Running")
    return dict(acked_binds=len(bound0), rv_before=rv0, rv_after=rv1,
                epoch_before=epoch0, epoch_after=epoch1, rto_s=rto_s,
                wal_fsyncs=fsyncs, wal_fsync_s=fsync_s,
                wal_records=dur0.get("wal_records"),
                wal_bytes=dur0.get("wal_bytes"), wal_segments=len(files),
                replay_records=dur.get("replay_records"),
                replay_seconds=dur.get("replay_seconds"),
                resyncs=modes, after_restart_bound_s=probe_s)


def phase_wire(bootstrap, smi):
    """The port's control plane as separate processes that meet only at
    the state server: half phase_schedule's fleet and backlog (WIRE_HOSTS,
    WIRE_JOBS) scheduled over HTTP, a vcjob run on this card, the server's GPU
    guard, and a kill -9 of the server with the plane's recovery."""
    import pickle
    from volcano_tpu_torch.api.queue import Queue
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    node = local_node()
    workdir = tempfile.mkdtemp(prefix="vtp-wire-")
    plane, kubectl, e2e = WirePlane(workdir), None, None
    try:
        t0 = time.monotonic()
        fleet = gpu_fleet(node, WIRE_HOSTS)
        for name, weight in (("research", 1), ("prod", 2)):
            fleet.add_queue(Queue(name=name, weight=weight))
        seed = os.path.join(workdir, "seed.pkl")
        with open(seed, "wb") as f:
            pickle.dump(fleet, f)
        seed_s = time.monotonic() - t0
        t0 = time.monotonic()
        plane.start_server(seed)
        boot_s = time.monotonic() - t0
        kubectl = RemoteCluster(plane.url, token=plane.token)
        if len(kubectl.nodes) != WIRE_HOSTS + 1:
            raise AssertionError(f"the server holds {len(kubectl.nodes)} "
                                 "nodes")
        log(f"[wire] {WIRE_HOSTS} hosts + this node seeded in {seed_s:.3f} "
            f"s; the state server up over {plane.data_dir} in {boot_s:.3f} "
            f"s ({smi}; host times)")
        plane.start_client("controllers", "--components", "controllers",
                           "--controllers", "job,queue")
        backlog = wire_backlog(plane, kubectl, node, smi)
        log(f"[wire] bound over the wire: {backlog['pods_bound']} pods, "
            f"{backlog['jobs_placed']} jobs, {backlog['gpus_bound']:g} GPUs, "
            f"{backlog['hard_gangs_placed']} hard gangs, on {WIRE_HOSTS} "
            f"hosts (half phase_schedule's fleet and backlog)")
        e2e = wire_end_to_end(plane, kubectl, node, bootstrap, smi)
        guard = wire_guard(plane, kubectl, node, e2e["pod"], smi)
        crash = wire_crash(plane, kubectl, node, e2e, smi)
        e2e["injected"], e2e["launch_s"], e2e["result"] = \
            e2e["worker"].result("[wire] end-to-end:")
    finally:
        if e2e is not None:
            e2e["worker"].kill()
        if kubectl is not None:
            kubectl.close()
        plane.stop()
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[wire] end-to-end: launch -> the worker's line "
        f"{e2e['launch_s']:.3f} s, beside the guard and crash checks "
        f"({smi}; host times)")
    for k in ("job", "pod", "worker"):
        e2e.pop(k)
    return dict(processes=["server", "controllers", "scheduler"],
                seed_s=seed_s, boot_s=boot_s, backlog=backlog,
                hosts=WIRE_HOSTS, jobs=WIRE_JOBS, end_to_end=e2e,
                guard=guard, crash=crash)


# -- phase_preempt: preemption and reclaim on the settled fleet ----------

# the default conf with the preempting actions inserted before backfill
PREEMPT_ACTIONS = ["enqueue", "allocate", "elastic", "gangpreempt",
                   "preempt", "reclaim", "backfill"]
PREEMPT_PRIORITY = 1000       # the preemptors' PriorityClass value
SPOT_PRIORITY = 100           # the spot layer's, above the backlog's 0
PREEMPT_GANG_HOSTS = 32       # one IB fabric's hosts
PREEMPT_SINGLES = 16          # 8-GPU single-host jobs, half in each queue
SPOT_FABRICS = 3              # research fabrics whose jobs finish first
SPOT_JOB_HOSTS = 8            # a spot job's pods (8 GPUs each), min 1
PROD_WEIGHT_LAUNCH = 3        # prod's queue weight from the launch on
# what conformance keeps from every eviction (plugins/conformance.py),
# the classes with Kubernetes' own values
CRITICAL_NAMESPACES = ("kube-system",)
CRITICAL_CLASSES = {"system-cluster-critical": 2000000000,
                    "system-node-critical": 2000001000}
# one DGX H100 SuperPOD NVLink domain (32 hosts, 256 GPUs) in an IB
# fabric of its own, tainted for the jobs that ask for it: low-priority
# prod gangs fill it, and a high-priority prod gang held to one NVLink
# domain takes it back through gangpreempt
DGX_DOMAIN, DGX_FABRIC = "dgx256", "su-dgx"
DGX_TAINT = "volcano-tpu.io/smoke-dgx"
DGX_FILLER_HOSTS = 8          # each filler gang's hosts (whole gang, min 8)
PREEMPT_MAX_CYCLES = 8
# the event message each action gives the pod it evicts
EVICT_REASONS = (("gang-preempted for ", "gangpreempt"),
                 ("preempted by ", "preempt"),
                 ("reclaimed by queue ", "reclaim"))


def gpu_job(name, queue, pods, priority_class, topology=None,
            namespace="default", dgx=False):
    """A gang of `pods` whole 8-GPU hosts; `dgx`: it tolerates
    DGX_TAINT (and a filler also selects the domain by its label)."""
    from volcano_tpu_torch.api.pod import Container, Pod, Toleration
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    tolerations = [Toleration(key=DGX_TAINT, operator="Exists")] \
        if dgx else []
    return VCJob(
        name=name, namespace=namespace, min_available=pods, queue=queue,
        priority_class=priority_class, network_topology=topology,
        tasks=[TaskSpec(name="worker", replicas=pods, template=Pod(
            name="t", tolerations=tolerations, containers=[Container(
                requests={"cpu": 8, "memory": "32Gi", GPU: 8})]))])


def preemptor_rounds():
    """The high-priority traffic in two rounds: a prod gang of
    PREEMPT_GANG_HOSTS whole hosts held to one IB fabric (hard topology
    at the fabric's tier), a prod gang of DGX_DOMAIN's hosts held to one
    NVLink domain (the tier below), and half of PREEMPT_SINGLES 8-GPU
    single-host jobs in research; then the other half in prod."""
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.types import NetworkTopologyMode
    singles = {q: [gpu_job(f"hp-{q[0]}{i:02d}", q, 1, "smoke-high")
                   for i in range(PREEMPT_SINGLES // 2)]
               for q in ("research", "prod")}
    return [[gpu_job("hp-gang", "prod", PREEMPT_GANG_HOSTS, "smoke-high",
                     NetworkTopologySpec(NetworkTopologyMode.HARD, 2)),
             gpu_job("hp-nvl", "prod", dgx_hosts(), "smoke-high",
                     NetworkTopologySpec(NetworkTopologyMode.HARD, 1),
                     dgx=True)] +
            singles["research"], singles["prod"]]


def dgx_hosts():
    from volcano_tpu_torch.api.devices.gpu.topology import WELL_KNOWN
    return WELL_KNOWN["dgx-h100-256"].hosts


def add_dgx_domain(cluster):
    """DGX_DOMAIN's hosts joined to the fleet, tainted DGX_TAINT, and the
    hypernode tree rediscovered (a tier-1 domain under DGX_FABRIC)."""
    from volcano_tpu_torch.api.devices.gpu.topology import domain_for
    from volcano_tpu_torch.api.pod import Taint
    from volcano_tpu_torch.controllers.hypernode import HyperNodeController
    from volcano_tpu_torch.simulator import domain_nodes
    for node in domain_nodes(domain_for(DGX_DOMAIN, "dgx-h100-256"),
                             ib_fabric=DGX_FABRIC):
        node.taints = [Taint(key=DGX_TAINT, value="true")]
        cluster.add_node(node)
    ctrl = HyperNodeController()
    ctrl.initialize(cluster)
    ctrl.sync()


def dgx_fillers():
    """Low-priority prod gangs of DGX_FILLER_HOSTS hosts, at their gang
    floor, that fill DGX_DOMAIN (selected by its NVLink clique label)."""
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    jobs = []
    for i in range(dgx_hosts() // DGX_FILLER_HOSTS):
        job = gpu_job(f"dgx-low{i}", "prod", DGX_FILLER_HOSTS, "smoke-low",
                      dgx=True)
        job.tasks[0].template.node_selector = {GPU_CLIQUE_LABEL: DGX_DOMAIN}
        jobs.append(job)
    return jobs


def is_critical(pod):
    """conformance's rule: a pod in a critical namespace or of a
    system-critical PriorityClass is never evicted."""
    return pod.namespace in CRITICAL_NAMESPACES or \
        pod.priority_class in CRITICAL_CLASSES


def spot_jobs(n):
    """The spot layer: research jobs of SPOT_JOB_HOSTS 8-GPU pods that
    run with one (minAvailable 1), so all but one pod of each may be
    taken back; the backlog's jobs run at their gang floor
    (minAvailable = replicas), which preempt and reclaim never break.
    Two of them are critical, and conformance keeps them whole: the
    first runs in kube-system at the spot priority, the second under
    system-node-critical."""
    jobs = []
    for i in range(n):
        job = gpu_job(f"spot{i:02d}", "research", SPOT_JOB_HOSTS,
                      "system-node-critical" if i == 1 else "smoke-low",
                      namespace=CRITICAL_NAMESPACES[0] if i == 0
                      else "default")
        job.min_available = 1
        job.tasks[0].min_available = 1
        jobs.append(job)
    return jobs


def fabric_tenants(cluster):
    """IB fabric -> the uids of the jobs with a pod running in it (this
    machine's node is in no fabric, DGX_FABRIC is left out)."""
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    out = {}
    for pod in cluster.pods.values():
        if pod.node_name and not pod.is_terminated():
            fab = cluster.nodes[pod.node_name].labels.get(IB_FABRIC_LABEL)
            if fab and fab != DGX_FABRIC:
                out.setdefault(fab, set()).add(pod.owner)
    return out


def finish_jobs(cluster, uids):
    """The jobs' pods complete (the kubelet reports them Succeeded)."""
    for pod in list(cluster.pods.values()):
        if pod.owner in uids and pod.node_name and not pod.is_terminated():
            cluster.complete_pod(pod.key)


def queue_gpus(cluster):
    """nvidia.com/gpu held (bound, not finished, not releasing) by queue."""
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import TaskStatus
    by_uid = {j.uid: j.queue for j in cluster.vcjobs.values()}
    out = {}
    for pod in cluster.pods.values():
        if pod.node_name and not pod.is_terminated() and \
                pod.phase is not TaskStatus.RELEASING:
            q = by_uid.get(pod.owner)
            out[q] = out.get(q, 0.0) + pod.resource_requests().get(GPU)
    return out


def preempt_invariants(cluster, evicted, before, fleet_gpus):
    """The cycle's evictions and what is bound after it: no gang below
    its minAvailable, no critical pod evicted, every preempt (and
    gangpreempt) victim of lower priority than its preemptor, every
    reclaim victim from a queue above its deserved share (by weight)
    when the cycle began (gangreclaim's too), hard gangs inside one IB
    fabric (one NVLink domain at tier 1), no node over its GPUs."""
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL, TaskStatus
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    jobs = {j.uid: j for j in cluster.vcjobs.values()}
    prio = {pc.name: pc.value
            for pc in cluster.priority_classes.values()}
    weights = {q.name: q.weight for q in cluster.queues.values()
               if q.name in ("research", "prod")}
    broken = []
    for key, reason, owner in evicted:
        pod_job = jobs.get(owner)
        pod = cluster.pods.get(key)
        if pod is not None and is_critical(pod):
            broken.append(f"critical pod {key} evicted")
        if pod_job is None:
            continue
        vprio = prio.get(pod_job.priority_class, 0)
        if evict_action(cluster, reason, owner) == "gangreclaim":
            q = pod_job.queue
            share = fleet_gpus * weights.get(q, 0) / sum(weights.values())
            if before.get(q, 0.0) <= share:
                broken.append(f"{key} gang-reclaimed from {q} at "
                              f"{before.get(q, 0.0):g} GPUs, deserved "
                              f"{share:g}")
            continue
        for prefix, action in EVICT_REASONS[:2]:
            if reason.startswith(prefix):
                # the preemptor: a task's key (preempt) or a job's
                who = reason[len(prefix):]
                preemptor = cluster.pods.get(who)
                pjob = jobs.get(preemptor.owner) if preemptor else \
                    cluster.vcjobs.get(who)
                pprio = prio.get(pjob.priority_class, 0) if pjob else None
                if pprio is None or vprio >= pprio:
                    broken.append(f"{key} ({vprio}) {action}ed by {who} "
                                  f"({pprio})")
                break
        else:
            if reason.startswith(EVICT_REASONS[2][0]):
                q = pod_job.queue
                share = fleet_gpus * weights.get(q, 0) / sum(weights.values())
                if before.get(q, 0.0) <= share:
                    broken.append(f"{key} reclaimed from {q} at "
                                  f"{before.get(q, 0.0):g} GPUs, deserved "
                                  f"{share:g}")
    bound, used = {}, {}
    for pod in cluster.pods.values():
        if pod.node_name and not pod.is_terminated() and \
                pod.phase is not TaskStatus.RELEASING:
            bound.setdefault(pod.owner, []).append(pod.node_name)
            used[pod.node_name] = used.get(pod.node_name, 0.0) + \
                pod.resource_requests().get(GPU)
    for uid, nodes in bound.items():
        job = jobs.get(uid)
        if job is None:
            continue
        if len(nodes) < job.min_available:
            broken.append(f"{job.key} bound {len(nodes)} < minAvailable "
                          f"{job.min_available}")
        if job.network_topology is not None:
            label = GPU_CLIQUE_LABEL if \
                job.network_topology.highest_tier_allowed == 1 \
                else IB_FABRIC_LABEL
            if len({cluster.nodes[n].labels.get(label)
                    for n in nodes}) != 1:
                broken.append(f"hard gang {job.key} across {label}")
    for name, gpus in used.items():
        cap = Resource.from_resource_list(
            cluster.nodes[name].allocatable).get(GPU)
        if gpus > cap + 1e-9:
            broken.append(f"{name} holds {gpus:g} of {cap:g} GPUs")
    return broken


def evict_action(cluster, message, owner):
    """The action an eviction's message names; gangpreempt and
    gangreclaim share theirs ("gang-preempted for <job>"), and
    gangreclaim's preemptor is of another queue than its victim."""
    action = next((a for pre, a in EVICT_REASONS
                   if message.startswith(pre)), "other")
    if action == "gangpreempt":
        preemptor = cluster.vcjobs.get(message[len(EVICT_REASONS[0][0]):])
        victim = next((j for j in cluster.vcjobs.values()
                       if j.uid == owner), None)
        if preemptor and victim and preemptor.queue != victim.queue:
            return "gangreclaim"
    return action


def preempt_cycle(cluster, mgr, sched, hard_keys, seen, fleet_gpus, tally):
    """One controller sync, scheduling cycle and tick: its evictions by
    action (added to `tally`), its spans, and the invariants read after
    it (raises if one breaks)."""
    from volcano_tpu_torch.api.resource import GPU
    before = queue_gpus(cluster)
    n_events = len(cluster.events)
    t0 = time.perf_counter()
    mgr.sync_all()
    t1 = time.perf_counter()
    sched.run_once()
    t2 = time.perf_counter()
    spans = cycle_spans(hard_keys, seen)
    evicted, by_action = [], {a: 0 for _, a in EVICT_REASONS}
    for key, reason, message in cluster.events[n_events:]:
        if reason != "Evict":
            continue
        pod = cluster.pods.get(key)
        evicted.append((key, message, pod.owner if pod else ""))
        action = evict_action(cluster, message, pod.owner if pod else "")
        by_action[action] = by_action.get(action, 0) + 1
        tally["evictions"][action] = tally["evictions"].get(action, 0) + 1
        if pod is not None:
            tally["gpus"][action] = tally["gpus"].get(action, 0.0) + \
                pod.resource_requests().get(GPU)
    broken = preempt_invariants(cluster, evicted, before, fleet_gpus)
    cluster.tick()
    if broken:
        raise AssertionError(f"an invariant broke: {broken}")
    return dict(sync_ms=(t1 - t0) * 1e3, cycle_ms=(t2 - t1) * 1e3,
                evicted=by_action, queue_gpus_before=before, **spans)


def phase_preempt(plane, smi):
    """phase_schedule's settled fleet (1024 hosts, its backlog bound and
    pending) under the default conf with gangpreempt, preempt and
    reclaim before backfill.  The backlog moves on: the jobs of
    SPOT_FABRICS research-only fabrics finish, and a spot layer of
    research jobs that run with one pod of their eight (the only work
    preempt and reclaim may take from: the backlog runs at its gang
    floor) fills them; two of its jobs are critical (kube-system, and
    system-node-critical).  DGX_DOMAIN joins the fleet, filled by
    low-priority prod gangs.  Round 1, under a PriorityClass above the
    backlog's and the spot layer's: a prod gang of 32 whole hosts held
    to one IB fabric, as the one job of a prod-only fabric finishes, a
    prod gang of DGX_DOMAIN's 32 hosts held to one NVLink domain, and 8
    8-GPU single-host jobs in research.  Round 2, once those are bound:
    prod's weight rises to PROD_WEIGHT_LAUNCH, and 8 such jobs arrive in
    prod.  Cycled until every preemptor is bound, with the invariants
    read after each cycle; the critical pods must all still be bound."""
    from volcano_tpu_torch.api.resource import GPU, Resource
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL, TaskStatus
    from volcano_tpu_torch.cache.cluster import PriorityClass
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    cluster, mgr, sched, node = plane
    sched.conf.actions = list(PREEMPT_ACTIONS)
    cluster.add_priority_class(PriorityClass("smoke-high", PREEMPT_PRIORITY))
    cluster.add_priority_class(PriorityClass("smoke-low", SPOT_PRIORITY))
    for name, value in CRITICAL_CLASSES.items():
        cluster.add_priority_class(PriorityClass(name, value))
    jobs = {j.uid: j for j in cluster.vcjobs.values()}
    tenants = fabric_tenants(cluster)
    research_only = sorted(f for f, uids in tenants.items() if all(
        jobs[u].queue == "research" for u in uids))[:SPOT_FABRICS]
    if len(research_only) < SPOT_FABRICS:
        raise AssertionError(f"research-only fabrics {research_only}")
    finish_jobs(cluster, set().union(*(tenants[f] for f in research_only)))
    spot = [cluster.add_vcjob(j) for j in spot_jobs(
        SPOT_FABRICS * SCHED_FABRIC_HOSTS // SPOT_JOB_HOSTS)]
    add_dgx_domain(cluster)
    fillers = [cluster.add_vcjob(j) for j in dgx_fillers()]
    fleet_gpus = sum(Resource.from_resource_list(n.allocatable).get(GPU)
                     for n in cluster.nodes.values() if n.name != node.name)
    hard_keys = {j.key for j in cluster.vcjobs.values()
                 if j.network_topology is not None}
    seen = set()
    tally = dict(evictions={a: 0 for _, a in EVICT_REASONS},
                 gpus={a: 0.0 for _, a in EVICT_REASONS})
    setup = preempt_cycle(cluster, mgr, sched, hard_keys, seen, fleet_gpus,
                          tally)

    def bound_pods(batch):
        uids = {j.uid for j in batch}
        return [p for p in cluster.pods.values()
                if p.owner in uids and p.node_name and
                p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING)]
    spot_keys = {p.key for p in bound_pods(spot)}
    spot_pods = len(spot_keys)
    critical = sorted(p.key for p in bound_pods(spot) if is_critical(p))
    filler_nodes = {p.node_name for p in bound_pods(fillers)}
    if len(filler_nodes) != dgx_hosts() or len(critical) != \
            2 * SPOT_JOB_HOSTS:
        raise AssertionError(f"the fillers hold {len(filler_nodes)} hosts, "
                             f"{len(critical)} critical pods bound")
    log(f"[preempt] the jobs of research-only fabrics {research_only} "
        f"finished; the spot layer bound {spot_pods} pods ({len(critical)} "
        f"critical) and {len(fillers)} low-priority prod gangs all "
        f"{len(filler_nodes)} hosts of {DGX_DOMAIN} in one cycle "
        f"({setup['cycle_ms']:.3f} ms, evictions {setup['evicted']}); "
        f"GPUs by queue {queue_gpus(cluster)}, fleet {fleet_gpus:g}")

    tenants = fabric_tenants(cluster)
    prod_fabric = next(f for f, uids in sorted(tenants.items())
                       if len(uids) == 1 and jobs.get(next(iter(uids)))
                       and jobs[next(iter(uids))].queue == "prod")
    finish_jobs(cluster, tenants[prod_fabric])
    bound_s, cycles, pre = {}, [], []
    for rnd, arrivals in enumerate(preemptor_rounds(), 1):
        if rnd == 2:
            cluster.queues["prod"].weight = PROD_WEIGHT_LAUNCH
        t_submit = time.monotonic()
        batch = [cluster.add_vcjob(j) for j in arrivals]
        pre += batch
        hard_keys |= {j.key for j in batch if j.network_topology is not None}
        while not all(j.key in bound_s for j in batch):
            if len(cycles) == PREEMPT_MAX_CYCLES:
                raise AssertionError(
                    f"preemptors still pending after {len(cycles)} cycles: "
                    f"{sorted(j.key for j in pre if j.key not in bound_s)}")
            cycles.append(preempt_cycle(cluster, mgr, sched, hard_keys, seen,
                                        fleet_gpus, tally))
            for job in batch:
                if job.key not in bound_s and \
                        len(bound_pods([job])) >= job.min_available:
                    bound_s[job.key] = time.monotonic() - t_submit
            c = cycles[-1]
            log(f"[preempt] round {rnd}, cycle {len(cycles)}: controllers "
                f"{c['sync_ms']:.3f} ms, scheduler {c['cycle_ms']:.3f} ms "
                f"(actions {c['actions_ms']}), evictions {c['evicted']}, "
                f"{len(bound_s)} of {len(pre)} preemptors bound; GPUs by "
                f"queue before {c['queue_gpus_before']}; invariants hold")

    def labels_of(key, label):
        job = cluster.vcjobs[key]
        return sorted({cluster.nodes[p.node_name].labels.get(label)
                       for p in bound_pods([job])})
    fabrics = labels_of("default/hp-gang", IB_FABRIC_LABEL)
    domains = labels_of("default/hp-nvl", GPU_CLIQUE_LABEL)
    if len(fabrics) != 1 or domains != [DGX_DOMAIN] or any(
            p.node_name == node.name for p in bound_pods(pre)):
        raise AssertionError(f"the gang spans {fabrics}, the NVLink gang "
                             f"{domains}, or a preemptor landed on this "
                             "machine's node")
    if not tally["evictions"]["gangpreempt"]:
        raise AssertionError("the NVLink gang bound without gangpreempt")
    # conformance's work: the critical pods stayed while spot pods of
    # their queue, fabrics and (kube-system's) priority were taken
    kept = {p.key for p in bound_pods(spot) if is_critical(p)}
    if kept != set(critical):
        raise AssertionError(f"critical pods lost: "
                             f"{sorted(set(critical) - kept)}")
    spot_taken = sum(1 for key, reason, _ in cluster.events
                     if reason == "Evict" and key in spot_keys)
    log(f"[preempt] evictions by action {tally['evictions']}, GPUs taken "
        f"back {tally['gpus']}; submit to bound s (from its round's "
        f"arrival) {json.dumps({k.split('/')[1]: round(v, 3) for k, v in bound_s.items()})}; "
        f"the gang in {fabrics[0]} ({prod_fabric}'s one job finished as it "
        f"arrived), the NVLink gang in {domains[0]}; all {len(critical)} "
        f"critical pods still bound, {spot_taken} other spot pods evicted; "
        f"GPUs by queue {queue_gpus(cluster)} ({smi}; host times)")
    round3 = reclaim_round(cluster, mgr, sched, pre, hard_keys, seen,
                           fleet_gpus, tally, smi)
    return dict(spot_fabrics=research_only, spot_pods=spot_pods,
                critical_pods=len(critical), critical_kept=len(kept),
                spot_pods_evicted=spot_taken, dgx_domain=DGX_DOMAIN,
                dgx_fillers=len(fillers),
                setup=setup, prod_fabric=prod_fabric, cycles=cycles,
                evictions=tally["evictions"], gpus_taken_back=tally["gpus"],
                submit_to_bound_s=bound_s, gang_fabric=fabrics[0],
                nvl_gang_domain=domains[0], round3=round3)


# round 3: the conf with gangreclaim beside gangpreempt, and the queues'
# weights turned so that research is owed what prod holds
RECLAIM_ACTIONS = ["enqueue", "allocate", "elastic", "gangpreempt",
                   "gangreclaim", "preempt", "reclaim", "backfill"]
RECLAIM_WEIGHTS = {"research": 3, "prod": 1}


def reclaim_round(cluster, mgr, sched, pre, hard_keys, seen, fleet_gpus,
                  tally, smi):
    """Round 3, gangreclaim: the prod gang in DGX_DOMAIN finishes and
    prod's low-priority fillers, which gangpreempt evicted in round 1,
    take the domain back.  The queues' weights turn (RECLAIM_WEIGHTS),
    so prod stands above its deserved share, and gangreclaim joins the
    conf.  Research submits a gang of DGX_DOMAIN's 32 hosts held to one
    NVLink domain at its own priority: allocate finds no domain free,
    gangpreempt no research work below it there, preempt and reclaim
    skip hard-topology gangs, so only gangreclaim can free the domain.
    Cycled until the gang is bound, with the invariants read after each
    cycle.  Returns gangreclaim's evictions, the GPUs they freed and
    the gang's submit-to-bound s."""
    from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
    from volcano_tpu_torch.api.types import (GPU_CLIQUE_LABEL,
                                             NetworkTopologyMode, TaskStatus)
    nvl = cluster.vcjobs["default/hp-nvl"]
    finish_jobs(cluster, {nvl.uid})
    fillers = [j for j in cluster.vcjobs.values()
               if j.name.startswith("dgx-low")]

    def bound_nodes(jobs):
        uids = {j.uid for j in jobs}
        return {p.node_name for p in cluster.pods.values()
                if p.owner in uids and p.node_name and
                p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING)}
    refill = []
    while len(bound_nodes(fillers)) < dgx_hosts():
        if len(refill) == PREEMPT_MAX_CYCLES:
            raise AssertionError(f"the fillers hold "
                                 f"{len(bound_nodes(fillers))} hosts of "
                                 f"{DGX_DOMAIN} after {len(refill)} cycles")
        refill.append(preempt_cycle(cluster, mgr, sched, hard_keys, seen,
                                    fleet_gpus, tally))
    for name, weight in RECLAIM_WEIGHTS.items():
        cluster.queues[name].weight = weight
    sched.conf.actions = list(RECLAIM_ACTIONS)
    held = queue_gpus(cluster)
    deserved = {q: fleet_gpus * w / sum(RECLAIM_WEIGHTS.values())
                for q, w in RECLAIM_WEIGHTS.items()}
    log(f"[preempt] round 3: hp-nvl finished; the fillers took all "
        f"{dgx_hosts()} hosts of {DGX_DOMAIN} back in {len(refill)} "
        f"cycle(s); weights {RECLAIM_WEIGHTS}: GPUs by queue {held}, "
        f"deserved by weight {deserved}")
    before = {a: tally["evictions"].get(a, 0) for a in ("gangreclaim",)}
    gpus_before = tally["gpus"].get("gangreclaim", 0.0)
    t_submit = time.monotonic()
    gang = cluster.add_vcjob(gpu_job(
        "rc-nvl", "research", dgx_hosts(), "",
        NetworkTopologySpec(NetworkTopologyMode.HARD, 1), dgx=True))
    hard_keys.add(gang.key)
    cycles, bound_s = [], None
    while bound_s is None:
        if len(cycles) == PREEMPT_MAX_CYCLES:
            raise AssertionError(
                f"the research NVLink gang is still pending after "
                f"{len(cycles)} cycles; evictions {tally['evictions']}")
        cycles.append(preempt_cycle(cluster, mgr, sched, hard_keys, seen,
                                    fleet_gpus, tally))
        c = cycles[-1]
        if len(bound_nodes([gang])) >= gang.min_available:
            bound_s = time.monotonic() - t_submit
        log(f"[preempt] round 3, cycle {len(cycles)}: controllers "
            f"{c['sync_ms']:.3f} ms, scheduler {c['cycle_ms']:.3f} ms "
            f"(actions {c['actions_ms']}), evictions {c['evicted']}; "
            f"GPUs by queue before {c['queue_gpus_before']}; invariants "
            "hold")
    evictions = tally["evictions"].get("gangreclaim", 0) - \
        before["gangreclaim"]
    freed = tally["gpus"].get("gangreclaim", 0.0) - gpus_before
    domains = sorted({cluster.nodes[n].labels.get(GPU_CLIQUE_LABEL)
                      for n in bound_nodes([gang])})
    log(f"[preempt] round 3: gangreclaim evicted {evictions} prod pod(s), "
        f"{freed:g} GPUs freed; the research gang bound in {domains} "
        f"{bound_s:.3f} s after it arrived ({len(cycles)} cycle(s)); GPUs "
        f"by queue {queue_gpus(cluster)} ({smi}; host times)")
    if not evictions or domains != [DGX_DOMAIN]:
        raise AssertionError("the research gang bound without gangreclaim")
    return dict(refill_cycles=len(refill), weights=RECLAIM_WEIGHTS,
                queue_gpus_before=held, evictions=evictions,
                gpus_freed=freed, submit_to_bound_s=bound_s,
                cycles=cycles, domain=domains[0])


# -- phase_failover: a failed NVLink domain drained and resumed ---------

FAILOVER_TTL_S = 3.0       # the quarantine; the controller's default is 300
FAILOVER_STEPS = 6
FAILOVER_SAVE_EVERY = 2    # checkpoints at steps 2 and 4
FAILOVER_RESUME = 4
FAILOVER_MAX_CYCLES = 40
RTOL_FAILOVER = 1e-4       # resumed against uninterrupted losses, f32
# the pod's training process before the failure: the worker's model,
# seeds and mesh, checkpointed every FAILOVER_SAVE_EVERY steps (the
# worker itself only resumes), one JSON line of its losses last
FAILOVER_TRAIN = r"""
import json, os, sys
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, checkpoint, train, worker
from volcano_tpu_torch.workloads import mesh as mesh_lib
from volcano_tpu_torch.workloads.device import resolve_device
steps, every, last_save = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
device = resolve_device(os.environ.get("WORKER_DEVICE") or None)
info = bootstrap.initialize(device=device)
n = dist.get_world_size()
mesh = mesh_lib.make_mesh({"dp": n, "fsdp": 1}, device.type)
cfg, opt = worker.worker_config(), train.make_optimizer()
params, state, _ = train.init_sharded(torch.Generator().manual_seed(0), cfg,
                                      mesh, opt)
params, state, start = checkpoint.resume_state(params, state)
batch = train.synthetic_batch(torch.Generator().manual_seed(1), cfg, n,
                              worker.SEQ_LEN, mesh)
step_fn = train.make_train_step(cfg, opt, mesh)
losses = {}
for s in range(start + 1, steps + 1):
    params, state, m = step_fn(params, state, batch)
    losses[s] = float(m["loss"])
    if s % every == 0 and s <= last_save:
        checkpoint.save(info.checkpoint_dir, step=s, params=params,
                        opt_state=state)
bootstrap.shutdown()
print(json.dumps({"start": start, "losses": losses,
                  "device": str(params["embed"].device)}), flush=True)
"""


def failover_cluster(node):
    """This machine's node (an NVLink domain of its own) beside one IB
    fabric of SCHED_FABRIC_HOSTS HGX H100 hosts."""
    from volcano_tpu_torch.simulator import make_gpu_cluster
    return make_gpu_cluster(
        [(f"hgx{i:04d}", "hgx-h100-8") for i in range(SCHED_FABRIC_HOSTS)],
        ib_fabrics={f"hgx{i:04d}": "su00"
                    for i in range(SCHED_FABRIC_HOSTS)},
        extra_nodes=[node])


def failover_cycle(cluster, mgr, sched):
    mgr.sync_all()
    sched.run_once()
    cluster.tick()


def phase_failover(bootstrap, smi):
    """A vcjob on this card trains the worker's tiny f32 model on cuda
    and checkpoints every FAILOVER_SAVE_EVERY steps; then the node agent
    reports the card's host Failed over GpuHealthHandler's K ticks.  The
    failover controller drains the job (one restart), quarantines the
    NVLink domain and stamps the last checkpoint step.  Once the host is
    healthy and the quarantine lifted, the job rebinds to the card and
    the port's worker resumes there at the stamped step; its loss is
    held against the uninterrupted run's."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.agent.handlers import GpuHealthHandler
    from volcano_tpu_torch.api.slicehealth import (
        CHECKPOINT_DIR_ANNOTATION, FAILOVER_GENERATION_ANNOTATION,
        LAST_STEP_ANNOTATION, RESUME_STEP_ANNOTATION)
    from volcano_tpu_torch.api.types import JobPhase
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import fail_host, heal_host
    from volcano_tpu_torch.webhooks.admission import default_admission
    node = local_node()
    cluster = failover_cluster(node)
    cluster.admission = default_admission()
    mgr = ControllerManager(cluster, enabled=["job", "podgroup", "queue",
                                              "failover"])
    ctrl = next(c for c in mgr.controllers if c.name == "failover")
    ctrl.quarantine_ttl = FAILOVER_TTL_S
    sched = Scheduler(cluster, schedule_period=0)
    tmp = tempfile.mkdtemp(prefix="vtp-failover-")
    ckpt = os.path.join(tmp, "ckpt")
    try:
        job = e2e_job(node)
        job.name = "failover"
        job.annotations[CHECKPOINT_DIR_ANNOTATION] = ckpt
        job = cluster.add_vcjob(job)

        def pod_of():
            placed = [p for p in cluster.pods.values()
                      if p.owner == job.uid and p.node_name]
            return placed[0] if len(placed) == 1 else None

        for _ in range(5):
            failover_cycle(cluster, mgr, sched)
            if cluster.vcjobs[job.key].phase is JobPhase.RUNNING:
                break
        first = pod_of()
        if first is None or first.node_name != node.name:
            raise AssertionError("the failover job is not on this card")
        rc, out, err, first_s = PodWorker(
            first, node, bootstrap,
            ("-c", FAILOVER_TRAIN, str(FAILOVER_STEPS),
             str(FAILOVER_SAVE_EVERY), str(FAILOVER_RESUME))).wait()
        if rc != 0:
            raise AssertionError(f"the training pod exited {rc}:\n"
                                 f"{err[-3000:]}")
        straight = json.loads(out.strip().splitlines()[-1])
        log(f"[failover] the pod's training run on {first.node_name}: "
            f"{first_s:.3f} s, losses {straight['losses']} on "
            f"{straight['device']}; checkpoints at steps "
            f"{sorted(int(x) for x in os.listdir(ckpt))}")
        if not straight["device"].startswith("cuda"):
            raise AssertionError("the training run was not on the card")
        # the workload's supervisor publishes the last durable step
        pg = cluster.podgroups[job.key]
        pg.annotations[LAST_STEP_ANNOTATION] = str(FAILOVER_RESUME)
        cluster.update_podgroup_status(pg)

        provider = FakeUsageProvider()
        agent = NodeAgent(cluster, node.name, provider=provider,
                          handlers=[GpuHealthHandler])
        t_fault = time.monotonic()
        fail_host(cluster, node.name, provider=provider, chips_healthy=0)
        verdicts = []
        for _ in range(GpuHealthHandler.FAIL_SYNCS):
            agent.sync()
            verdicts.append(cluster.slicehealthreports[node.name].verdict)
        failover_cycle(cluster, mgr, sched)
        cycles = 1
        while pod_of() is not None and cycles < FAILOVER_MAX_CYCLES:
            failover_cycle(cluster, mgr, sched)
            cycles += 1
        t_drained = time.monotonic()
        restarts = [m for k, r, m in cluster.events if r == "FailoverDrain"]
        stamped = cluster.vcjobs[job.key].annotations.get(
            RESUME_STEP_ANNOTATION)
        log(f"[failover] agent verdicts {verdicts}; drained in {cycles} "
            f"cycle(s), {t_drained - t_fault:.3f} s after the fault; "
            f"{len(restarts)} restart(s): {restarts}; resume step stamped "
            f"{stamped}")
        if verdicts[-1] != "Failed" or len(restarts) != 1 or \
                stamped != str(FAILOVER_RESUME) or pod_of() is not None:
            raise AssertionError("the failover drain is off")

        heal_host(cluster, node.name, provider=provider)
        for _ in range(GpuHealthHandler.RECOVER_SYNCS):
            agent.sync()
        while cycles < FAILOVER_MAX_CYCLES and (
                pod_of() is None or cluster.vcjobs[job.key].phase
                is not JobPhase.RUNNING):
            time.sleep(0.2)          # the quarantine's TTL runs on
            failover_cycle(cluster, mgr, sched)
            cycles += 1
        second = pod_of()
        t_rebound = time.monotonic()
        if second is None or second.node_name != node.name:
            raise AssertionError(f"the job came back on "
                                 f"{second.node_name if second else None}, "
                                 "not on this card")
        env = second.containers[0].env
        _, resume_s, resumed = PodWorker(
            second, node, bootstrap,
            WORKER_STEPS=FAILOVER_STEPS - FAILOVER_RESUME).result(
                "[failover] resumed:")
        t_resumed = time.monotonic()
        want = straight["losses"][str(FAILOVER_STEPS)]
        rel = abs(resumed["loss"] - want) / abs(want)
        observed = {name: metrics.get_observations(
            f"failover_{name}_seconds", slice=node.name)
            for name in ("detect", "drain", "reschedule", "resume", "mttr")}
        log(f"[failover] rebound to {second.node_name} after {cycles} "
            f"cycles, {t_rebound - t_drained:.3f} s after the drain; env "
            f"VTP_RESUME_STEP={env.get('VTP_RESUME_STEP')} "
            f"VTP_CHECKPOINT_DIR={env.get('VTP_CHECKPOINT_DIR')}; the "
            f"worker {resume_s:.3f} s to its line; step {FAILOVER_STEPS} loss {resumed['loss']} against the "
            f"uninterrupted run's {want:.6f} (rel {rel:.2e}, tolerance "
            f"{RTOL_FAILOVER:g} relative, f32; the worker's line rounds "
            f"to 4 decimals)")
        log(f"[failover] the controller's metrics (s): {observed}; it "
            "counts a reschedule only off the failed NVLink domain, and "
            "this job can run on this card alone, so reschedule, resume "
            "and MTTR stay unobserved; by this script's clock: fault to "
            f"drained {t_drained - t_fault:.3f} s, drained to rebound "
            f"{t_rebound - t_drained:.3f} s, rebound to the worker's line "
            f"{t_resumed - t_rebound:.3f} s, fault to the worker's line "
            f"{t_resumed - t_fault:.3f} s ({smi}; host times)")
        if resumed["start_step"] != int(stamped) or rel > RTOL_FAILOVER or \
                cluster.vcjobs[job.key].annotations.get(
                    FAILOVER_GENERATION_ANNOTATION) != "1":
            raise AssertionError("the resumed run is off")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(first_launch_s=first_s, resumed_launch_s=resume_s,
                cycles=cycles, stamped_step=int(stamped),
                start_step=resumed["start_step"],
                losses=straight["losses"], resumed_loss=resumed["loss"],
                rel_err=rel, controller_s=observed,
                fault_to_drained_s=t_drained - t_fault,
                drained_to_rebound_s=t_rebound - t_drained,
                rebound_to_line_s=t_resumed - t_rebound,
                fault_to_line_s=t_resumed - t_fault)


# -- phase_cli: the operator's path through the port's CLI ---------------

CLI_FABRICS = 4            # IB fabrics of the rendered bundle's topology
CLI_FABRIC_HOSTS = 32      # HGX H100 hosts (one NVLink domain each) a fabric
CLI_GANG_HOSTS = 16        # the gang held to one fabric
CLI_QUEUE = "cli"
CLI_CALL_S = 120           # a vtpctl call's limit
CARD_MANIFEST = """\
kind: Job
metadata: {{name: cli-card}}
spec:
  minAvailable: 1
  queue: {queue}
  plugins: {{torch: [], svc: []}}
  tasks:
    - name: worker
      replicas: 1
      template:
        spec:
          containers:
            - name: main
              resources:
                requests: {{cpu: 4, nvidia.com/gpu: 1}}
          nodeSelector: {{{hostname_label}: {host}}}
          tolerations: [{{key: {taint}, operator: Exists}}]
"""
GANG_MANIFEST = """\
kind: Job
metadata: {{name: cli-gang}}
spec:
  minAvailable: {hosts}
  queue: {queue}
  networkTopology: {{mode: hard, highestTierAllowed: 2}}
  tasks:
    - name: worker
      replicas: {hosts}
      template:
        spec:
          containers:
            - name: main
              resources:
                requests: {{cpu: 8, memory: 32Gi, nvidia.com/gpu: 8}}
"""


def cli_topology():
    """The bundle's --topology: CLI_FABRICS fabrics of CLI_FABRIC_HOSTS
    hgx-h100-8 NVLink domains, NAME:KIND@FABRIC."""
    return ",".join(f"c{f}h{i:02d}:hgx-h100-8@cli-ib{f}"
                    for f in range(CLI_FABRICS)
                    for i in range(CLI_FABRIC_HOSTS))


def unit_argv(path, **subst):
    """A rendered systemd unit's ExecStart as this interpreter's argv
    (without the interpreter), systemd's specifiers given by `subst`."""
    with open(path) as f:
        cmd = next(line for line in f.read().splitlines()
                   if line.startswith("ExecStart="))[len("ExecStart="):]
    for key, value in subst.items():
        cmd = cmd.replace(key, value)
    argv = shlex.split(cmd)
    if argv[0] != "python3":
        raise AssertionError(f"{path} does not run a module: {cmd}")
    return argv[1:]


def port_env():
    return dict(os.environ, PYTHON=sys.executable,
                PYTHONPATH=os.pathsep.join(
                    p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def cells(text):
    """A vtpctl table as rows of cells."""
    return [re.split(r"\s{2,}", line.strip())
            for line in text.splitlines() if line.strip()]


def metrics_text(url):
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        return r.read().decode()


class Vtpctl:
    """`python -m volcano_tpu_torch.cli.vtpctl --server URL` as the
    operator runs it, with each call's wall s."""

    def __init__(self, plane):
        self.plane, self.calls = plane, []

    def __call__(self, *args):
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.cli.vtpctl",
             "--server", self.plane.url, "--token-file",
             self.plane.token_file, *args], cwd=REPO, env=port_env(),
            capture_output=True, text=True, timeout=CLI_CALL_S)
        wall = time.monotonic() - t0
        self.calls.append((" ".join(args), round(wall, 3)))
        if res.returncode != 0:
            raise AssertionError(f"vtpctl {' '.join(args)} exited "
                                 f"{res.returncode}:\n{res.stderr[-2000:]}")
        return res.stdout


def fabric_of(kubectl, pods):
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    return sorted({kubectl.nodes[p.node_name].labels.get(IB_FABRIC_LABEL)
                   for p in pods})


def phase_cli(bootstrap, smi):
    """The operator's path on this machine: a bundle rendered by `python
    -m volcano_tpu_torch.bundle` for CLI_FABRICS IB fabrics of
    CLI_FABRIC_HOSTS HGX H100 hosts; the state server, the controllers
    and the scheduler started from its units (its token, its scheduler
    conf); this machine's node seeded and verified by the node agent;
    the bundle's cluster-init.sh registering the hosts through the
    port's vtpctl; then every step through `python -m
    volcano_tpu_torch.cli.vtpctl --server`: a queue, a one-GPU job from
    YAML pinned to this card, a gang of CLI_GANG_HOSTS whole hosts held
    to one IB fabric, the views, vsuspend and vresume of the gang, and
    vcancel.  The card job's pod runs as the port's worker on cuda; the
    scheduler's and the server's live /metrics hold to the bundle's
    label schema."""
    from volcano_tpu_torch.agent.agent import GPU_HEALTHY_LABEL, NodeAgent
    from volcano_tpu_torch.agent.collect import (CompositeUsageProvider,
                                                 GpuChipCollector)
    from volcano_tpu_torch.agent.handlers import GpuHealthHandler
    from volcano_tpu_torch.analysis.schema import check_exposition
    from volcano_tpu_torch.api.types import TaskStatus
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    node = local_node()
    n_gpus = torch.cuda.device_count()
    workdir = tempfile.mkdtemp(prefix="vtp-cli-")
    bundle = os.path.join(workdir, "bundle")
    plane, kubectl, worker = WirePlane(workdir), None, None
    try:
        port = free_port()
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.bundle", "--out",
             bundle, "--topology", cli_topology(), "--port", str(port),
             "--data-dir", os.path.join(workdir, "data")],
            cwd=REPO, env=port_env(), capture_output=True, text=True,
            timeout=CLI_CALL_S)
        if res.returncode != 0:
            raise AssertionError(f"the bundle did not render:\n{res.stderr}")
        render_s = time.monotonic() - t0
        # the plane is the bundle's: its port, token and data dir
        plane.port, plane.url = port, f"http://127.0.0.1:{port}"
        plane.token_file = os.path.join(bundle, "token")
        with open(plane.token_file) as f:
            plane.token = f.read().strip()
        units = os.path.join(bundle, "systemd")
        t0 = time.monotonic()
        plane.spawn("server", *unit_argv(
            os.path.join(units, "volcano-tpu-server.service")))
        plane.until(plane.healthy, WIRE_BOOT_S, "the state server's /healthz")
        boot_s = time.monotonic() - t0
        kubectl = RemoteCluster(plane.url, token=plane.token)
        kubectl.add_node(node)
        # this machine's node agent: the GPU chip collector and health
        # handler, reporting over the wire
        agent = NodeAgent(kubectl, node.name, provider=CompositeUsageProvider(
            [GpuChipCollector()]), handlers=[GpuHealthHandler])
        for _ in range(GpuHealthHandler.FAIL_SYNCS):
            agent.sync()
        plane.until(lambda: kubectl.nodes.get(node.name) is not None and
                    kubectl.nodes[node.name].labels.get(GPU_HEALTHY_LABEL)
                    == "true", WIRE_TIMEOUT_S, "the card's health label")
        for role in ("controllers", "scheduler"):
            argv = unit_argv(os.path.join(units, f"volcano-tpu-{role}.service"),
                             **{"%H": "cli-s1"})
            plane.metrics_port[role] = int(
                argv[argv.index("--metrics-port") + 1])
            # the units' period (1 s) shortened to the wire phase's
            plane.spawn(role, *argv, "--period", str(WIRE_PERIOD_S))
        t0 = time.monotonic()
        res = subprocess.run(["sh", os.path.join(bundle, "cluster-init.sh")],
                             cwd=REPO, env=port_env(), capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"cluster-init.sh exited {res.returncode}:"
                                 f"\n{res.stderr[-2000:]}")
        init_s = time.monotonic() - t0
        hosts = CLI_FABRICS * CLI_FABRIC_HOSTS
        plane.until(lambda: len(kubectl.nodes) == hosts + 1, WIRE_TIMEOUT_S,
                    "the registered hosts")
        log(f"[cli] bundle rendered in {render_s:.3f} s ({hosts} hosts in "
            f"{CLI_FABRICS} fabrics); the server up from its unit in "
            f"{boot_s:.3f} s; cluster-init.sh registered {hosts} hosts in "
            f"{init_s:.3f} s ({smi}; host times)")

        vtpctl = Vtpctl(plane)
        vtpctl("queue", "create", "-N", CLI_QUEUE, "--weight", "1")
        manifests = {}
        for name, text in (("card", CARD_MANIFEST.format(
                queue=CLI_QUEUE, hostname_label=HOSTNAME_LABEL,
                host=node.name, taint=LOCAL_TAINT)),
                ("gang", GANG_MANIFEST.format(queue=CLI_QUEUE,
                                              hosts=CLI_GANG_HOSTS))):
            manifests[name] = os.path.join(workdir, f"{name}.yaml")
            with open(manifests[name], "w") as f:
                f.write(text)
        submitted = {}
        for name in ("card", "gang"):
            submitted[name] = time.monotonic()
            vtpctl("job", "create", "-f", manifests[name])
        want = {"card": 1, "gang": CLI_GANG_HOSTS}

        def bound(name):
            job = kubectl.vcjobs.get(f"default/cli-{name}")
            return [] if job is None else [
                p for p in kubectl.pods.values()
                if p.owner == job.uid and p.node_name and
                p.phase in (TaskStatus.BOUND, TaskStatus.RUNNING)]
        bound_s = {}

        def all_bound():
            for name in want:
                if name not in bound_s and len(bound(name)) == want[name]:
                    bound_s[name] = time.monotonic() - submitted[name]
            return len(bound_s) == len(want)
        plane.until(all_bound, WIRE_TIMEOUT_S, "both jobs' binds")
        vtpctl("tick", "--cycles", "1")            # the kubelet
        plane.until(lambda: all(
            kubectl.vcjobs[f"default/cli-{n}"].phase.value == "Running"
            for n in want), WIRE_TIMEOUT_S, "both jobs Running")
        (card_pod,) = bound("card")
        worker = PodWorker(card_pod, node, bootstrap)

        jobs = {r[1]: r for r in cells(vtpctl("job", "list"))[1:]}
        view = json.loads(vtpctl("job", "view", "-N", "cli-gang"))
        gang_nodes = {p["node"] for p in view["pods"]}
        gang_fabrics = fabric_of(kubectl, bound("gang"))
        nodes = {r[0]: r for r in cells(vtpctl("node", "list"))}
        header = nodes.pop("NAME")
        card_row = dict(zip(header, nodes[node.name]))
        slices = cells(vtpctl("slices"))
        shapes = {}
        for row in slices[1:]:
            shapes[row[1]] = shapes.get(row[1], 0) + 1
        explain = vtpctl("explain", "cli-gang")
        fleet = vtpctl("fleet")
        log(f"[cli] job list {[jobs[k][:4] for k in sorted(jobs)]}; the gang's "
            f"{len(gang_nodes)} pods in fabric(s) {gang_fabrics}; the card's "
            f"node {card_row}; slices: {len(slices) - 1} NVLink domains by "
            f"shape {shapes}; explain: {explain.splitlines()[:2]}; fleet: "
            f"{len(fleet.splitlines())} line(s)")
        if jobs["cli-card"][2:4] != ["Running", "1/1"] or \
                jobs["cli-gang"][2:4] != ["Running",
                                          f"{CLI_GANG_HOSTS}/{CLI_GANG_HOSTS}"]:
            raise AssertionError(f"job list: {jobs}")
        if len(gang_nodes) != CLI_GANG_HOSTS or len(gang_fabrics) != 1:
            raise AssertionError(f"the gang spans {gang_fabrics}")
        if card_row["GPUS"] != f"1/{n_gpus}" or card_row["GPU-OK"] != "true":
            raise AssertionError(f"the card's node row: {card_row}")
        want_shapes = {"1x8": hosts}
        want_shapes[f"1x{n_gpus}"] = want_shapes.get(f"1x{n_gpus}", 0) + 1
        if shapes != want_shapes:
            raise AssertionError(f"slices: {shapes}, want {want_shapes}")

        t0 = time.monotonic()
        vtpctl("vsuspend", "-N", "cli-gang")
        plane.until(lambda: not bound("gang"), WIRE_TIMEOUT_S,
                    "the suspended gang's pods gone")
        suspend_s = time.monotonic() - t0
        suspended = kubectl.vcjobs["default/cli-gang"].phase.value
        t0 = time.monotonic()
        vtpctl("vresume", "-N", "cli-gang")
        plane.until(lambda: len(bound("gang")) == CLI_GANG_HOSTS,
                    WIRE_TIMEOUT_S, "the resumed gang's binds")
        resume_s = time.monotonic() - t0
        resumed_fabrics = fabric_of(kubectl, bound("gang"))
        log(f"[cli] vsuspend: the gang's pods gone in {suspend_s:.3f} s "
            f"(phase {suspended}); vresume: {CLI_GANG_HOSTS} pods bound again "
            f"in {resume_s:.3f} s, fabric(s) {resumed_fabrics}")
        if len(resumed_fabrics) != 1:
            raise AssertionError("the resumed gang spans fabrics")

        injected, launch_s, line = worker.result("[cli] card job:")
        violations = {}
        for name in ("scheduler", "server"):
            url = plane.url if name == "server" else \
                f"http://127.0.0.1:{plane.metrics_port[name]}"
            text = metrics_text(url)
            violations[name] = check_exposition(text)
            log(f"[cli] {name} /metrics: {len(text.splitlines())} lines, "
                f"{len(violations[name])} schema violation(s) "
                f"{violations[name][:5]}")
        if any(violations.values()):
            raise AssertionError("the live /metrics break the label schema")
        vtpctl("vcancel", "-N", "cli-gang")
        vtpctl("vcancel", "-N", "cli-card")
        left = cells(vtpctl("vjobs"))[1:]
        if left:
            raise AssertionError(f"jobs left after vcancel: {left}")
    finally:
        if worker is not None:
            worker.kill()
        if kubectl is not None:
            kubectl.close()
        plane.stop()
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[cli] vtpctl calls (wall s): {vtpctl.calls}; submit -> "
        f"bound s {json.dumps({k: round(v, 3) for k, v in bound_s.items()})}; "
        f"the card job's pod: launch -> the worker's line {launch_s:.3f} s "
        f"({smi}; host times)")
    return dict(hosts=hosts, render_s=render_s, boot_s=boot_s,
                init_s=init_s, vtpctl_calls=vtpctl.calls,
                submit_to_bound_s=bound_s, suspend_s=suspend_s,
                resume_s=resume_s, gang_fabric=gang_fabrics[0],
                domains=len(slices) - 1, launch_to_line_s=launch_s,
                injected=injected, result=line,
                schema_violations={k: len(v) for k, v in violations.items()})


# -- phase_federation: one global queue over two regional GPU planes ------

FED_FABRICS = 4            # IB fabrics of each region
FED_FABRIC_HOSTS = 32      # HGX H100 hosts a fabric
FED_GANGS = 12             # the global backlog's gangs ...
FED_GANG_HOSTS = 16        # ... of whole hosts (8 GPUs a pod)
FED_PRICES = {"local": 1.0, "remote": 0.7}
FED_SYNC_S = 0.5           # the router's reconcile period
FED_ARBITRAGE_S = 3.0      # a gang pending this long in one region moves
FED_TICK_S = 0.2           # the regional servers' simulated kubelet
FED_WORKER_STEPS = 200     # the card job's training steps
FED_ACKED_STEP = 100       # acked step stamped on the first remote gang


def fed_fleet(prefix, extra=()):
    from volcano_tpu_torch.simulator import make_gpu_cluster
    names = [f"{prefix}{f}h{i:02d}" for f in range(FED_FABRICS)
             for i in range(FED_FABRIC_HOSTS)]
    return make_gpu_cluster(
        [(n, "hgx-h100-8") for n in names],
        ib_fabrics={n: f"{prefix}-ib{n[1]}" for n in names},
        extra_nodes=extra)


class FedRegion:
    """One regional plane as processes: its state server (durable, seeded
    with its fleet, its kubelet simulated), controllers and scheduler."""

    def __init__(self, name, fleet, workdir):
        import pickle
        self.name = name
        os.makedirs(os.path.join(workdir, name))
        self.plane = WirePlane(os.path.join(workdir, name))
        seed = os.path.join(self.plane.workdir, "seed.pkl")
        with open(seed, "wb") as f:
            pickle.dump(fleet, f)
        p = self.plane
        p.spawn("server", "-m", "volcano_tpu_torch.server", "--port",
                str(p.port), "--data-dir", p.data_dir, "--token-file",
                p.token_file, "--state", seed, "--tick-period",
                str(FED_TICK_S))

    def start_clients(self):
        self.plane.until(self.plane.healthy, WIRE_BOOT_S,
                         f"region {self.name}'s /healthz")
        self.plane.start_client("controllers", "--components", "controllers")
        self.plane.start_client("scheduler", "--components", "scheduler",
                                "--leader-elect", "--holder",
                                f"{self.name}-s1")


def fed_view(g, key):
    """(admitted region, folded regional phase, attempt) of a global job."""
    from volcano_tpu_torch.api import federation as fedapi
    job = g.vcjobs.get(key)
    if job is None:
        return None, None, None
    return (fedapi.admitted_region(job),
            job.annotations.get(fedapi.FED_REGIONAL_PHASE_ANNOTATION),
            int(job.annotations.get(fedapi.FED_ATTEMPT_ANNOTATION, 0) or 0))


def fed_stamp(client, key, step):
    """What the regional progress fold does: acked checkpoint metadata
    on the regional job.  False if the copy is not there."""
    from volcano_tpu_torch.api.slicehealth import (
        CHECKPOINT_DIR_ANNOTATION, LAST_STEP_ANNOTATION,
        RESUME_STEP_ANNOTATION)
    job = client.vcjobs.get(key)
    if job is None:
        return False
    job.annotations[LAST_STEP_ANNOTATION] = str(step)
    job.annotations[RESUME_STEP_ANNOTATION] = str(step)
    job.annotations[CHECKPOINT_DIR_ANNOTATION] = f"/ckpt/{key}"
    client.update_vcjob(job)
    return True


def fed_stamp_progress(plane, key, worker, progress, stamps):
    """Stamp the worker's progress (its step) on the regional job every
    FED_SYNC_S until it exits, through a client of its own; the exit is
    stamped on the worker (to FED_SYNC_S)."""
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    client = RemoteCluster(plane.url, token=plane.token)
    try:
        while worker.proc.poll() is None:
            try:
                with open(progress) as f:
                    step = int(json.load(f)["step"])
            except (OSError, ValueError, KeyError):
                step = None
            if step and (not stamps or step > stamps[-1][1]):
                fed_stamp(client, key, step)
                stamps.append((time.monotonic(), step))
            time.sleep(FED_SYNC_S)
        worker.exited = time.monotonic()
    finally:
        client.close()


def fmt_goodput(goodput):
    return {f"{r}/{gen}": v for (r, gen), v in goodput.items()}


def phase_federation(bootstrap, smi):
    """One global queue over two regional GPU planes, every part a process
    of its own: a global state server, the regions `local` (this
    machine's node beside FED_FABRICS fabrics of FED_FABRIC_HOSTS HGX
    H100 hosts, price 1.0) and `remote` (as many hosts, price 0.7), each
    with its server, controllers and scheduler, and `python -m
    volcano_tpu_torch.federation.router`.  The global backlog: FED_GANGS
    gangs of FED_GANG_HOSTS whole hosts and a one-GPU job with locality
    `local` pinned to this card, whose pod runs the port's worker on
    cuda; the script stamps its steps on the regional job as the
    progress fold does and the router learns local's goodput from them.
    Then remote's server is killed with SIGKILL: the router declares the
    region lost after its TTL and requeues its gangs globally with the
    attempt bumped; local binds as many as it has room for."""
    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.goodput import generation_of
    from volcano_tpu_torch.api.slicehealth import (LAST_STEP_ANNOTATION,
                                                   RESUME_STEP_ANNOTATION)
    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    node = local_node()
    workdir = tempfile.mkdtemp(prefix="vtp-fed-")
    os.makedirs(os.path.join(workdir, "global"))
    gplane = WirePlane(os.path.join(workdir, "global"))
    regions, clients, g, worker = {}, {}, None, None
    try:
        t0 = time.monotonic()
        fleets = {"local": fed_fleet("l", [node]), "remote": fed_fleet("r")}
        generations = {}
        for name, fleet in fleets.items():
            counts = {}
            for n in fleet.nodes.values():
                gen = generation_of(n.labels)
                counts[gen] = counts.get(gen, 0) + 1
            generations[name] = max(counts, key=counts.get)
            regions[name] = FedRegion(name, fleet, workdir)
        gplane.spawn("server", "-m", "volcano_tpu_torch.server", "--port",
                     str(gplane.port), "--data-dir", gplane.data_dir,
                     "--token-file", gplane.token_file)
        gplane.until(gplane.healthy, WIRE_BOOT_S, "the global server")
        for region in regions.values():
            region.start_clients()
        g = RemoteCluster(gplane.url, token=gplane.token)
        for name, region in regions.items():
            clients[name] = RemoteCluster(region.plane.url,
                                          token=region.plane.token)
            g.put_object("region", fedapi.region_record(
                name, region.plane.url, price=FED_PRICES[name],
                token=region.plane.token), key=name)
        router_port = free_port()
        gplane.metrics_port["router"] = router_port
        gplane.spawn("router", "-m", "volcano_tpu_torch.federation.router",
                     "--store", gplane.url, "--token", gplane.token,
                     "--sync-s", str(FED_SYNC_S), "--arbitrage-s",
                     str(FED_ARBITRAGE_S), "--holder", "rt1",
                     "--metrics-port", str(router_port))
        gplane.until(lambda: all(
            float((g.regions.get(n) or {}).get("capacity_chips", 0) or 0) > 0
            for n in regions), WIRE_TIMEOUT_S, "both regions' capacity")
        up_s = time.monotonic() - t0
        log(f"[federation] {len(fleets['local'].nodes)} + "
            f"{len(fleets['remote'].nodes)} hosts, 8 processes up in "
            f"{up_s:.3f} s; capacity by region "
            f"{ {n: g.regions[n]['capacity_chips'] for n in regions} }, "
            f"generations {generations} ({smi}; host times)")

        # the global backlog
        jobs, submitted = [], {}
        for i in range(FED_GANGS):
            jobs.append(gpu_job(f"fg{i:02d}", "default", FED_GANG_HOSTS, ""))
        card = e2e_job(node)
        card.name = "fed-card"
        card.annotations[fedapi.FED_DATA_LOCALITY_ANNOTATION] = "local"
        jobs.append(card)
        for job in jobs:
            submitted[job.key] = time.monotonic()
            g.add_vcjob(job)
        admitted_s, running_s = {}, {}

        def settled():
            for key in submitted:
                region, phase, _ = fed_view(g, key)
                now = time.monotonic()
                if region and key not in admitted_s:
                    admitted_s[key] = now - submitted[key]
                if region and phase == "Running":
                    running_s.setdefault(key, now - submitted[key])
                else:
                    running_s.pop(key, None)
            return len(running_s) == len(submitted)
        gplane.until(settled, WIRE_TIMEOUT_S, "every global job Running")
        split = {}
        for key in submitted:
            split.setdefault(fed_view(g, key)[0], []).append(key)
        attempts = {k: fed_view(g, k)[2] for k in submitted}
        log(f"[federation] admission s (submit -> first admitted) "
            f"{json.dumps({k.split('/')[1]: round(v, 3) for k, v in admitted_s.items()})}; "
            f"submit -> Running s "
            f"{json.dumps({k.split('/')[1]: round(v, 3) for k, v in running_s.items()})}; "
            f"split {json.dumps({r: len(v) for r, v in split.items()})}; "
            f"attempts {attempts} ({smi}; host times)")
        if set(split) != {"local", "remote"} or \
                fed_view(g, card.key)[0] != "local":
            raise AssertionError(f"the regions' split: {split}")

        # the card job's pod as the port's worker; a thread stamps its
        # steps on the regional job as the progress fold does, while the
        # remote gangs' acked steps are folded and the region dies
        lc = clients["local"]
        regions["local"].plane.until(lambda: any(
            p.node_name == node.name for p in lc.pods.values()
            if lc.vcjobs.get(card.key) and
            p.owner == lc.vcjobs[card.key].uid),
            WIRE_TIMEOUT_S, "the card job's pod in local")
        (pod,) = [p for p in lc.pods.values()
                  if p.owner == lc.vcjobs[card.key].uid]
        progress = os.path.join(workdir, "progress.json")
        worker = PodWorker(pod, node, bootstrap,
                           WORKER_STEPS=FED_WORKER_STEPS,
                           VTP_PROGRESS_FILE=progress)
        stamps = []
        stamper = threading.Thread(
            target=fed_stamp_progress, daemon=True,
            args=(regions["local"].plane, card.key, worker, progress, stamps))
        stamper.start()

        # acked progress on remote's gangs, folded into the global store
        remote_keys = sorted(split["remote"])
        acked = {}
        for i, key in enumerate(remote_keys):
            acked[key] = FED_ACKED_STEP + i
            deadline = time.monotonic() + WIRE_TIMEOUT_S
            while True:
                gplane.check()
                if not fed_stamp(clients["remote"], key, acked[key]):
                    raise AssertionError(f"no copy of {key} in remote")
                inner = time.monotonic() + 3
                folded = None
                while time.monotonic() < inner:
                    folded = g.vcjobs[key].annotations.get(
                        LAST_STEP_ANNOTATION)
                    if folded == str(acked[key]):
                        break
                    time.sleep(0.1)
                if folded == str(acked[key]):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{key}'s step never folded")

        def learned():
            return {(n, generations[n]): series(
                gplane.metrics("router"),
                "federation_region_goodput_steps_per_chip", region=n)
                for n in regions}
        gplane.until(lambda: learned()[("local", generations["local"])] > 0,
                     WORKER_TIMEOUT_S, "local's learned goodput")
        goodput_first = learned()

        # the region dies
        before = {k: fed_view(g, k)[2] for k in remote_keys}
        t_kill = time.monotonic()
        regions["remote"].plane.kill9("server")
        gplane.until(lambda: (g.regions.get("remote") or {}).get("state")
                     == fedapi.REGION_STATE_LOST, 4 * fedapi.REGION_TTL_S,
                     "remote declared lost")
        lost_s = time.monotonic() - t_kill
        t_lost = time.monotonic()
        requeued_running = {}

        def requeued():
            views = {k: fed_view(g, k) for k in remote_keys}
            for k, (region, phase, attempt) in views.items():
                if region == "local" and phase == "Running" and \
                        attempt > before[k]:
                    requeued_running.setdefault(k, time.monotonic() - t_lost)
            return all(a > before[k] and r != "remote"
                       for k, (r, _, a) in views.items()) and \
                len(requeued_running) >= 1
        gplane.until(requeued, WIRE_TIMEOUT_S, "remote's gangs requeued")
        # the rebinds settle: local is full once its fabrics are
        time.sleep(3 * FED_SYNC_S)
        requeued()
        views = {k: fed_view(g, k) for k in remote_keys}
        waiting = sorted(k for k, (r, p, _) in views.items()
                         if k not in requeued_running)
        lost_steps = 0
        for key in remote_keys:
            job = g.vcjobs[key]
            resume = int(job.annotations.get(RESUME_STEP_ANNOTATION, 0) or 0)
            lost_steps += max(0, acked[key] - resume)
            copy = lc.vcjobs.get(key)
            if copy is not None and views[key][0] == "local":
                lost_steps += max(0, acked[key] - int(copy.annotations.get(
                    RESUME_STEP_ANNOTATION, 0) or 0))
        with open(gplane.logs["router"], errors="replace") as f:
            router_log = f.read()
        sync_errors = router_log.count("router sync failed")
        # the router's own lease: a pass that outlasts its TTL loses it
        # and the next pass takes it back at a higher term
        promotions = router_log.count("promoted: term")
        log(f"[federation] remote's server killed: declared lost "
            f"{lost_s:.3f} s after the kill (TTL {fedapi.REGION_TTL_S:g} s); "
            f"{len(remote_keys)} gangs requeued with the attempt bumped "
            f"{ {k.split('/')[1]: [before[k], views[k][2]] for k in remote_keys} }; "
            f"{len(requeued_running)} Running again in local (requeue -> "
            f"Running s "
            f"{json.dumps({k.split('/')[1]: round(v, 3) for k, v in requeued_running.items()})}), "
            f"{len(waiting)} waiting "
            f"{ {k.split('/')[1]: views[k][:2] for k in waiting} }; acked "
            f"steps lost {lost_steps}; router sync errors {sync_errors}; the "
            f"router took its lease {promotions} time(s) ({smi}; host "
            "times)")
        if lost_steps or sync_errors or not requeued_running:
            raise AssertionError("the region loss lost progress or the "
                                 "router failed a sync")
        stamper.join(timeout=WORKER_TIMEOUT_S)
        injected, launch_s, line = worker.result("[federation] card job:")
        worker = None
        goodput = learned()
        log(f"[federation] the card job's worker: {len(stamps)} step stamps "
            f"up to step {stamps[-1][1] if stamps else None}; learned "
            f"goodput (steps/s a GPU) by (region, generation) when first "
            f"read {fmt_goodput(goodput_first)}, at the end "
            f"{fmt_goodput(goodput)} ({smi}; host times)")
    finally:
        if worker is not None:
            worker.kill()
        for client in clients.values():
            client.close()
        if g is not None:
            g.close()
        gplane.stop()
        for region in regions.values():
            region.plane.stop()
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(hosts={n: len(f.nodes) for n, f in fleets.items()},
                up_s=up_s, admitted_s=admitted_s, running_s=running_s,
                split={r: len(v) for r, v in split.items()},
                attempts=attempts, card_launch_to_line_s=launch_s,
                card_result=line, step_stamps=len(stamps),
                goodput_first=fmt_goodput(goodput_first),
                goodput=fmt_goodput(goodput),
                loss_detected_s=lost_s, requeued=len(remote_keys),
                rebound=len(requeued_running),
                requeue_to_running_s=requeued_running,
                waiting=len(waiting), acked_steps_lost=lost_steps,
                router_sync_errors=sync_errors,
                router_lease_promotions=promotions)


def main() -> int:
    # the port first: alone, without the repo, the script fails here
    # before it prints anything
    from volcano_tpu_torch.workloads import (bootstrap, checkpoint, model,
                                             moe, pipeline, serve, train,
                                             worker)
    from volcano_tpu_torch.workloads import mesh as mesh_lib
    from volcano_tpu_torch.workloads.ops import _build
    fa = importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")
    name, smi = phase_device()
    peak_key, (flop_peak, byte_peak) = peaks(name)
    log(f"[device] roofline peaks of {peak_key}: {flop_peak / 1e12:.0f} "
        f"TFLOP/s bf16, {byte_peak / 1e12:.2f} TB/s")
    ptxas = phase_build(_build)
    fwd_err = phase_kernel_vs_plain(fa)
    timing = phase_timing(fa, flop_peak, byte_peak)
    bwd_err = phase_bwd_vs_plain(fa)
    bwd = phase_bwd_timing(fa, flop_peak, byte_peak)
    phase_parity(model)
    phase_grad_parity(model, train)
    sl = phase_slice(model, serve, fa)
    tr = phase_train(model, train, fa, flop_peak)
    phase_remat(model, train, fa)
    wk = phase_worker(model, train, checkpoint, worker)
    rs = phase_sharded(model, train, fa, bootstrap, mesh_lib, checkpoint, tr)
    sp = phase_sp(model, train, tr)
    mo = phase_moe(model, train, moe, fa, flop_peak)
    pp = phase_pp(model, train, pipeline, fa, bootstrap, tr)
    # the scheduling path launches no kernel in this process (its worker
    # trains the tiny f32 config with flash off, in a process of its own)
    zero_counts(fa)
    sc, plane = phase_schedule(bootstrap)
    sc["wire"] = phase_wire(bootstrap, smi)
    sc["kernel_launches"] = launch_counts(fa)
    # preemption and failover launch none either (the resumed worker
    # trains the tiny f32 config, flash off, in its own process)
    zero_counts(fa)
    sc["preempt"] = phase_preempt(plane, smi)
    del plane
    sc["failover"] = phase_failover(bootstrap, smi)
    sc["preempt_failover_kernel_launches"] = launch_counts(fa)
    # nor do the operator's CLI and the federation tier (their workers
    # run in processes of their own)
    zero_counts(fa)
    sc["cli"] = phase_cli(bootstrap, smi)
    sc["federation"] = phase_federation(bootstrap, smi)
    sc["cli_federation_kernel_launches"] = launch_counts(fa)
    common = {"shape": list(SLICE_SHAPE), "dtype": "bfloat16",
              "causal": True, "card": smi,
              # every case each kernel was held at against its plain version
              "shapes": [list(x) for x in
                         sorted({tuple(c[0]) for c in kernel_cases()})]}
    src = "volcano_tpu/workloads/ops/flash_attention.py"
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "design": "wgmma+tma",
         "source": "volcano_tpu_torch/csrc/flash_fwd.cu",
         "replaces": f"{src}:27", "launches": tr["launches"]["flash_fwd"],
         "launches_serving": sl["launches"], "max_abs_err": fwd_err,
         "ms": timing["ms"], "plain_ms": timing["plain_ms"],
         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
         "library_ms": timing["library_ms"], **common},
        {"name": "flash_bwd_dq", "route": "cuda", "design": "wgmma+tma",
         "source": "volcano_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{src}:102",
         "launches": tr["launches"]["flash_bwd_dq"],
         "max_abs_err": bwd_err["dq"], "delta_max_abs_err": bwd_err["delta"],
         "ms": bwd["dq"]["ms"], "plain_ms": bwd["dq"]["plain_ms"],
         "bound_ms": bwd["dq"]["bound_ms"], "bound_by": bwd["dq"]["bound_by"],
         "library_ms": bwd["library_ms"], **common},
        {"name": "flash_bwd_dkv", "route": "cuda", "design": "wgmma+tma",
         "source": "volcano_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"{src}:144",
         "launches": tr["launches"]["flash_bwd_dkv"],
         "max_abs_err": bwd_err["dkv"], "ms": bwd["dkv"]["ms"],
         "plain_ms": bwd["dkv"]["plain_ms"],
         "bound_ms": bwd["dkv"]["bound_ms"],
         "bound_by": bwd["dkv"]["bound_by"],
         "library_ms": bwd["library_ms"], **common}]
    for kern in kernels:
        # the kernel's time over the PyTorch call's (for dQ and dK/dV each
        # alone against SDPA's whole backward)
        kern["ratio_to_library"] = kern["ms"] / kern["library_ms"]
        # ptxas at the slice's head dim: registers at kernel entry (the
        # warp-specialised kernels' consumers then take 232 by setmaxnreg)
        regs, spill = ptxas.get((kern["name"], SLICE_SHAPE[3]), (None, None))
        kern["registers_at_entry"], kern["spill_bytes"] = regs, spill
    log(f"[slice] forward ms (median of steady forwards) "
        f"{sl['forward_ms']:.3f}")
    log(f"[train] step ms (median of steady steps) {tr['step_ms']:.3f}, "
        f"tokens/s {tr['tokens_per_s']:.1f}, mfu_bf16_dense "
        f"{tr['mfu_bf16_dense']:.4f}")
    for kern in kernels:
        kern["launches_sharded"] = rs["launches"][kern["name"]]
        kern["launches_moe"] = mo["launches"][kern["name"]]
        kern["launches_pp"] = pp["launches"][kern["name"]]
    log(f"[moe] step ms (median of steady steps) {mo['step_ms']:.3f}, "
        f"tokens/s {mo['tokens_per_s']:.1f}, mfu_bf16_dense "
        f"{mo['mfu_bf16_dense']:.4f}; [pp] step ms {pp['step_ms']:.3f}")
    log(json.dumps({"worker": {"card": smi, "phase_worker": wk,
                               "phase_sharded": rs, "phase_sp": sp,
                               "phase_moe": mo, "phase_pp": pp,
                               "phase_schedule": sc}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

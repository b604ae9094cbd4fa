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
phase_train's losses and norms.

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
import shutil
import socket
import subprocess
import sys
import tempfile
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
                               "phase_moe": mo, "phase_pp": pp}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

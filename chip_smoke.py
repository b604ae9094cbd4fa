"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases: (1) the device and its power limit; (2) build the CUDA kernels
from `volcano_tpu_torch/csrc`; (3) hold the flash-forward kernel against
its plain PyTorch version at every shape and dtype it serves; (4) time
the kernel, its plain version and, as a yardstick only,
`scaled_dot_product_attention` at the serving shape; (5) full-width
parity of the model's flash path against its eager attention path in
f32; (6) the serving slice: the flagship d2048-L8 model in bf16 behind
`BatchedServer` at batch 8 x 2048 tokens, with the kernel's launches
counted, then the replica entry point `serve.run`.

Any failure raises, so the exit code is not 0.  Without a GPU it exits
non-zero before printing any result.  The last line is the device
record `{"ok": true, "device": {...}}`; the line before it holds the
kernels' numbers.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time

import torch

# Published peaks (NVIDIA data sheets, dense): (bf16 FLOP/s, bytes/s)
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}
SLICE_SHAPE = (8, 2048, 16, 128)          # b, t, h, d of the serving slice
SLICE_REQUESTS = 40
ATOL_F32 = 1e-4   # f32: the kernel and the plain version differ only in sum order
# bf16 out: both sides compute in f32 and round once to bf16, and one bf16
# step is 2^-8 of the value, so a sum-order difference can move a value
# by one step: 1e-2 absolute plus 1e-2 relative covers it.
TOL_BF16 = 1e-2
ATOL_PARITY = 2e-3  # f32 logits, flash vs eager attention over 2 layers


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


def rand_qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
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


def phase_build(build):
    t0 = time.monotonic()
    build.load_library()
    log(f"[build] kernels built and loaded in {time.monotonic() - t0:.1f} s "
        f"({build.build_dir()})")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


def phase_kernel_vs_plain(fa):
    """Kernel against its plain version for out and lse; returns the
    max out error at the serving shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for shape in ((2, 256, 2, 128), (1, 384, 4, 128),
                          (1, 256, 2, 256)):
                cases.append((shape, dtype, causal))
    cases.append((SLICE_SHAPE, torch.bfloat16, True))
    slice_err = None
    for i, (shape, dtype, causal) in enumerate(cases):
        q, k, v = rand_qkv(shape, dtype, seed=100 + i)
        out, lse = fa._launch(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tag = f"{list(shape)} {str(dtype)[6:]} causal={causal}"
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
        if shape == SLICE_SHAPE:
            slice_err = err
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return slice_err


def phase_timing(fa, flop_peak, byte_peak):
    b, t, h, d = SLICE_SHAPE
    q, k, v = rand_qkv(SLICE_SHAPE, torch.bfloat16, seed=7)
    kernel_ms = cuda_time_ms(lambda: fa._launch(q, k, v, True), iters=20)
    plain_ms = cuda_time_ms(lambda: fa.flash_fwd_plain(q, k, v, True),
                            iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # views, no copy
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20)
    # the causal work this input needs: t(t+1)/2 scores a (batch, head),
    # two products of 2*d FLOP each
    flops = 4.0 * b * h * d * t * (t + 1) / 2
    nbytes = 4 * b * t * h * d * 2 + b * h * t * 4   # q,k,v,out + lse
    op_ms, byte_ms = flops / flop_peak * 1e3, nbytes / byte_peak * 1e3
    bound_ms = max(op_ms, byte_ms)
    bound_by = "operations" if op_ms >= byte_ms else "bytes"
    log(f"[timing] {list(SLICE_SHAPE)} bf16 causal: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops:.4e} FLOP, {nbytes:.4e} B)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_parity(model):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def profile_forward(fwd, batch):
    """Device time of one forward by kernel, from torch.profiler: the
    flash kernel, the matmuls (cuBLAS) and the rest; and the device's
    idle share of the forward's host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fwd(batch)
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if not by_name:
        log("[profile] the profiler saw no device kernels: not measured")
        return
    groups = {"flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_fwd"] += ms
        elif any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    log(f"[profile] one forward: host wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})"
                    for k, v in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, n) in top:
        log(f"[profile]   {ms:9.3f} ms  x{n:<4d} {name[:110]}")


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


def main() -> int:
    # the port first: alone, without the repo, the script fails here
    # before it prints anything
    from volcano_tpu_torch.workloads import model, serve
    from volcano_tpu_torch.workloads.ops import _build
    fa = importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")
    name, smi = phase_device()
    peak_key, (flop_peak, byte_peak) = peaks(name)
    log(f"[device] roofline peaks of {peak_key}: {flop_peak / 1e12:.0f} "
        f"TFLOP/s bf16, {byte_peak / 1e12:.2f} TB/s")
    phase_build(_build)
    slice_err = phase_kernel_vs_plain(fa)
    timing = phase_timing(fa, flop_peak, byte_peak)
    phase_parity(model)
    sl = phase_slice(model, serve, fa)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "volcano_tpu/workloads/ops/flash_attention.py:27",
        "launches": sl["launches"],
        "launches_per_forward": sl["launches"] / sl["forwards"],
        "max_abs_err": slice_err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "shape": list(SLICE_SHAPE), "dtype": "bfloat16", "causal": True,
        "card": smi}]
    log(f"[slice] forward ms (median of steady forwards) "
        f"{sl['forward_ms']:.3f}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

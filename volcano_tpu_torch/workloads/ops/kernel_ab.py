"""Time this tree's flash kernels against another tree's on one card, in
turns, at the flagship's attention shape.

    git archive <commit> volcano_tpu_torch/csrc | tar -x -C build/ab
    python -m volcano_tpu_torch.workloads.ops.kernel_ab build/ab/volcano_tpu_torch/csrc

The other tree's sources are built by nvcc with this tree's flags into
`build/kernel_ab/`; its C functions are bound with the signatures that
came before lse and Delta took a row stride (commit 820bc40 and
earlier).  Each of the forward, dQ and dK/dV kernels of both trees runs
on the same bf16 inputs at [8, 2048, 16, 128] causal; ROUNDS rounds time
other, this, this, other (CUDA events over ITERS launches after a
warm-up), and the script prints one JSON line with every reading, the
card's name and power limit, and the largest difference between the two
trees' outputs.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from volcano_tpu_torch.workloads.ops import _build

# the module (the package's `flash_attention` is the function)
fa = importlib.import_module("volcano_tpu_torch.workloads.ops.flash_attention")

SHAPE = (8, 2048, 16, 128)
ROUNDS = 4
ITERS = 50


def build_other(csrc: Path) -> ctypes.CDLL:
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise FileNotFoundError(f"no *.cu sources under {csrc}")
    out = _build.BUILD_ROOT.parent / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-c",
                               str(src), "-o", str(out / (src.stem + ".o"))],
                              stdout=subprocess.DEVNULL)
             for src in sources]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f"nvcc failed on {csrc}")
    lib_path = out / "libother.so"
    subprocess.run([_build.nvcc(), *_build.ARCH, "-shared", "-o",
                    str(lib_path), *map(str, sorted(out.glob("*.o")))],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vtp_flash_fwd.argtypes = [p] * 5 + [i] * 6 + [i64] * 9 + [p]
    lib.vtp_flash_bwd_dq.argtypes = [p] * 8 + [i] * 6 + [p, p]
    lib.vtp_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [p, p]
    for fn in (lib.vtp_flash_fwd, lib.vtp_flash_bwd_dq,
               lib.vtp_flash_bwd_dkv):
        fn.restype = i
    return lib


def cuda_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(csrc: str) -> None:
    other = build_other(Path(csrc))
    b, t, h, d = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa._launch(q, k, v, True)
    dq, delta = fa._launch_dq(q, k, v, out, do, lse, True)
    dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, True)
    o_out, o_dq, o_dk, o_dv = (torch.empty_like(q) for _ in range(4))
    o_lse, o_delta = (torch.empty((b, h, t), device="cuda")
                      for _ in range(2))
    st = q.stride()[:3]
    strides = (ctypes.c_longlong * 15)(*(st * 5))
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"the other tree's launch failed: {rc}")

    kernels = {
        "flash_fwd": (lambda: check(other.vtp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o_out.data_ptr(),
            o_lse.data_ptr(), b, t, h, d, 1, 1, *st, *st, *st, stream)),
            lambda: fa._launch(q, k, v, True)),
        "flash_bwd_dq": (lambda: check(other.vtp_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), o_delta.data_ptr(),
            o_dq.data_ptr(), b, t, h, d, 1, 1, strides, stream)),
            lambda: fa._launch_dq(q, k, v, out, do, lse, True)),
        "flash_bwd_dkv": (lambda: check(other.vtp_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), o_dk.data_ptr(),
            o_dv.data_ptr(), b, t, h, d, 1, 1, strides, stream)),
            lambda: fa._launch_dkv(q, k, v, do, lse, delta, True)),
    }
    ms = {}
    for name, (run_other, run_this) in kernels.items():
        ms[name] = {"other": [], "this": []}
        for _ in range(ROUNDS):
            for who, fn in (("other", run_other), ("this", run_this),
                            ("this", run_this), ("other", run_other)):
                ms[name][who].append(cuda_ms(fn))
    torch.cuda.synchronize()
    diff = max((a.float() - b.float()).abs().max().item() for a, b in
               ((o_out, out), (o_dq, dq), (o_dk, dk), (o_dv, dv)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "shape": list(SHAPE), "ms": ms,
                      "max_abs_diff": diff}))


if __name__ == "__main__":
    main(sys.argv[1])

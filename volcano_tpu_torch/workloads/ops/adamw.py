"""AdamW's update of each leaf — a hand-written CUDA kernel and its plain
version.

`adamw_leaves(params, grads, mus, nus, clip, scalars)` applies one update
to every leaf in place (the update rule: `train.AdamW`).  On a CUDA leaf
it launches `vtp_adamw` (`volcano_tpu_torch/csrc/adamw.cu`), one fused
pass a leaf; on a CPU leaf it runs `adamw_plain`, the eager ops whose
roundings the kernel repeats one by one, so that on the card the two give
the same p, mu and nu bit for bit.  There is no fallback from the
kernel: a leaf it does not take (a dtype, a shape, a stride, a device)
raises, on the CPU too, as does a failed build or launch.
`adamw_leaves.launches` counts kernel launches.

The clip factor is a 0-dim f32 tensor on the leaves' device, which the
kernel reads through a pointer, so the host never waits for the global
norm.  The step's other scalars are host numbers (`AdamWScalars`); the
kernel takes them as the f32 values the eager ops use.  Among them are
the reciprocals of the bias corrections: PyTorch on CUDA divides a
tensor by a host scalar as a product with the scalar's reciprocal, taken
in double and rounded to f32 (not the reciprocal of the f32 scalar,
which differs by an ulp at some counts: 1 - b2^150, for one).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

# optax's adamw defaults, which the reference's chain uses
B1, B2, EPS = 0.9, 0.999, 1e-8
_MU_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class AdamWScalars:
    """One step's host scalars: the learning rate, the bias corrections
    1 - b1^count and 1 - b2^count, the weight decay, and b1 as stored in
    mu's dtype."""
    lr: float
    bc1: float
    bc2: float
    weight_decay: float
    b1_mu: float


def adamw_plain(p, g, mu, nu, clip, s: AdamWScalars) -> None:
    """One leaf's update in place, one eager op at a time: the CPU path,
    and the kernel's yardstick on the card."""
    g = g * clip
    m = (1 - B1) * g + s.b1_mu * mu
    nu.copy_((1 - B2) * g.square() + B2 * nu)
    u = (m / s.bc1) / ((nu / s.bc2).sqrt() + EPS)
    mu.copy_(m)
    p.sub_(s.lr * (u + s.weight_decay * p))


def kernel_scalars(s: AdamWScalars) -> tuple:
    """The f32 operands of the eager ops, in `vtp_adamw`'s order: 1 - b1,
    b1_mu, 1 - b2, b2, eps, 1 / bc1 and 1 / bc2 (each divided in double,
    then rounded), lr, the weight decay."""
    f32 = np.float32
    return tuple(float(f32(x)) for x in (
        1 - B1, s.b1_mu, 1 - B2, B2, EPS, 1.0 / s.bc1, 1.0 / s.bc2, s.lr,
        s.weight_decay))


def check_leaf(p, g, mu, nu, clip) -> None:
    """Raise unless one leaf is what the kernel takes: p, g and nu f32,
    mu f32 or bf16, all of one shape, contiguous and on p's device, and
    clip one f32 value there."""
    for name, x in (("g", g), ("mu", mu), ("nu", nu), ("clip", clip)):
        if x.device != p.device:
            raise ValueError(f"adamw kernel: {name} lies on {x.device}, p "
                             f"on {p.device}")
    for name, x in (("p", p), ("g", g), ("nu", nu), ("clip", clip)):
        if x.dtype != torch.float32:
            raise ValueError(f"adamw kernel: {name} is {x.dtype}; needs "
                             "float32")
    if mu.dtype not in _MU_CODES:
        raise ValueError(f"adamw kernel: mu is {mu.dtype}; needs float32 "
                         "or bfloat16")
    if not (p.shape == g.shape == mu.shape == nu.shape):
        raise ValueError("adamw kernel: p, g, mu and nu must share one "
                         f"shape; got {[tuple(x.shape) for x in (p, g, mu, nu)]}")
    for name, x in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if not x.is_contiguous():
            raise ValueError(f"adamw kernel: {name} is not contiguous "
                             f"(strides {x.stride()} for shape "
                             f"{tuple(x.shape)})")
    if clip.numel() != 1:
        raise ValueError(f"adamw kernel: clip has {clip.numel()} values; "
                         "needs one")


def _kernel_lib():
    from volcano_tpu_torch.workloads.ops import _build
    lib = _build.load_library()
    if not getattr(lib, "_vtp_adamw_bound", False):
        p = ctypes.c_void_p
        lib.vtp_adamw.argtypes = ([p] * 5 + [ctypes.c_longlong, ctypes.c_int]
                                  + [ctypes.c_float] * 9 + [p])
        lib.vtp_adamw.restype = ctypes.c_int
        lib.vtp_error_string.argtypes = [ctypes.c_int]
        lib.vtp_error_string.restype = ctypes.c_char_p
        lib._vtp_adamw_bound = True
    return lib


def _launch(lib, p, g, mu, nu, clip, scalars: tuple) -> None:
    """Launch the kernel on one CUDA leaf that `check_leaf` passed, on
    PyTorch's current stream; raises on a failed launch."""
    if p.device.type != "cuda":
        raise ValueError(f"adamw kernel: p lies on {p.device}, not on a "
                         "CUDA device")
    with torch.cuda.device(p.device):
        rc = lib.vtp_adamw(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            clip.data_ptr(), p.numel(), _MU_CODES[mu.dtype], *scalars,
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {rc} "
                           f"({lib.vtp_error_string(rc).decode()})")
    adamw_leaves.launches += 1


def adamw_leaves(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 clip: torch.Tensor, s: AdamWScalars) -> None:
    """One update of each (p, g, mu, nu) in place, by p's device: the
    kernel on a CUDA leaf, `adamw_plain` on a CPU leaf.  Every leaf is
    held to the kernel's contract (`check_leaf`) on either device, so the
    CPU runs of each parallel path show that the card takes its leaves."""
    lib = scalars = None
    for p, g, mu, nu in zip(params, grads, mus, nus, strict=True):
        check_leaf(p, g, mu, nu, clip)
        if p.device.type == "cpu":
            adamw_plain(p, g, mu, nu, clip, s)
            continue
        if lib is None:
            lib, scalars = _kernel_lib(), kernel_scalars(s)
        _launch(lib, p, g, mu, nu, clip, scalars)


adamw_leaves.launches = 0

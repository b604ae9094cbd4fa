"""Flash attention forward — the port of
`volcano_tpu.workloads.ops.flash_attention`.

`flash_attention(q, k, v)` keeps the reference's [b, t, h, d] signature
and its dispatch: shapes that `supported()` rejects go to `_reference`
(decided by shape, never by an exception); the others go to
`flash_fwd`, which launches the hand-written CUDA kernel
(`volcano_tpu_torch/csrc/flash_fwd.cu`) on a CUDA tensor and runs its
plain PyTorch version, `flash_fwd_plain`, on a CPU tensor.  There is no
fallback from the kernel: a CUDA tensor the kernel does not take, a
failed build or a failed launch raises.

The block sizes (and the FLASH_BLOCK / FLASH_BLOCK_BWD overrides) decide
the dispatch exactly as in the reference; the CUDA kernel tiles by its
own 64-row q and k tiles, which divide every supported t.

Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

NEG_INF = -1e30

# what the CUDA kernel takes: head dims (a multiple of 128, at most
# 256) and the q/k tile both of its instantiations divide t by
KERNEL_HEAD_DIMS = (128, 256)
KERNEL_SEQ_MULTIPLE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_block(t: int, cap: int = 512) -> int:
    """Largest power-of-two block in [128, cap] dividing t.  For t not
    divisible by 128 this returns 128 and the caller falls back to the
    reference path via supported()."""
    b = 128
    while b * 2 <= cap and t % (b * 2) == 0:
        b *= 2
    return b


def supported(t: int, d: int, block_q: int = 128,
              block_k: int = 128) -> bool:
    return t % block_q == 0 and t % block_k == 0 and d % 128 == 0


def _env_block(name: str, t: int, fallback: int) -> int:
    """Block-size override from the environment (FLASH_BLOCK for the
    forward pair, FLASH_BLOCK_BWD for the backward pair)."""
    raw = os.environ.get(name, "")
    if raw:
        try:
            b = int(raw)
            if t % b == 0:
                return b
        except ValueError:
            pass
    return fallback


def _reference(q, k, v, causal: bool):
    """Plain softmax attention in f32, cast back to the input dtype."""
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) / torch.sqrt(
        torch.tensor(float(q.shape[-1]), device=q.device))
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_fwd_plain(q, k, v, causal: bool = True):
    """The kernel's function in plain PyTorch: q/k/v [b, t, h, d] ->
    (out [b, t, h, d] in the input dtype, lse [b, h, t] f32).

    The same f32 arithmetic as the TPU kernel, in one pass instead of
    blockwise: scale rsqrt(d) in f32, masked scores -1e30, masked p
    exactly 0, the l == 0 guard, lse = m + log l."""
    d = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # b,h,t,d
    scale = torch.rsqrt(torch.tensor(float(d), device=q.device))
    s = (qf @ kf.transpose(-1, -2)) * scale                    # b,h,t,t
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = ((p @ vf) / safe_l).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _kernel_lib():
    from volcano_tpu_torch.workloads.ops import _build
    lib = _build.load_library()
    if not getattr(lib, "_vtp_flash_fwd_bound", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vtp_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i] + \
            [i64] * 9 + [p]
        lib.vtp_flash_fwd.restype = i
        lib.vtp_error_string.argtypes = [i]
        lib.vtp_error_string.restype = ctypes.c_char_p
        lib._vtp_flash_fwd_bound = True
    return lib


def _check_kernel_inputs(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_fwd kernel: {name} lies on {x.device}, "
                             "not on a CUDA device")
        if x.device != q.device:
            raise ValueError("flash_fwd kernel: q, k and v lie on "
                             "different devices")
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_fwd kernel: dtypes {q.dtype}, "
                             f"{k.dtype}, {v.dtype}; needs all float32 or "
                             "all bfloat16")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError("flash_fwd kernel: q, k, v must share one "
                             f"[b, t, h, d] shape; got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        align = 16 // x.element_size()
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"flash_fwd kernel: {name} needs a unit stride over d, the "
                f"other strides a multiple of {align} elements and a "
                f"16-byte aligned start; got strides {x.stride()}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_fwd kernel: the backward kernels are not ported yet; "
            "call it under torch.no_grad() or torch.inference_mode()")
    _, t, _, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if t % KERNEL_SEQ_MULTIPLE:
        raise ValueError(f"flash_fwd kernel: t={t} is not a multiple of "
                         f"{KERNEL_SEQ_MULTIPLE}")


def _launch(q, k, v, causal: bool):
    """Launch the CUDA kernel on PyTorch's current stream; raises on
    anything the kernel does not take, on a failed build and on a
    failed launch."""
    _check_kernel_inputs(q, k, v)
    b, t, h, d = q.shape
    lib = _kernel_lib()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vtp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, d, _DTYPE_CODES[q.dtype], int(causal),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: CUDA error {rc} "
            f"({lib.vtp_error_string(rc).decode()})")
    flash_fwd.launches += 1
    return out, lse


def flash_fwd(q, k, v, causal: bool = True):
    """q/k/v [b, t, h, d] -> (out [b, t, h, d], lse [b, h, t] f32): the
    CUDA kernel on a CUDA tensor, `flash_fwd_plain` on a CPU tensor.
    `flash_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


flash_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None):
    """Flash attention; q/k/v: [b, t, h, d] -> [b, t, h, d].  Block
    sizes default to the largest power-of-two divisor of t up to 512
    (see default_block), with the FLASH_BLOCK / FLASH_BLOCK_BWD env
    overrides, and decide whether the kernel path is taken."""
    b, t, h, d = q.shape
    if block_q is None:
        block_q = _env_block("FLASH_BLOCK", t, default_block(t))
    if block_k is None:
        block_k = _env_block("FLASH_BLOCK", t, default_block(t))
    if block_q_bwd is None:
        block_q_bwd = _env_block("FLASH_BLOCK_BWD", t, block_q)
    if block_k_bwd is None:
        block_k_bwd = _env_block("FLASH_BLOCK_BWD", t, block_k)
    if not supported(t, d, block_q, block_k) or \
            not supported(t, d, block_q_bwd, block_k_bwd):
        # fallback honors the causal flag (the reference expression)
        return _reference(q, k, v, causal)
    return flash_fwd(q, k, v, causal)[0]

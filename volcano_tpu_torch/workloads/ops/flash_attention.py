"""Flash attention — the port of `volcano_tpu.workloads.ops.flash_attention`.

`flash_attention(q, k, v)` keeps the reference's [b, t, h, d] signature
and its dispatch: shapes that `supported()` rejects go to `_reference`
(decided by shape, never by an exception) and are differentiated by
autograd; the others go through `_FlashAttention`, the counterpart of
the reference's custom VJP.  Its forward is `flash_fwd` and its backward
`flash_bwd`.  On a CUDA tensor these launch the hand-written kernels
(`volcano_tpu_torch/csrc/flash_fwd.cu`, `flash_bwd.cu`); on a CPU tensor
they run their plain PyTorch versions, `flash_fwd_plain` and
`flash_bwd_plain` (`flash_bwd_dq_plain` is the dQ kernel's own, with
the Delta it writes).  There is no fallback from a kernel: a CUDA tensor
the kernel does not take (a dtype, a stride, a device), a failed build
or a failed launch raises.  The kernels take every shape `supported()`
admits at any block (`kernel_supported`): any t, with a partial last
tile where their own tiles do not divide it, and any head dim that is a
multiple of 128 (d = 128 and 256 on the wgmma kernels, the others on
CUDA-core kernels).

The block sizes (and the FLASH_BLOCK / FLASH_BLOCK_BWD overrides) decide
the dispatch exactly as in the reference; the CUDA kernels tile by their
own 32- to 128-row tiles.

lse and Delta are [b, h, t] f32 with a row stride that is a multiple of
4 (the dK/dV kernel loads them by TMA, which needs 16-byte rows): for
t % 4 != 0 the kernels write them into a padded buffer and the wrappers
return a [b, h, t] view of it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

NEG_INF = -1e30

# the head dims the CUDA kernels take are the multiples of this
KERNEL_HEAD_DIM_MULTIPLE = 128
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


def kernel_supported(t: int, d: int) -> bool:
    """Whether the CUDA kernels take sequence length t and head dim d:
    every non-empty shape that `supported()` admits at some block."""
    return t > 0 and d > 0 and d % KERNEL_HEAD_DIM_MULTIPLE == 0


def rows_stride(t: int) -> int:
    """The row stride of the kernels' lse and Delta [b, h, t]: t rounded
    up to a multiple of 4 floats (16 bytes, for TMA)."""
    return (t + 3) // 4 * 4


def _rows(b: int, h: int, t: int, device):
    """An f32 [b, h, t] view with row stride `rows_stride(t)`."""
    return torch.empty((b, h, rows_stride(t)), dtype=torch.float32,
                       device=device)[..., :t]


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


def _plain_bwd_terms(q, k, v, out, lse, do, causal: bool):
    """The f32 terms both backward kernels share, in one pass: q, k and
    do as [b, h, t, d] f32, scale, Delta = rowsum(dO * O) [b, h, t],
    P = exp(S - lse) with masked p exactly 0, and dS = P * (dP - Delta)
    with dP = dO V^T ([b, h, t, t])."""
    d = q.shape[-1]
    qf, kf, vf, of, dof = (x.float().transpose(1, 2)
                           for x in (q, k, v, out, do))     # b,h,t,d
    scale = torch.rsqrt(torch.tensor(float(d), device=q.device))
    delta = (dof * of).sum(dim=-1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    return qf, kf, dof, scale, delta, p, ds


def flash_bwd_plain(q, k, v, out, lse, do, causal: bool = True):
    """The backward kernels' function in plain PyTorch: q/k/v/out/do
    [b, t, h, d], lse [b, h, t] f32 as `flash_fwd` writes it ->
    (dq, dk, dv) [b, t, h, d] in q's dtype.

    The arithmetic of the reference's `_flash_bh_bwd` and its two
    kernels in f32, in one pass instead of blockwise: Delta =
    rowsum(dO * O), P = exp(S - lse) with masked p exactly 0,
    dP = dO V^T, dS = P * (dP - Delta), dQ = scale dS K,
    dK = scale dS^T Q and dV = P^T dO."""
    qf, kf, dof, scale, _, p, ds = _plain_bwd_terms(q, k, v, out, lse, do,
                                                    causal)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ dof
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def flash_bwd_dq_plain(q, k, v, out, do, lse, causal: bool = True):
    """The dQ kernel's function in plain PyTorch: q/k/v/out/do
    [b, t, h, d], lse [b, h, t] f32 -> (dq [b, t, h, d] in q's dtype,
    delta [b, h, t] f32 contiguous).

    The f32 arithmetic of the reference's `_bwd_dq_kernel` in one pass,
    dQ = scale dS K, with Delta = rowsum(dO * O) as `_flash_bh_bwd`
    computes it."""
    _, kf, _, scale, delta, _, ds = _plain_bwd_terms(q, k, v, out, lse, do,
                                                     causal)
    dq = (ds @ kf) * scale
    return dq.transpose(1, 2).to(q.dtype), delta.contiguous()


def _kernel_lib():
    from volcano_tpu_torch.workloads.ops import _build
    lib = _build.load_library()
    if not getattr(lib, "_vtp_bound", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vtp_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [i64] * 9 + [p]
        lib.vtp_flash_bwd_dq.argtypes = [p] * 8 + [i] * 7 + [p, p]
        lib.vtp_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [p, p]
        for fn in (lib.vtp_flash_fwd, lib.vtp_flash_bwd_dq,
                   lib.vtp_flash_bwd_dkv):
            fn.restype = i
        lib.vtp_error_string.argtypes = [i]
        lib.vtp_error_string.restype = ctypes.c_char_p
        lib._vtp_bound = True
    return lib


def _check_kernel_inputs(kernel: str, **xs) -> None:
    """Raise unless the [b, t, h, d] tensors `xs` (the first one sets
    device, dtype and shape) are what the CUDA kernels take."""
    names = ", ".join(xs)
    first = next(iter(xs.values()))
    for name, x in xs.items():
        if x.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} lies on {x.device}, "
                             "not on a CUDA device")
        if x.device != first.device:
            raise ValueError(f"{kernel} kernel: {names} lie on different "
                             "devices")
        if x.dtype != first.dtype or x.dtype not in _DTYPE_CODES:
            raise ValueError(f"{kernel} kernel: dtypes "
                             f"{[str(y.dtype) for y in xs.values()]}; "
                             "needs all float32 or all bfloat16")
        if x.dim() != 4 or x.shape != first.shape:
            raise ValueError(f"{kernel} kernel: {names} must share one "
                             "[b, t, h, d] shape; got "
                             f"{[tuple(y.shape) for y in xs.values()]}")
        align = 16 // x.element_size()
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{kernel} kernel: {name} needs a unit stride over d, the "
                f"other strides a multiple of {align} elements and a "
                f"16-byte aligned start; got strides {x.stride()}")
    _, t, _, d = first.shape
    if not kernel_supported(t, d):
        raise ValueError(
            f"{kernel} kernel: t={t}, head dim {d}; the kernels take t >= 1 "
            f"and head dims that are positive multiples of "
            f"{KERNEL_HEAD_DIM_MULTIPLE}")


def _check_rows(kernel: str, ref, **xs) -> int:
    """lse and Delta: f32 [b, h, t] on ref's device, unit stride over t,
    one row stride ld (a multiple of 4, at least t, rows packed: the
    kernels load them by TMA) and a 16-byte aligned start; returns ld."""
    b, t, h, _ = ref.shape
    lds = set()
    for name, x in xs.items():
        ld = x.stride(1) if x.dim() == 3 else 0
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, t) or \
                x.device != ref.device or x.stride() != (h * ld, ld, 1) or \
                ld % 4 or ld < t or x.data_ptr() % 16:
            raise ValueError(
                f"{kernel} kernel: {name} must be a float32 [{b}, {h}, {t}] "
                f"tensor on {ref.device} with strides ({h} ld, ld, 1) for "
                f"an ld >= {t} that is a multiple of 4, and a 16-byte "
                f"aligned start; got {x.dtype} {tuple(x.shape)} strides "
                f"{x.stride()} on {x.device}")
        lds.add(ld)
    if len(lds) > 1:
        raise ValueError(f"{kernel} kernel: {', '.join(xs)} must share one "
                         f"row stride; got {sorted(lds)}")
    return lds.pop()


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {rc} "
            f"({lib.vtp_error_string(rc).decode()})")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(q, k, v, causal: bool):
    """Launch the forward kernel on PyTorch's current stream; raises on
    anything the kernel does not take, on a failed build and on a
    failed launch."""
    _check_kernel_inputs("flash_fwd", q=q, k=k, v=v)
    b, t, h, d = q.shape
    lib = _kernel_lib()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = _rows(b, h, t, q.device)
    with torch.cuda.device(q.device):
        rc = lib.vtp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, d, rows_stride(t), _DTYPE_CODES[q.dtype],
            int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _stream(q))
    _raise_on(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_fwd(q, k, v, causal: bool = True):
    """q/k/v [b, t, h, d] -> (out [b, t, h, d], lse [b, h, t] f32): the
    CUDA kernel on a CUDA tensor (lse a view with row stride
    `rows_stride(t)`), `flash_fwd_plain` on a CPU tensor.
    `flash_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


flash_fwd.launches = 0


def _bwd_args(kernel: str, tensors: dict, rows: dict, causal: bool):
    """The arguments both backward kernels share, after their checks:
    the pointers of the [b, t, h, d] `tensors` (q first) and then of the
    f32 [b, h, t] `rows`, in order; the dims and the rows' stride; the
    tensors' strides."""
    _check_kernel_inputs(kernel, **tensors)
    q = tensors["q"]
    ld = _check_rows(kernel, q, **rows)
    b, t, h, d = q.shape
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for x in tensors.values() for s in x.stride()[:3]))
    return ([x.data_ptr() for x in (*tensors.values(), *rows.values())],
            (b, t, h, d, ld, _DTYPE_CODES[q.dtype], int(causal)), strides)


def _launch_dq(q, k, v, out, do, lse, causal: bool):
    """Launch the dQ kernel on PyTorch's current stream -> (dq, delta):
    dq [b, t, h, d] and Delta = rowsum(dO * O) [b, h, t] f32 (with lse's
    row stride), which the kernel computes for the dK/dV kernel; raises
    as `_launch` does."""
    ins, dims, strides = _bwd_args(
        "flash_bwd_dq", dict(q=q, k=k, v=v, do=do, out=out),
        dict(lse=lse), causal)
    b, t, h, _ = q.shape
    lib = _kernel_lib()
    delta = torch.empty((b, h, lse.stride(1)), dtype=torch.float32,
                        device=q.device)[..., :t]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.vtp_flash_bwd_dq(*ins, delta.data_ptr(), dq.data_ptr(),
                                  *dims, strides, _stream(q))
    _raise_on(lib, rc, "flash_bwd_dq")
    flash_bwd.launches_dq += 1
    return dq, delta


def _launch_dkv(q, k, v, do, lse, delta, causal: bool):
    """Launch the dK/dV kernel on PyTorch's current stream -> (dk, dv);
    raises as `_launch` does."""
    ins, dims, strides = _bwd_args(
        "flash_bwd_dkv", dict(q=q, k=k, v=v, do=do),
        dict(lse=lse, delta=delta), causal)
    lib = _kernel_lib()
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.vtp_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                   *dims, strides, _stream(q))
    _raise_on(lib, rc, "flash_bwd_dkv")
    flash_bwd.launches_dkv += 1
    return dk, dv


def bwd_delta(out, do):
    """Delta = rowsum(dO * O) in f32 as [b, h, t] contiguous, the
    reference's jnp glue (`_flash_bh_bwd`): the plain version of the
    Delta that the dQ kernel writes."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_bwd(q, k, v, out, lse, do, causal: bool = True):
    """-> (dq, dk, dv) [b, t, h, d] in q's dtype: on a CUDA tensor the dQ
    kernel, which also writes Delta, then the dK/dV kernel on that
    Delta; on a CPU tensor `flash_bwd_plain`.  `flash_bwd.launches_dq`
    and `flash_bwd.launches_dkv` count kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, causal)
    dq, delta = _launch_dq(q, k, v, out, do, lse, causal)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


flash_bwd.launches_dq = 0
flash_bwd.launches_dkv = 0


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's `_flash` custom VJP: forward
    `flash_fwd`, saving q, k, v, out and lse; backward `flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None):
    """Flash attention; q/k/v: [b, t, h, d] -> [b, t, h, d].
    Differentiable (`_FlashAttention`).  Block sizes default to the
    largest power-of-two divisor of t up to 512 (see default_block),
    with the FLASH_BLOCK / FLASH_BLOCK_BWD env overrides, and decide
    whether the kernel path is taken."""
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
    return _FlashAttention.apply(q, k, v, causal)

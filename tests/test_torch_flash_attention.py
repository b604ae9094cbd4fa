"""The port's flash attention (volcano_tpu_torch) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Inputs come from numpy and go to both sides.  On a CPU tensor the port
runs the kernel's plain PyTorch version; the CUDA kernel itself is held
against that plain version on the GPU by chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("volcano_tpu.workloads.ops.flash_attention")
tfa = importlib.import_module(
    "volcano_tpu_torch.workloads.ops.flash_attention")

ATOL = 2e-5   # the JAX package's own flash tolerance (f32, sum order)


def _qkv(b=2, t=256, h=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("causal,t", [(True, 256), (False, 128),
                                      (True, 512)])
def test_flash_matches_jax_interpret(causal, t):
    q, k, v = _qkv(t=t, seed=t)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True)
    out = tfa.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_jax_flash_bh(causal):
    b, t, h, d = 2, 256, 2, 128
    q, k, v = _qkv(b, t, h, d, seed=3)

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    ref_out, ref_lse = jfa._flash_bh(bh(q), bh(k), bh(v), block_q=128,
                                     block_k=128, causal=causal,
                                     interpret=True)
    out, lse = tfa.flash_fwd_plain(*_torch(q, k, v), causal)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.reshape(b * h, t).numpy(),
                               np.asarray(ref_lse)[..., 0], atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jfa._from_bh(ref_out, b, h)), atol=ATOL,
        rtol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_unsupported_shapes_fall_back(causal):
    q, k, v = _qkv(t=96, d=64, seed=5)      # not block-aligned
    assert not tfa.supported(96, 64)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              interpret=True)
    out = tfa.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_bf16_inputs():
    """bf16 in, bf16 out; held against the f32 JAX kernel on the same
    (bf16-rounded) values: both compute in f32 and the port rounds once
    to bf16, so the difference is at most one bf16 step (2^-8 of the
    value) -- 1e-2 absolute plus 1e-2 relative."""
    q, k, v = _qkv(seed=7)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    ref = jfa.flash_attention(*(jnp.asarray(x.float().numpy())
                                for x in (tq, tk, tv)), interpret=True)
    out = tfa.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=1e-2, rtol=1e-2)


def test_block_helpers_match_jax(monkeypatch):
    for t in (64, 96, 128, 256, 384, 512, 768, 1024, 2048, 4096):
        for cap in (128, 256, 512, 1024):
            assert tfa.default_block(t, cap) == jfa.default_block(t, cap)
    for t in (96, 128, 256, 384, 2048):
        for d in (64, 128, 192, 256):
            for bq, bk in ((128, 128), (256, 128), (512, 512)):
                assert tfa.supported(t, d, bq, bk) == \
                    jfa.supported(t, d, bq, bk)
    for raw in ("", "128", "256", "384", "abc", "0x80"):
        for t, fb in ((512, 512), (768, 256), (2048, 512)):
            if raw:
                monkeypatch.setenv("FLASH_BLOCK", raw)
            else:
                monkeypatch.delenv("FLASH_BLOCK", raising=False)
            assert tfa._env_block("FLASH_BLOCK", t, fb) == \
                jfa._env_block("FLASH_BLOCK", t, fb)


def test_cpu_path_launches_nothing():
    before = tfa.flash_fwd.launches
    q, k, v = _qkv(t=128, seed=9)
    tfa.flash_attention(*_torch(q, k, v))
    tfa.flash_fwd(*_torch(q, k, v))
    assert tfa.flash_fwd.launches == before


def test_cuda_launcher_refuses_cpu_tensors():
    q, k, v = _torch(*_qkv(t=128, seed=11))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tfa._launch(q, k, v, True)


def test_kernels_take_every_default_dispatched_shape():
    """Every t in 128..8192 and head dim that the dispatch sends to
    `_FlashAttention` at the default blocks is one the CUDA kernels take,
    so no default shape turns into a refused launch."""
    taken = 0
    for t in range(128, 8192 + 1, 128):
        blk = tfa.default_block(t)
        for d in (128, 256, 384, 512):
            if tfa.supported(t, d, blk, blk):
                assert tfa.kernel_supported(t, d), (t, d)
                taken += 1
    assert taken == 4 * 64


@pytest.mark.parametrize("causal", [True, False])
def test_d256_fwd_and_bwd_match_jax_interpret(causal):
    """flash_fwd and flash_bwd at d = 256 on CPU tensors: the plain
    versions, no launch, against `_flash_bh` and `_flash_bh_bwd` in
    interpret mode."""
    b, t, h, d = 1, 128, 2, 256
    rng = np.random.default_rng(13)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    counts = (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
              tfa.flash_bwd.launches_dkv)
    out, lse = tfa.flash_fwd(*_torch(q, k, v), causal)
    grads = tfa.flash_bwd(*_torch(q, k, v), out, lse, torch.from_numpy(do),
                          causal)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
            tfa.flash_bwd.launches_dkv) == counts
    ref_out, ref_lse = jfa._flash_bh(bh(q), bh(k), bh(v), block_q=128,
                                     block_k=128, causal=causal,
                                     interpret=True)
    ref = jfa._flash_bh_bwd(bh(q), bh(k), bh(v), ref_out, ref_lse, bh(do),
                            block_q=128, block_k=128, causal=causal,
                            interpret=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jfa._from_bh(ref_out, b, h)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.reshape(b * h, t).numpy(),
                               np.asarray(ref_lse)[..., 0], atol=ATOL,
                               rtol=ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jfa._from_bh(want, b, h)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)


def test_fused_qkv_views_match_contiguous():
    """q/k/v (and dO) as strided views of one fused [b, t, 3, h, d]
    tensor, the layout whose strides the kernels' TMA maps are held
    against on the GPU, give what contiguous copies give."""
    rng = np.random.default_rng(17)
    fused = torch.from_numpy(
        rng.standard_normal((2, 128, 3, 2, 128)).astype(np.float32))
    q, k, v = fused.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * 2 * 128
    do = torch.from_numpy(
        rng.standard_normal((2, 128, 3, 2, 128)).astype(np.float32))[:, :, 1]
    out, lse = tfa.flash_fwd(q, k, v)
    want_out, want_lse = tfa.flash_fwd(*(x.contiguous() for x in (q, k, v)))
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    got = tfa.flash_bwd(q, k, v, out, lse, do)
    want = tfa.flash_bwd(*(x.contiguous() for x in (q, k, v)), out, lse,
                         do.contiguous())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_rows_check_refuses_unaligned_start():
    """lse and Delta reach the kernels by TMA, which needs a 16-byte
    aligned start: a view one float in is refused before any launch."""
    q = torch.zeros((1, 128, 2, 128))
    rows = torch.zeros(1 * 2 * 128 + 1)
    tfa._check_rows("flash_bwd", q, lse=rows[:-1].view(1, 2, 128))
    with pytest.raises(ValueError, match="16-byte aligned start"):
        tfa._check_rows("flash_bwd", q, lse=rows[1:].view(1, 2, 128))


# -- shapes beyond d in {128, 256} and t % 128 == 0 -------------------------

UNCOVERED = [  # (shape, the FLASH_BLOCK override)
    ((1, 256, 2, 384), None),
    ((1, 192, 2, 128), "64"),
    ((1, 256, 2, 512), None),
    ((1, 96, 2, 128), "32"),
]
UNCOVERED_IDS = ["d384", "t192_block64", "d512", "t96_block32"]


def test_kernel_supported_predicate():
    """kernel_supported(t, d) holds exactly where supported() holds at
    some block pair (a block of t itself, or FLASH_BLOCK dividing t)."""
    for t in range(1, 300):
        for d in range(64, 1025, 64):
            admitted = any(tfa.supported(t, d, b, b)
                           for b in range(1, t + 1) if t % b == 0)
            assert tfa.kernel_supported(t, d) == admitted, (t, d)
    assert tfa.supported(256, 384) and tfa.kernel_supported(256, 384)
    assert tfa.supported(192, 128, 64, 64) and tfa.kernel_supported(192, 128)
    assert not tfa.kernel_supported(256, 64)


def test_rows_stride_pads_to_16_bytes():
    """lse and Delta rows: t rounded up to a multiple of 4 floats, and
    the row check takes such a padded view and refuses a contiguous
    [b, h, t] whose rows are not 16-byte multiples."""
    assert [tfa.rows_stride(t) for t in (1, 4, 96, 197, 200)] == \
        [4, 4, 96, 200, 200]
    q = torch.zeros((1, 197, 2, 128))
    padded = torch.zeros((1, 2, 200))[..., :197]
    assert tfa._check_rows("flash_bwd", q, lse=padded, delta=padded) == 200
    with pytest.raises(ValueError, match="multiple of 4"):
        tfa._check_rows("flash_bwd", q, lse=torch.zeros((1, 2, 197)))
    with pytest.raises(ValueError, match="share one row stride"):
        tfa._check_rows("flash_bwd", q, lse=padded,
                        delta=torch.zeros((1, 2, 204))[..., :197])


@pytest.mark.parametrize("shape,block", UNCOVERED, ids=UNCOVERED_IDS)
def test_uncovered_shapes_on_cpu_match_the_reference(shape, block,
                                                     monkeypatch):
    """A shape beyond d in {128, 256} and t % 128 == 0 goes through
    `_FlashAttention` as every admitted shape does: on a CPU tensor its
    plain versions compute it, equal to the reference package's Pallas
    kernel in interpret mode, with the gradients of the reference
    expression.  (On a CUDA tensor it launches the kernels:
    tests/test_torch_gpu.py and chip_smoke.py.)"""
    if block:
        monkeypatch.setenv("FLASH_BLOCK", block)
    b, t, h, d = shape
    q, k, v = _qkv(b, t, h, d, seed=t + d)
    calls = []
    apply = tfa._FlashAttention.apply
    monkeypatch.setattr(tfa._FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    tq, tk, tv = (x.requires_grad_() for x in _torch(q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    assert calls == [1]
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=ATOL)
    grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
    ref_grads = torch.autograd.grad(
        tfa._reference(tq, tk, tv, True).sum(), (tq, tk, tv))
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,block", UNCOVERED, ids=UNCOVERED_IDS)
def test_uncovered_shapes_fwd_and_bwd_match_jax_interpret(shape, block,
                                                          causal):
    """flash_fwd and flash_bwd on CPU tensors at the shapes the kernels
    gained (d = 384 and 512, t an odd multiple of 64 under 64-row blocks,
    t = 96 under 32-row blocks): the plain versions, no launch, against
    the reference's `_flash_bh` and `_flash_bh_bwd` Pallas kernels in
    interpret mode at the blocks its dispatch would take."""
    b, t, h, d = shape
    blk = int(block) if block else tfa.default_block(t)
    rng = np.random.default_rng(t + d + causal)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    counts = (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
              tfa.flash_bwd.launches_dkv)
    out, lse = tfa.flash_fwd(*_torch(q, k, v), causal)
    grads = tfa.flash_bwd(*_torch(q, k, v), out, lse, torch.from_numpy(do),
                          causal)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
            tfa.flash_bwd.launches_dkv) == counts
    ref_out, ref_lse = jfa._flash_bh(bh(q), bh(k), bh(v), block_q=blk,
                                     block_k=blk, causal=causal,
                                     interpret=True)
    ref = jfa._flash_bh_bwd(bh(q), bh(k), bh(v), ref_out, ref_lse, bh(do),
                            block_q=blk, block_k=blk, causal=causal,
                            interpret=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jfa._from_bh(ref_out, b, h)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.reshape(b * h, t).numpy(),
                               np.asarray(ref_lse)[..., 0], atol=ATOL,
                               rtol=ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jfa._from_bh(want, b, h)),
                                   atol=ATOL, rtol=ATOL, err_msg=name)

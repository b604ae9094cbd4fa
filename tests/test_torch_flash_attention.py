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

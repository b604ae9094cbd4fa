"""The port's flash-attention backward (volcano_tpu_torch) against the
JAX package's Pallas backward kernels, run in interpret mode on the CPU.

Inputs come from numpy and go to both sides.  On a CPU tensor the
port's `_FlashAttention` runs the kernels' plain PyTorch versions
(`flash_fwd_plain`, `flash_bwd_plain`; `flash_bwd_dq_plain` is the dQ
kernel's own, with the Delta it writes); the CUDA kernels themselves are
held against those plain versions on the GPU by chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.workloads.ring_attention import local_causal_attention

jfa = importlib.import_module("volcano_tpu.workloads.ops.flash_attention")
tfa = importlib.import_module(
    "volcano_tpu_torch.workloads.ops.flash_attention")

# the JAX package's own gradient tolerance for its flash backward
# (tests/test_flash_attention.py): f32 on both sides, sums in another
# order and through a tanh
ATOL_GRAD = 2e-4
# f32 arithmetic of one kernel pass against the other: sum order only
ATOL_PLAIN = 2e-5
# bf16 gradients against f32 ones on the same (bf16-rounded) inputs:
# the port rounds out and each gradient once to bf16 (one step is 2^-8
# of the value), so 1e-2 absolute plus 1e-2 relative
TOL_BF16 = 1e-2


def _arrays(n, b=2, t=256, h=2, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(n)]


def _leaf(x):
    return torch.from_numpy(x).requires_grad_(True)


def _torch_grads(q, k, v, **kw):
    tq, tk, tv = map(_leaf, (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    return out, torch.autograd.grad(torch.tanh(out).sum(), (tq, tk, tv))


def _jax_grads(q, k, v, **kw):
    def f(q, k, v):
        return jnp.sum(jnp.tanh(jfa.flash_attention(q, k, v, **kw)))
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _assert_grads(got, want, atol):
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol, rtol=atol, err_msg=f"d{name}")


def _is_flash_node(out) -> bool:
    return type(out.grad_fn).__name__ == "_FlashAttentionBackward"


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_matches_jax_flash_bh_bwd(causal):
    """flash_bwd_plain against the Pallas kernels `_flash_bh_bwd` runs,
    both given the JAX forward's out and lse."""
    b, t, h, d = 2, 256, 2, 128
    q, k, v, do = _arrays(4, b, t, h, d, seed=1)

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    out, lse = jfa._flash_bh(bh(q), bh(k), bh(v), block_q=128,
                             block_k=128, causal=causal, interpret=True)
    ref = jfa._flash_bh_bwd(bh(q), bh(k), bh(v), out, lse, bh(do),
                            block_q=128, block_k=128, causal=causal,
                            interpret=True)
    got = tfa.flash_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(jfa._from_bh(out, b, h))),
        torch.from_numpy(np.array(lse).reshape(b, h, t)),
        torch.from_numpy(do), causal)
    _assert_grads(got, [jfa._from_bh(x, b, h) for x in ref], ATOL_PLAIN)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_dq_matches_jax_flash_bh_bwd(causal):
    """flash_bwd_dq_plain (the dQ kernel's plain version) against the
    dq of the Pallas kernels `_flash_bh_bwd` runs, both given the JAX
    forward's out and lse, and its Delta against the reference's
    expression in `_flash_bh_bwd`; f32, ATOL_PLAIN (sum order only)."""
    b, t, h, d = 2, 256, 2, 128
    q, k, v, do = _arrays(4, b, t, h, d, seed=11)

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    out, lse = jfa._flash_bh(bh(q), bh(k), bh(v), block_q=128,
                             block_k=128, causal=causal, interpret=True)
    ref_dq = jfa._flash_bh_bwd(bh(q), bh(k), bh(v), out, lse, bh(do),
                               block_q=128, block_k=128, causal=causal,
                               interpret=True)[0]
    ref_delta = jnp.sum(bh(do).astype(jnp.float32) * out.astype(jnp.float32),
                        axis=-1).reshape(b, h, t)
    dq, delta = tfa.flash_bwd_dq_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(jfa._from_bh(out, b, h))),
        torch.from_numpy(do),
        torch.from_numpy(np.array(lse).reshape(b, h, t)), causal)
    assert dq.shape == (b, t, h, d) and dq.dtype == torch.float32
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    np.testing.assert_allclose(dq.numpy(),
                               np.asarray(jfa._from_bh(ref_dq, b, h)),
                               atol=ATOL_PLAIN, rtol=ATOL_PLAIN)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta),
                               atol=ATOL_PLAIN, rtol=ATOL_PLAIN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_dq_agrees_with_plain_bwd(dtype):
    """The dQ kernel's plain version gives flash_bwd_plain's dq and
    bwd_delta's Delta exactly: the same f32 arithmetic."""
    q, k, v, out, do = (torch.from_numpy(x).to(dtype)
                        for x in _arrays(5, t=128, seed=12))
    _, lse = tfa.flash_fwd_plain(q, k, v)
    dq, delta = tfa.flash_bwd_dq_plain(q, k, v, out, do, lse)
    assert torch.equal(dq, tfa.flash_bwd_plain(q, k, v, out, lse, do)[0])
    assert torch.equal(delta, tfa.bwd_delta(out, do))


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_interpret(causal):
    """The counterpart of test_flash_attention.py's
    test_backward_kernels_match_autodiff: grad of sum(tanh(flash)),
    the port's Function against the JAX custom VJP's Pallas kernels."""
    q, k, v = _arrays(3, seed=2)
    out, got = _torch_grads(q, k, v, causal=causal)
    assert _is_flash_node(out)
    _assert_grads(got, _jax_grads(q, k, v, causal=causal,
                                  interpret=True), ATOL_GRAD)


@pytest.mark.parametrize("kw", [
    {"block_q_bwd": 128, "block_k_bwd": 256},
    {"block_q_bwd": 256, "block_k_bwd": 128},
    {"env": "128"},
], ids=["bwd128x256", "bwd256x128", "env128"])
def test_backward_blocks_decoupled_from_forward(kw, monkeypatch):
    """Mismatched backward blocks at t = 512 and the FLASH_BLOCK_BWD
    override (test_flash_attention.py's cases): the dispatch still takes
    the Function, and the gradients match JAX's at the same blocks."""
    kw = dict(kw)
    if "env" in kw:
        monkeypatch.setenv("FLASH_BLOCK_BWD", kw.pop("env"))
        assert tfa._env_block("FLASH_BLOCK_BWD", 512, 512) == 128
    q, k, v = _arrays(3, t=512, h=1, seed=3)
    out, got = _torch_grads(q, k, v, **kw)
    assert _is_flash_node(out)
    _assert_grads(got, _jax_grads(q, k, v, interpret=True, **kw),
                  ATOL_GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_unsupported_shape_grads_through_reference(causal):
    q, k, v = _arrays(3, t=96, d=64, seed=4)
    assert not tfa.supported(96, 64)
    out, got = _torch_grads(q, k, v, causal=causal)
    assert not _is_flash_node(out)
    _assert_grads(got, _jax_grads(q, k, v, causal=causal,
                                  interpret=True), ATOL_GRAD)


def test_grads_match_local_causal_attention():
    """The flash gradients against autodiff of the JAX package's eager
    attention, as the reference's own test holds its kernels."""
    q, k, v = _arrays(3, seed=5)
    _, got = _torch_grads(q, k, v)

    def fr(q, k, v):
        return jnp.sum(jnp.tanh(local_causal_attention(q, k, v)))
    want = jax.grad(fr, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _assert_grads(got, want, ATOL_GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_grads_within_one_bf16_step(causal):
    q, k, v, do = _arrays(4, seed=6)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert _is_flash_node(out) and out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal,
                                            interpret=True),
        *(jnp.asarray(x.detach().float().numpy()) for x in (tq, tk, tv)))
    want = vjp(jnp.asarray(tdo.float().numpy()))
    _assert_grads(got, want, TOL_BF16)


def test_delta_matches_reference_glue():
    b, t, h, d = 2, 128, 3, 128
    out, do = _arrays(2, b, t, h, d, seed=7)
    got = tfa.bwd_delta(torch.from_numpy(out), torch.from_numpy(do))
    assert got.shape == (b, h, t) and got.is_contiguous()
    want = np.einsum("bthd,bthd->bht", do, out)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_PLAIN,
                               rtol=ATOL_PLAIN)


def test_no_grad_calls_record_nothing():
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, t=128, seed=8))
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert tfa.flash_attention(q, k, v).grad_fn is None


def test_cpu_path_launches_nothing():
    counts = (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
              tfa.flash_bwd.launches_dkv)
    q, k, v = _arrays(3, t=128, seed=9)
    _torch_grads(q, k, v)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
            tfa.flash_bwd.launches_dkv) == counts


@pytest.mark.parametrize("launcher", ["_launch_dq", "_launch_dkv"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    b, t, h, d = 1, 128, 2, 128
    q, k, v, out, do = (torch.from_numpy(x)
                        for x in _arrays(5, b, t, h, d, 10))
    rows = torch.zeros((b, h, t))
    args = {"_launch_dq": (q, k, v, out, do, rows),       # ..., out, do, lse
            "_launch_dkv": (q, k, v, do, rows, rows)}     # ..., do, lse, delta
    with pytest.raises(ValueError, match="not on a CUDA device"):
        getattr(tfa, launcher)(*args[launcher], True)

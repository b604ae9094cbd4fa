"""The port's decoder LM (volcano_tpu_torch) against the JAX model on
the CPU.  Params come from the JAX init through `params_from_jax`;
tokens and activations from numpy."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.workloads import model as jm
from volcano_tpu_torch.workloads import convert
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads.device import resolve_device


def _params(jcfg, seed=0):
    jp = jm.init_params(jax.random.key(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm_parity(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = jm._rms_norm(jx, jnp.asarray(scale))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    tx = tx.to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    out = tm._rms_norm(tx, torch.from_numpy(scale))
    assert out.dtype == tx.dtype
    # f32: sum order only; bf16: both round once to bf16 (one step)
    tol = 1e-6 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [16, 128])
def test_rotary_parity(d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 3, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None, :], (2, 32)).astype(np.int32)
    ref = jm._rotary(jnp.asarray(x), jnp.asarray(pos))
    out = tm._rotary(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    # cos/sin of angles up to 31 rad differ by an ulp between libraries
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seed,b,t", [(0, 2, 16), (1, 3, 32)])
def test_tiny_config_logits_match_jax(seed, b, t):
    jcfg = jm.tiny_config()
    jp, tp = _params(jcfg, seed)
    toks = _tokens(jcfg, b, t, seed)
    ref = jm.forward(jp, jnp.asarray(toks), jcfg)
    out = tm.forward(tp, torch.from_numpy(toks), tm.tiny_config())
    assert out.shape == (b, t, jcfg.vocab_size)
    # f32 through 2 layers: matmul sum order on two libraries
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_flash_model_matches_jax_interpret():
    """head_dim 128, t 128: both sides take the flash path (JAX's Pallas
    kernel in interpret mode, patched in as its own test does; the
    port's plain version on the CPU)."""
    jcfg = jm.tiny_config(d_model=256, n_heads=2, use_flash_attention=True)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 128)
    import volcano_tpu.workloads.ops as ops
    orig = ops.flash_attention
    try:
        ops.flash_attention = \
            lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
        ref = jm.forward(jp, jnp.asarray(toks), jcfg)
    finally:
        ops.flash_attention = orig
    tfa = importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")
    before = tfa.flash_fwd.launches
    out = tm.forward(tp, torch.from_numpy(toks),
                     tm.tiny_config(d_model=256, n_heads=2,
                                    use_flash_attention=True))
    assert tfa.flash_fwd.launches == before      # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=5e-4)


def test_bf16_tiny_forward():
    """bf16 activations, held against the JAX bf16 forward and the port's
    own f32 forward.  bf16 keeps 8 significant bits and the two libraries
    round at different places through 2 layers (ROADMAP queue C), so on
    logits of magnitude up to ~4 the tolerance is 0.1 absolute (observed
    ~0.04 against JAX, ~0.06 against f32)."""
    jcfg = jm.tiny_config(dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 16)
    ref = np.asarray(jm.forward(jp, jnp.asarray(toks), jcfg)
                     .astype(jnp.float32))
    out = tm.forward(tp, torch.from_numpy(toks),
                     tm.tiny_config(dtype=torch.bfloat16))
    f32 = tm.forward(tp, torch.from_numpy(toks), tm.tiny_config())
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.1, rtol=0)
    np.testing.assert_allclose(out.float().numpy(), f32.numpy(), atol=0.1,
                               rtol=0)


def test_forward_with_aux_is_zero_for_dense():
    cfg = tm.tiny_config()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 8))
    logits, aux = tm.forward_with_aux(params, toks, cfg)
    assert float(aux) == 0.0
    assert torch.equal(logits, tm.forward(params, toks, cfg))
    module = tm.DecoderLM(cfg, params)
    assert torch.equal(module(toks), logits)
    assert set(module.state_dict()) >= {"embed", "head", "blocks.0.wq"}


def test_init_params_layout_matches_jax():
    jcfg = jm.tiny_config(n_layers=3)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), jcfg))
    tp = tm.init_params(tm.tiny_config(n_layers=3),
                        torch.Generator().manual_seed(0), "cpu")
    assert set(tp) == set(jp) and len(tp["blocks"]) == len(jp["blocks"])
    for name in ("embed", "final_norm", "head"):
        assert tuple(tp[name].shape) == jp[name].shape
    for tb, jb in zip(tp["blocks"], jp["blocks"]):
        assert {k: tuple(v.shape) for k, v in tb.items()} == \
            {k: v.shape for k, v in jb.items()}
        assert all(v.dtype == torch.float32 for v in tb.values())


def test_params_from_jax_widens_bf16():
    jp = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                      jm.init_params(jax.random.key(0), jm.tiny_config()))
    tp = convert.params_from_jax(jp)
    assert tp["embed"].dtype == torch.float32
    np.testing.assert_array_equal(tp["blocks"][1]["wq"].numpy(),
                                  jp["blocks"][1]["wq"].astype(np.float32))


def test_moe_raises_not_implemented():
    cfg = tm.tiny_config(n_experts=4)
    with pytest.raises(NotImplementedError):
        tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = tm.init_params(tm.tiny_config(),
                            torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        tm.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)


def test_resolve_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")

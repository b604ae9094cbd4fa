"""The port's training step (volcano_tpu_torch.workloads.train) against
the JAX package's optax-based one, on the CPU.

Params come from the JAX init through `params_from_jax`; tokens, logits
and gradients from numpy; optimizer state starts at zeros on both sides.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch import entry as tentry
from volcano_tpu_torch.workloads import convert
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt

tfa = importlib.import_module(
    "volcano_tpu_torch.workloads.ops.flash_attention")

# loss and grad_norm: f32 through 2 layers on two libraries, sum order
# only
RTOL_METRIC = 1e-5
# params after a step move by lr * u with |u| ~ 1: Adam divides each
# gradient by its own size (sqrt(nu)), so an element whose gradient is
# 1e-5 of its leaf's largest turns the libraries' f32 sum-order
# difference (~1e-6 of the largest) into a few percent of its step
# (observed up to 5.4e-2 of lr on the flash config, 99.9% of elements
# within 1.5e-3, means within 5e-5).  So every element is held to a
# quarter of a step (a wrong sign, schedule, clip or bias correction
# moves elements by whole steps), 99.9% of each leaf to 1e-2 of a step
# and its mean to 2e-4, beside f32 rounding of the params themselves;
# the gradients themselves are held to 1e-5 of each leaf's largest.
PARAM_STEP_MAX = 0.25
PARAM_STEP_Q999 = 1e-2
PARAM_STEP_MEAN = 2e-4
GRAD_SHARE = 1e-5
RTOL_PARAM = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(vocab, b, t, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


def _flat(tree):
    """(name, array) pairs of a param-structured tree, torch or numpy."""
    out = [(k, tree[k]) for k in tree if k != "blocks"]
    for i, blk in enumerate(tree.get("blocks", ())):
        out += [(f"blocks.{i}.{k}", blk[k]) for k in blk]
    return out


def _assert_params(tp, jp, lr, step_max=PARAM_STEP_MAX):
    want = dict(_flat(_np_tree(jp)))
    got = _flat(tp)
    assert {k for k, _ in got} == set(want)
    for name, x in got:
        y = np.asarray(want[name], np.float32)
        diff = np.abs(x.detach().float().numpy() - y)
        slack = RTOL_PARAM * np.abs(y)
        assert np.all(diff <= step_max * lr + slack), \
            (name, float(diff.max()))
        over = diff - slack
        assert np.quantile(over, 0.999) <= PARAM_STEP_Q999 * lr, name
        assert over.mean() <= PARAM_STEP_MEAN * lr, \
            (name, float(over.mean()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_next_token_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 17, 64))).astype(np.float32)
    toks = _tokens(64, 3, 17)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    ref = jm.next_token_loss(jl, jnp.asarray(toks))
    got = tm.next_token_loss(tl, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    # both upcast the same values to f32 inside the reduction
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_loss_fn_matches_jax():
    jcfg = jm.tiny_config()
    jp = jm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    toks = _tokens(jcfg.vocab_size, 2, 32)
    ref = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks)},
                     tm.tiny_config())
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_METRIC)


@pytest.mark.parametrize("lr,warmup", [(3e-4, 100), (1e-2, 1), (1e-3, 0)])
def test_schedule_matches_optax(lr, warmup):
    counts = np.arange(0, 12_001)
    ref = np.asarray(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, 10_000, end_value=lr * 0.1)(jnp.asarray(counts)))
    sched = tt.warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000,
                                            end_value=lr * 0.1)
    got = np.array([sched(int(c)) for c in counts])
    # optax evaluates in f32, the port in double: a few f32 ulps of lr
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=lr * 1e-6)
    assert got[0] == 0.0 if warmup else got[0] == lr


def _random_tree(rng, scale):
    shapes = {"embed": (16, 8), "final_norm": (8,), "head": (8, 16),
              "blocks": [{"attn_norm": (8,), "wq": (8, 8)},
                         {"attn_norm": (8,), "wq": (8, 8)}]}

    def draw(shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    out = {k: draw(v) for k, v in shapes.items() if k != "blocks"}
    out["blocks"] = [{k: draw(v) for k, v in blk.items()}
                     for blk in shapes["blocks"]]
    return out


def _to_torch(tree):
    return tt.tree_map(torch.from_numpy, {
        **{k: np.array(v) for k, v in tree.items() if k != "blocks"},
        "blocks": [{k: np.array(v) for k, v in blk.items()}
                   for blk in tree["blocks"]]})


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_optimizer_updates_match_optax(mu_dtype):
    """Four updates from zero state: lr(0) = 0 first, grads of global
    norm above 1 (clipped) and below it (not clipped)."""
    rng = np.random.default_rng(3)
    params = _random_tree(rng, 1.0)
    grads = [_random_tree(rng, s) for s in (0.5, 0.01, 2.0, 0.003)]
    assert optax.global_norm(grads[0]) > 1 and \
        optax.global_norm(grads[1]) < 1
    lr = 1e-2
    jopt = jt.make_optimizer(lr=lr, warmup_steps=1, mu_dtype=None
                             if mu_dtype is None else jnp.bfloat16)
    topt = tt.make_optimizer(lr=lr, warmup_steps=1, mu_dtype=None
                             if mu_dtype is None else torch.bfloat16)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = _to_torch(params)
    tstate = topt.init(tparams)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = topt.update(tparams, _to_torch(g), tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=RTOL_METRIC)
        _assert_params(tparams, jparams, lr)
        if i == 0:      # lr(0) = 0: the first update leaves params as is
            for (_, x), (_, y) in zip(_flat(tparams), _flat(params)):
                assert np.array_equal(x.numpy(), y)
    adam = jstate[1][0]
    assert tstate["count"] == int(adam.count) == len(grads)
    # mu in bf16 is rounded once from f32 on each side: one bf16 step
    mu_tol = 2 ** -8 if mu_dtype else 1e-6
    for (name, x), (_, y) in zip(_flat(tstate["mu"]), _flat(adam.mu)):
        assert x.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32),
                                   rtol=mu_tol, atol=1e-9, err_msg=name)
    for (name, x), (_, y) in zip(_flat(tstate["nu"]), _flat(adam.nu)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("flash", [False, True])
def test_grads_match_jax(flash, monkeypatch):
    """value_and_grad of loss_fn against jax.value_and_grad, leaf by
    leaf; the flash config through JAX's Pallas kernels in interpret
    mode."""
    kw = dict(d_model=256, n_heads=2, use_flash_attention=flash)
    if flash:
        _interpret_flash(monkeypatch)
    jcfg = jm.tiny_config(**kw)
    jp = jm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    toks = _tokens(jcfg.vocab_size, 2, 128)
    jl, jg = jax.value_and_grad(jm.loss_fn)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tg = tt.value_and_grad(tp, {"tokens": torch.from_numpy(toks)},
                               tm.tiny_config(**kw))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_METRIC)
    want = dict(_flat(_np_tree(jg)))
    for name, g in _flat(tg):
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_SHARE * np.abs(w).max(),
                                   err_msg=name)


def _interpret_flash(monkeypatch):
    """Run the JAX model's flash attention in interpret mode, patched in
    as tests/test_flash_attention.py does."""
    import volcano_tpu.workloads.ops as jops
    orig = jops.flash_attention
    monkeypatch.setattr(jops, "flash_attention", lambda *a, **kw: orig(
        *a, **{**kw, "interpret": True}))


def _three_steps(jcfg, tcfg, t, lr=1e-2, step_max=PARAM_STEP_MAX):
    """Three train steps on both sides from the same params and batch,
    compared after each step (`step_max`: `_assert_params`' bound on
    every element, in steps)."""
    jp = jm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    toks = _tokens(jcfg.vocab_size, 2, t)
    jopt = jt.make_optimizer(lr=lr, warmup_steps=1)
    topt = tt.make_optimizer(lr=lr, warmup_steps=1)
    jstep = jax.jit(functools.partial(jt.train_step, cfg=jcfg,
                                      optimizer=jopt))
    tstep = tt.make_train_step(tcfg, topt)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks).long()}
    for step in range(3):
        jp, jstate, jm_ = jstep(jp, jstate, jbatch)
        before = [x.detach().clone() for _, x in _flat(tp)]
        tp, tstate, tm_ = tstep(tp, tstate, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=RTOL_METRIC, err_msg=key)
        _assert_params(tp, jp, lr, step_max)
        same = all(torch.equal(a, x) for a, (_, x) in zip(before, _flat(tp)))
        assert same == (step == 0)      # lr(0) = 0, then lr(1) = lr


@pytest.mark.parametrize("remat", [False, True])
def test_three_train_steps_match_jax(remat):
    _three_steps(jm.tiny_config(remat=remat), tm.tiny_config(remat=remat),
                 t=32)


def test_three_flash_train_steps_match_jax_interpret(monkeypatch):
    """head_dim 128, t 128: both sides take the flash path, the JAX one
    through its Pallas forward and backward kernels in interpret mode
    (patched in as tests/test_flash_attention.py does), the port through
    `_FlashAttention` and the kernels' plain versions."""
    _interpret_flash(monkeypatch)
    counts = (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
              tfa.flash_bwd.launches_dkv)
    kw = dict(d_model=256, n_heads=2, use_flash_attention=True)
    _three_steps(jm.tiny_config(**kw), tm.tiny_config(**kw), t=128)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches_dq,
            tfa.flash_bwd.launches_dkv) == counts     # CPU: plain versions


@pytest.mark.parametrize("flash", [False, True])
def test_remat_grads_equal_non_remat(flash):
    """Recomputing each block in the backward runs the same ops on the
    same values, so the gradients are identical, but for the embedding's:
    its scatter-add on the CPU sums rows in an order that varies from
    run to run (as between two runs without remat), so that leaf is held
    to 1e-6 of its largest gradient."""
    kw = dict(d_model=256, n_heads=2, use_flash_attention=True) \
        if flash else {}
    cfg = tm.tiny_config(**kw)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 2,
                               128 if flash else 32)
    loss, grads = tt.value_and_grad(params, batch, cfg)
    loss_r, grads_r = tt.value_and_grad(params, batch,
                                        tm.tiny_config(remat=True, **kw))
    assert torch.equal(loss, loss_r)
    for (name, a), (_, b) in zip(_flat(grads), _flat(grads_r)):
        if name == "embed":
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-6 * float(a.abs().max()))
        else:
            assert torch.equal(a, b), name


def test_synthetic_batch():
    cfg = tm.tiny_config()
    batch = tt.synthetic_batch(torch.Generator().manual_seed(0), cfg, 3, 40)
    toks = batch["tokens"]
    assert toks.shape == (3, 40) and toks.dtype == torch.int64
    assert toks.device.type == "cpu"
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size


class _TensorParallelMesh:
    """What the forward reads of a mesh, with tp = sp = 2: the axis names
    and sizes, each axis's group (a stand-in string) and this rank's
    coordinate on sp."""
    mesh_dim_names = ("dp", "fsdp", "tp", "sp")
    shape = (1, 1, 2, 2)
    ndim = 4

    def get_group(self, axis):
        return f"group:{axis}"

    def get_local_rank(self, axis):
        return {"tp": 0, "sp": 1}[axis]


def test_mesh_raises_not_implemented():
    """tp and sp are ported (tests/test_torch_sharded.py,
    tests/test_torch_sp.py): a mesh with tp = sp = 2 raises no
    NotImplementedError, and the forward's axes take its tp and sp
    groups, their sizes and this rank's block of the sequence."""
    ax = tm._Axes(_TensorParallelMesh())
    assert (ax.fsdp, ax.tp, ax.sp) == (None, "group:tp", "group:sp")
    assert (ax.tp_size, ax.sp_size, ax.sp_rank) == (2, 2, 1)
    one = tm._Axes()
    assert (one.sp, one.sp_size, one.sp_rank) == (None, 1, 0)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tentry.entry, tentry.train_entry):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
    fwd, args = tentry.entry(device="cpu")
    out = fwd(*args)
    assert out.shape == (4, 128, 256) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    step, (params, state, batch) = tentry.train_entry(device="cpu")
    before = [x.clone() for _, x in _flat(params)]
    params, state, metrics = step(params, state, batch)
    assert np.isfinite(float(metrics["loss"])) and \
        np.isfinite(float(metrics["grad_norm"]))
    assert state["count"] == 1
    assert all(torch.equal(a, x) for a, (_, x) in zip(before,
                                                      _flat(params)))

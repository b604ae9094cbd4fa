"""The AdamW update's wrapper (`volcano_tpu_torch.workloads.ops.adamw`) on
the CPU: CPU leaves take the plain loop and need no `nvcc`, every leaf is
held to the kernel's contract on either device, and `train.AdamW`
hands the wrapper every leaf with the step's scalars.  The kernel itself
runs only on the card (`tests/test_torch_gpu.py`, marked `gpu`)."""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt
from volcano_tpu_torch.workloads.ops import _build
from volcano_tpu_torch.workloads.ops import adamw as ao

SHAPES = [(1,), (7,), (4096,), (4099,), (33, 65)]


def _leaves(seed, mu_dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    p = [torch.randn(s, generator=gen) for s in SHAPES]
    g = [torch.randn(s, generator=gen) * 1e-2 for s in SHAPES]
    mu = [(torch.randn(s, generator=gen) * 1e-3).to(mu_dtype) for s in SHAPES]
    nu = [torch.rand(s, generator=gen) * 1e-5 for s in SHAPES]
    return p, g, mu, nu


def _scalars(count, mu_dtype=torch.float32):
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=2, mu_dtype=mu_dtype)
    return ao.AdamWScalars(opt.schedule(count - 1), 1 - ao.B1 ** count,
                           1 - ao.B2 ** count, opt.weight_decay, opt._b1_mu)


def _no_nvcc(monkeypatch):
    def refuse(*_):
        raise AssertionError("the CPU path built or loaded the kernels")
    monkeypatch.setattr(_build, "nvcc", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16],
                         ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("count,clip", [(1, 1.0), (7, 0.37)],
                         ids=["lr0_unclipped", "warm_clipped"])
def test_cpu_leaves_take_the_plain_loop_without_nvcc(mu_dtype, count, clip,
                                                     monkeypatch):
    _no_nvcc(monkeypatch)
    p, g, mu, nu = _leaves(0, mu_dtype)
    want = [[x.clone() for x in xs] for xs in (p, mu, nu)]
    s, c = _scalars(count, mu_dtype), torch.tensor(clip)
    before = ao.adamw_leaves.launches
    ao.adamw_leaves(p, g, mu, nu, c, s)
    for wp, gi, wm, wn in zip(want[0], g, want[1], want[2]):
        ao.adamw_plain(wp, gi, wm, wn, c, s)
    for got, w in zip((p, mu, nu), want):
        for a, b in zip(got, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert ao.adamw_leaves.launches == before
    if count == 1:             # lr(0) = 0 leaves the params as they were
        assert all(torch.equal(a, b) for a, b in zip(p, _leaves(0)[0]))


def test_the_plain_loop_is_optax_adamw_by_hand():
    """One leaf against the update written out in float64 numpy from
    optax's definitions: the f32 loop agrees to f32 rounding, a few ulps
    of each array's largest value (m and the step cancel near zero)."""
    p, g, mu, nu = (x[3] for x in _leaves(1))
    s, clip = _scalars(7), 0.37
    p64, g64, mu64, nu64 = (x.double().numpy() for x in (p, g, mu, nu))
    g64 = g64 * clip
    m = ao.B1 * mu64 + (1 - ao.B1) * g64
    v = ao.B2 * nu64 + (1 - ao.B2) * g64 ** 2
    u = (m / s.bc1) / (np.sqrt(v / s.bc2) + ao.EPS)
    p64 = p64 - s.lr * (u + s.weight_decay * p64)
    ao.adamw_plain(p, g, mu, nu, torch.tensor(clip), s)
    for got, want in ((mu, m), (nu, v), (p, p64)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_kernel_scalars_are_the_eager_ops_f32_operands():
    """What the kernel is handed: each operand as f32, b1 in mu's dtype,
    and the bias corrections' reciprocals as PyTorch on CUDA takes them
    where a tensor is divided by a host scalar: in double, then rounded
    to f32.  At count 7 (bc1 = 1 - 0.9^7) and 150 (bc2 = 1 - 0.999^150)
    the reciprocal of the f32 scalar is an ulp away (read on an H100,
    torch 2.11: `x / bc` equals `x * float(1 / bc)` at every element)."""
    f32 = np.float32
    for count, mu_dtype in ((7, torch.bfloat16), (150, torch.float32)):
        s = _scalars(count, mu_dtype)
        got = ao.kernel_scalars(s)
        assert got == (float(f32(1 - ao.B1)), s.b1_mu,
                       float(f32(1 - ao.B2)), float(f32(ao.B2)),
                       float(f32(ao.EPS)), float(f32(1 / s.bc1)),
                       float(f32(1 / s.bc2)), float(f32(s.lr)),
                       float(f32(s.weight_decay)))
        assert all(float(f32(x)) == x for x in got)
    assert _scalars(7, torch.bfloat16).b1_mu == 0.8984375
    assert f32(1 / (1 - ao.B1 ** 7)) != f32(1) / f32(1 - ao.B1 ** 7)
    assert f32(1 / (1 - ao.B2 ** 150)) != f32(1) / f32(1 - ao.B2 ** 150)


def _faulty(fault):
    p, g, mu, nu = (x[4] for x in _leaves(2))
    clip = torch.tensor(1.0)
    if fault == "strided_p":
        p = torch.randn(65, 33).t()
    elif fault == "strided_nu":
        nu = torch.rand(65, 33).t()
    elif fault == "bf16_g":
        g = g.bfloat16()
    elif fault == "f64_p":
        p = p.double()
    elif fault == "bf16_nu":
        nu = nu.bfloat16()
    elif fault == "f16_mu":
        mu = mu.half()
    elif fault == "shape_g":
        g = g.reshape(65, 33)
    elif fault == "shape_mu":
        mu = mu.flatten()
    elif fault == "clip_two":
        clip = torch.ones(2)
    elif fault == "clip_f64":
        clip = clip.double()
    elif fault == "g_on_meta":
        g = torch.empty(g.shape, device="meta")
    return p, g, mu, nu, clip


FAULTS = ["strided_p", "strided_nu", "bf16_g", "f64_p", "bf16_nu", "f16_mu",
          "shape_g", "shape_mu", "clip_two", "clip_f64", "g_on_meta"]


@pytest.mark.parametrize("fault", FAULTS)
def test_check_leaf_refuses_what_the_kernel_cannot_take(fault):
    with pytest.raises(ValueError, match="adamw kernel"):
        ao.check_leaf(*_faulty(fault))


@pytest.mark.parametrize("fault", ["strided_p", "bf16_g", "shape_mu"])
def test_a_faulty_cpu_leaf_raises_before_the_update(fault):
    """The contract holds on the CPU too, so a path whose leaves the card
    would refuse fails in the CPU tests; the faulty leaf is left as it
    was."""
    p, g, mu, nu, clip = _faulty(fault)
    p0 = p.clone()
    with pytest.raises(ValueError, match="adamw kernel"):
        ao.adamw_leaves([p], [g], [mu], [nu], clip, _scalars(7))
    assert torch.equal(p, p0)


def test_the_kernel_launch_refuses_a_cpu_leaf():
    p, g, mu, nu = (x[0] for x in _leaves(3))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ao._launch(None, p, g, mu, nu, torch.tensor(1.0),
                   ao.kernel_scalars(_scalars(2)))


def test_leaf_lists_of_unequal_length_raise():
    p, g, mu, nu = _leaves(4)
    with pytest.raises(ValueError):
        ao.adamw_leaves(p, g[:-1], mu, nu, torch.tensor(1.0), _scalars(2))


@pytest.mark.parametrize("cfg,mu_dtype", [
    (tm.tiny_config(), None), (tm.tiny_config(), torch.bfloat16),
    (tm.tiny_config(n_experts=4, moe_capacity_factor=1.5), None)],
    ids=["dense", "dense_mu_bf16", "moe"])
def test_update_hands_every_leaf_to_the_wrapper(cfg, mu_dtype, monkeypatch):
    """Two train steps: `AdamW.update` calls `adamw_leaves` once a step
    with every leaf (the local tensors, each passing `check_leaf`), the
    clip factor as a 0-dim tensor and the step's scalars."""
    calls = []
    wrapped = ao.adamw_leaves

    def record(ps, gs, mus, nus, clip, s):
        calls.append((len(ps), clip, s))
        return wrapped(ps, gs, mus, nus, clip, s)

    monkeypatch.setattr(ao, "adamw_leaves", record)
    opt = tt.make_optimizer(warmup_steps=1, mu_dtype=mu_dtype)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 2, 16)
    step = tt.make_train_step(cfg, opt)
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    n = len(list(tt.leaves(params)))
    assert [c[0] for c in calls] == [n, n]
    assert all(c[1].dim() == 0 and c[1].dtype == torch.float32
               for c in calls)
    first, second = calls[0][2], calls[1][2]
    assert (first.lr, second.lr) == (0.0, opt.schedule(1))
    assert (first.bc1, second.bc2) == (1 - ao.B1, 1 - ao.B2 ** 2)
    assert first.b1_mu == opt._b1_mu
    assert state["count"] == 2

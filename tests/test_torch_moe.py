"""Mixture-of-experts in the port (volcano_tpu_torch.workloads.moe and the
model's MoE blocks) against the JAX package's, on the CPU: the params
and their specs, `moe_mlp` alone in both dispatches, top-k ties, the
tiny MoE model's loss and train steps in one process, and the sharded
step with expert parallelism on 4 gloo ranks against JAX's meshes.
"""

import json
import math
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from test_torch_sp import _assert_ranks_match, _jax_mesh, _jax_step
from test_torch_train import _flat, _np_tree, _three_steps, _tokens
from test_torch_worker import (PROC_TIMEOUT_S, RANK_TIMEOUT_S, REPO,
                               rank_env)
from torch_procs import rendezvous
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import moe as jmoe
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch.workloads import convert
from volcano_tpu_torch.workloads import mesh as tmesh
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import moe as tmoe
from volcano_tpu_torch.workloads import train as tt

# moe_mlp in f32 against the reference: the same einsums and sums in
# another order (measured: at most 2.9e-6 on values of order 1)
ATOL = 1e-5
E = 4
# the bound on every param element after a step, in steps: Adam divides
# each gradient by its own size, so an element whose gradient is
# sum-order noise on both sides takes a step of either sign.  At
# capacity 1.5 one element of blocks.0.wo, whose gradient is 1e-8
# against its leaf's largest 0.14 (9.5e-9 here, -1.7e-8 in JAX), moved
# by 0.34 of a step after step 2, past the dense tests' quarter; Adam's
# bias-corrected update is at most about one step, so that is the bound
# (a wrong sign moves elements by two), beside the rule's 99.9% and
# mean bounds, which are kept
MOE_STEP_MAX = 1.0


def _stub(axes):
    names = tmesh.HYBRID_AXES if "dcn" in axes else tmesh.AXES
    return types.SimpleNamespace(mesh_dim_names=names,
                                 shape=tuple(axes.get(a, 1) for a in names))


# -- params and their specs ----------------------------------------------

@pytest.mark.parametrize("axes,n_experts,promoted", [
    ({"fsdp": 2, "tp": 2}, 4, False),
    ({"dcn": 2, "fsdp": 2}, 4, True),
    ({"dcn": 2, "fsdp": 2}, 2, False)],
    ids=["flat", "dcn2_fsdp2_E4", "dcn2_fsdp2_E2"])
def test_moe_params_and_specs_match_reference(axes, n_experts, promoted):
    """Odd blocks are MoE with the reference's leaf shapes; every leaf's
    spec equals the reference's PartitionSpec on the same mesh, with the
    expert dim promoted to (dcn, fsdp) on a hybrid mesh when the expert
    count divides over dcn x fsdp (E = 4) and not otherwise (E = 2); the
    placements shard the expert dim over both axes when promoted."""
    kw = dict(n_experts=n_experts, n_layers=2)
    tparams = tm.init_params(tm.tiny_config(**kw),
                             torch.Generator().manual_seed(0), "cpu")
    jparams = jm.init_params(jax.random.key(0), jm.tiny_config(**kw))
    assert "router" not in tparams["blocks"][0]
    assert "w_gate" not in tparams["blocks"][1]
    for name, x in _flat(tparams):
        assert tuple(x.shape) == dict(_flat(jparams))[name].shape, name
    assert tuple(tparams["blocks"][1]["moe_gate"].shape) == (n_experts, 64,
                                                             128)
    want = dict(_flat(jm.param_specs(jparams, _jax_mesh(axes))))
    mesh = _stub(axes)
    got = dict(_flat(tm.param_specs(tparams, mesh)))
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == tuple(want[name]), name
    gate = got["blocks.1.moe_gate"]
    assert gate[0] == (("dcn", "fsdp") if promoted else "fsdp")
    assert tm.expert_axes(n_experts, mesh) == \
        (("dcn", "fsdp") if promoted else ("fsdp",))
    places = dict(_flat(tm.param_shardings(tparams, mesh)))
    for axis, place in zip(mesh.mesh_dim_names, places["blocks.1.moe_gate"]):
        sharded = axis == "fsdp" or (promoted and axis == "dcn")
        assert place == (Shard(0) if sharded else
                         Shard(2) if axis == "tp" else Replicate()), \
            axis
    # the router's leading dim is d_model: it never names dcn
    assert got["blocks.1.router"] == ("fsdp", None)


def test_dense_model_has_no_moe_leaves_and_decoder_accepts_moe():
    cfg = tm.tiny_config(n_experts=E)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lm = tm.DecoderLM(cfg, params)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 2, 16)).long()
    logits, aux = tm.forward_with_aux(params, tokens, cfg)
    assert torch.equal(lm(tokens), logits)
    # uniform routing floor of the aux loss is 1.0
    assert float(aux) >= 1.0 - 1e-3
    dense = tm.init_params(tm.tiny_config(), torch.Generator().manual_seed(0),
                           "cpu")
    assert all("router" not in blk for blk in dense["blocks"])


# -- moe_mlp alone ----------------------------------------------------------

def _inputs(seed=0, b=2, t=16, d=8, f=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    blk = {"router": rng.standard_normal((d, E)).astype(np.float32),
           "moe_gate": 0.3 * rng.standard_normal((E, d, f)).astype(np.float32),
           "moe_up": 0.3 * rng.standard_normal((E, d, f)).astype(np.float32),
           "moe_down": 0.3 * rng.standard_normal((E, f, d)).astype(np.float32)}
    w = rng.standard_normal((b, t, d)).astype(np.float32)
    return x, blk, w


def _both(x, blk, w, k, cf):
    """moe_mlp on both sides: (y, aux, grads of sum(y * w) + aux by x and
    each leaf), JAX's then the port's, as numpy."""
    def jloss(x, blk):
        y, aux = jmoe.moe_mlp(x, blk, E, k, cf)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in blk.items()})
    tx = torch.tensor(x, requires_grad=True)
    tb = {n: torch.tensor(v, requires_grad=True) for n, v in blk.items()}
    ty, taux = tmoe.moe_mlp(tx, tb, E, k, cf)
    tg = torch.autograd.grad((ty * torch.from_numpy(w)).sum() + taux,
                             [tx, *tb.values()])
    want = [np.asarray(jy), float(jaux), np.asarray(jg[0])] + \
        [np.asarray(jg[1][n]) for n in tb]
    got = [ty.detach().numpy(), float(taux)] + [g.numpy() for g in tg]
    return want, got


@pytest.mark.parametrize("cf", [0.0, 1.5, 0.5], ids=["dense", "cf1.5",
                                                     "cf0.5_drops"])
@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_moe_mlp_matches_jax(k, cf):
    """`moe_mlp` in f32 against the reference's on the same inputs:
    the output, the aux loss and the gradients of x and of the router
    and every expert leaf, within 1e-5.  cf 0.5 drops tokens (capacity
    of 2 slots a row at k = 1, 4 at k = 2, for 16 tokens)."""
    x, blk, w = _inputs()
    want, got = _both(x, blk, w, k, cf)
    names = ["y", "aux", "dx", *blk]
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
    if cf == 0.5:
        # some token was dropped: its output is exactly zero
        assert np.any(np.all(got[0] == 0, axis=-1))


def test_top_k_ties_resolve_as_jax():
    """Tied values come out lower index first, as `jax.lax.top_k` gives
    them, in f32 and in bf16."""
    probs = np.array([[0.25, 0.25, 0.3, 0.2, 0.3, 0.2],
                      [0.1, 0.1, 0.1, 0.1, 0.3, 0.3]], np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        for k in (1, 2, 4, 6):
            vals, idx = tmoe.top_k(torch.from_numpy(probs).to(dtype), k)
            jvals, jidx = jax.lax.top_k(jnp.asarray(probs, jdtype), k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(vals.float().numpy(),
                                          np.asarray(jvals, np.float32))


@pytest.mark.parametrize("cf", [0.0, 1.5], ids=["dense", "cf1.5"])
def test_moe_mlp_with_tied_router_logits_matches_jax(cf):
    """Experts 1 and 3 with identical router columns: every token's
    logits tie exactly, and the tie goes to expert 1 on both sides, so
    outputs and gradients still agree."""
    x, blk, w = _inputs(seed=1)
    blk["router"][:, 3] = blk["router"][:, 1]
    want, got = _both(x, blk, w, 2, cf)
    for name, a, b in zip(["y", "aux", "dx", *blk], got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)


# -- the tiny MoE model in one process ----------------------------------------

@pytest.mark.parametrize("cf", [0.0, 1.5], ids=["dense", "cf1.5"])
def test_tiny_moe_model_loss_and_grads_match_jax(cf):
    """loss_fn (cross entropy plus the aux loss of the MoE block) and
    its gradient of every leaf, from JAX's params."""
    kw = dict(n_experts=E, moe_capacity_factor=cf)
    jcfg, tcfg = jm.tiny_config(**kw), tm.tiny_config(**kw)
    jp = jm.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    toks = _tokens(jcfg.vocab_size, 2, 32)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, {"tokens": jnp.asarray(toks)},
                                            jcfg)
    tl, tg = tt.value_and_grad(tp, {"tokens": torch.from_numpy(toks).long()},
                               tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(_flat(_np_tree(jg)))
    for name, g in _flat(tg):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * np.abs(want[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("cf", [0.0, 1.5], ids=["dense", "cf1.5"])
def test_three_moe_train_steps_match_jax(cf):
    """Three steps from JAX's params, losses and grad norms within 1e-5,
    params by tests/test_torch_train.py's Adam-step rule, but for its
    bound on every element, which is one step (MOE_STEP_MAX)."""
    kw = dict(n_experts=E, moe_capacity_factor=cf)
    _three_steps(jm.tiny_config(**kw), tm.tiny_config(**kw), t=32,
                 step_max=MOE_STEP_MAX)


# -- expert parallelism on 4 ranks -------------------------------------------

MOE = {"n_experts": E, "expert_top_k": 2, "moe_capacity_factor": 1.5}
EP_CASES = [
    ({"fsdp": 4}, MOE),
    ({"fsdp": 4}, dict(MOE, moe_capacity_factor=0.0)),
    ({"fsdp": 2, "tp": 2}, MOE),
    ({"dp": 2, "fsdp": 2}, MOE),
    ({"dcn": 2, "fsdp": 2}, MOE),
    ({"fsdp": 2, "sp": 2}, dict(MOE, use_ring_attention=True)),
    # capacity 23, an odd count of slots an expert over sp 2
    ({"fsdp": 2, "sp": 2}, dict(MOE, moe_capacity_factor=1.4,
                                use_ring_attention=True)),
]
EP_IDS = ["fsdp4_ep4", "fsdp4_ep4_dense", "fsdp2_tp2", "dp2_fsdp2",
          "dcn2_fsdp2_promoted", "fsdp2_sp2_capacity",
          "fsdp2_sp2_odd_capacity"]
WORLD = 4
STEPS = 3

# every case of EP_CASES on one gloo group of 4 ranks, one after another:
# JAX's initial params loaded into the case's mesh, the gradient of the
# first batch, then STEPS steps; each rank writes one npz a case, with
# the slot rows its experts ran on in the first MoE layer's forward
RANK_CASES = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, convert, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, moe as tmoe
from volcano_tpu_torch.workloads import train as tt
cases, steps, folder, timeout = (json.loads(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], float(sys.argv[4]))
info = bootstrap.initialize(device="cpu", timeout=timeout)
ffn, rows = tmoe._expert_ffn, []
def counted(ei, blk, dtype):
    rows.append(ei.shape[0] * ei.shape[1] * ei.shape[2])
    return ffn(ei, blk, dtype)
tmoe._expert_ffn = counted
for i, (axes, flags) in enumerate(cases):
    rows.clear()
    mesh = (mesh_lib.make_hybrid_mesh(axes, "cpu", slice_id=info.slice_id)
            if "dcn" in axes else mesh_lib.make_mesh(axes, "cpu"))
    data = dict(np.load(f"{folder}/init{i}.npz"))
    tree = {k: data[k] for k in ("embed", "final_norm", "head")}
    n_layers = 1 + max(int(k.split(".")[1]) for k in data
                       if k.startswith("blocks."))
    tree["blocks"] = [{k.split(".")[2]: v for k, v in data.items()
                       if k.startswith(f"blocks.{b}.")}
                      for b in range(n_layers)]
    params = convert.params_from_jax(tree, device="cpu", mesh=mesh)
    tokens = torch.from_numpy(data["tokens"]).long()
    shard = tt.batch_sharding(mesh)
    tokens = tokens[shard.rows(tokens.shape[0]), shard.cols(tokens.shape[1])]
    cfg = tm.tiny_config(**flags)
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
    state = opt.init(params)
    step = tt.make_train_step(cfg, opt, mesh)
    _, grads = tt.value_and_grad(params, {"tokens": tokens}, cfg, mesh)
    losses, norms = [], []
    for _ in range(steps):
        params, state, m = step(params, state, {"tokens": tokens})
        losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    out = {"tokens": tokens.numpy(), "losses": np.array(losses),
           "norms": np.array(norms), "warnings": np.array([], dtype=str),
           "expert_rows": np.array(rows[0])}
    out.update((k, x.full_tensor().numpy()) for k, x in tt.named_leaves(params))
    out.update((k, x.full_tensor().numpy())
               for k, x in tt.named_leaves(grads, "grad."))
    np.savez(f"{folder}/out{i}.rank{dist.get_rank()}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """Each case of EP_CASES run by JAX on its 4-device mesh and by the
    port on one 4-rank gloo group (all cases in turn, started first and
    run beside the JAX side): [(JAX's run, each rank's results)]."""
    folder = tmp_path_factory.mktemp("ep")
    for i, (axes, flags) in enumerate(EP_CASES):
        mesh = _jax_mesh(axes)
        cfg = jm.tiny_config(**flags)
        params, _, _ = jt.init_sharded(jax.random.key(0), cfg, mesh,
                                       jt.make_optimizer(lr=1e-2,
                                                         warmup_steps=1))
        batch = jt.synthetic_batch(jax.random.key(1), cfg, 4, 32, mesh)
        np.savez(folder / f"init{i}.npz", tokens=np.asarray(batch["tokens"]),
                 **dict(_flat(jax.tree.map(np.asarray, params))))
    with rendezvous() as port:
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_CASES, json.dumps(EP_CASES),
             str(STEPS), str(folder), str(RANK_TIMEOUT_S)],
            env=rank_env(r, WORLD, port, TPU_SLICE_ID=r * 2 // WORLD),
            cwd=REPO, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
            for r in range(WORLD)]
        try:
            jax_runs = [_jax_step(axes, flags, STEPS, 4, 32)
                        for axes, flags in EP_CASES]
            for p in procs:
                _, err = p.communicate(timeout=PROC_TIMEOUT_S)
                assert p.returncode == 0, err[-3000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return [(run, [dict(np.load(folder / f"out{i}.rank{r}.npz"))
                   for r in range(WORLD)])
            for i, run in enumerate(jax_runs)]


@pytest.mark.parametrize("case", range(len(EP_CASES)), ids=EP_IDS)
def test_four_rank_moe_step_matches_jax_mesh(case, ep_runs):
    """3 steps of the tiny f32 MoE config (4 experts, top-2, capacity
    1.5 unless dense), lr 1e-2, warmup 1, global batch 4 x 32, from
    JAX's initial params, on 4 gloo ranks against JAX's 4-device mesh:
    experts over fsdp 4 (each rank one expert, the tokens moved by
    all-to-all), with tp splitting each expert's ff dim, with dp, over
    dcn x fsdp (promoted: the expert all-to-all crosses slices and the
    expert gradients are summed over dp alone), and with the sequence
    over sp (capacity positions offset by the earlier sp rank's counts,
    the aux loss's token fractions global, each slot's expert work done
    on one sp rank).  Losses and norms within 1e-5, gradients within
    1e-5 of each leaf's largest, params by the Adam-step rule.  The
    ranks' experts run on every slot of the global batch once (tp times
    under tp, whose ranks split each slot's ff dim): E slots a token
    position when dense, else E x C a row, C rounded up to a multiple
    of sp."""
    jax_run, ranks = ep_runs[case]
    port_warn, jax_warn = _assert_ranks_match(jax_run, ranks)
    assert jax_warn == [] and all(w == [] for w in port_warn)
    axes, flags = EP_CASES[case]
    sp, cf = axes.get("sp", 1), flags["moe_capacity_factor"]
    width = -(-math.ceil(cf * 32 * 2 / E) // sp) * sp if cf else 32
    assert sum(int(r["expert_rows"]) for r in ranks) == \
        axes.get("tp", 1) * 4 * E * width

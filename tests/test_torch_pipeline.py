"""Pipeline parallelism in the port (volcano_tpu_torch.workloads.pipeline)
against the JAX package's, on the CPU: the stage stacking and its
refusals, the pipelined forward, loss and gradients on 4 gloo ranks
against the flat model, and the pipelined train step at pp 4 and at
pp 2 over slices (2 x 2) against JAX's `make_pipelined_train_step` on 4
virtual devices.
"""

import json
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from test_torch_train import _flat, _np_tree
from test_torch_worker import (PROC_TIMEOUT_S, RANK_TIMEOUT_S, REPO, SHARE,
                               _assert_stepped_params, free_port, rank_env)
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import pipeline as jpipe
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch.workloads import bootstrap, convert
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import pipeline as tpipe

WORLD = 4
B, T = 8, 32
# the reference's own bound for the pipelined blocks against the
# sequential ones (tests/test_pipeline.py)
ATOL_BLOCKS = 2e-5
STEPS = 3


def _jax_params(n_layers=4, **kw):
    return jm.init_params(jax.random.key(0), jm.tiny_config(n_layers=n_layers,
                                                            **kw))


def _tokens():
    return np.asarray(jax.random.randint(jax.random.key(1), (B, T), 0,
                                         jm.tiny_config().vocab_size))


# -- stacking --------------------------------------------------------------

def test_stack_stage_params_matches_reference():
    """[S, B, ...] stacks equal to the reference's, the outer leaves
    whole; stage placements shard the stage dim over pp and replicate
    over pp_rep, the outer leaves replicated."""
    jp = _jax_params()
    j_outer, j_stages = jpipe.stack_stage_params(jp, 2)
    t_outer, t_stages = tpipe.stack_stage_params(
        convert.params_from_jax(_np_tree(jp), device="cpu"), 2)
    assert list(t_outer) == list(j_outer)
    assert set(t_stages) == set(j_stages)
    for name, x in list(t_outer.items()) + list(t_stages.items()):
        want = (j_outer if name in j_outer else j_stages)[name]
        assert np.array_equal(x.numpy(), np.asarray(want)), name
    assert tuple(t_stages["wq"].shape) == (2, 2, 64, 64)
    mesh = types.SimpleNamespace(mesh_dim_names=("pp", "pp_rep"))
    outer_sh, stage_sh = tpipe.stage_param_shardings(t_stages, t_outer, mesh)
    assert set(outer_sh.values()) == {(Replicate(), Replicate())}
    assert set(stage_sh.values()) == {(Shard(0), Replicate())}


def test_stack_refuses_moe_blocks():
    params = tm.init_params(tm.tiny_config(n_layers=4, n_experts=4),
                            torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="dense block stacks"):
        tpipe.stack_stage_params(params, 2)


def test_stack_refuses_indivisible_and_heterogeneous_stacks():
    params = tm.init_params(tm.tiny_config(n_layers=3),
                            torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="divisible"):
        tpipe.stack_stage_params(params, 4)
    params = tm.init_params(tm.tiny_config(n_layers=2),
                            torch.Generator().manual_seed(0), "cpu")
    del params["blocks"][1]["attn_norm"]
    with pytest.raises(ValueError, match="keys differ"):
        tpipe.stack_stage_params(params, 2)


def test_pp_mesh_needs_its_stages():
    bootstrap.initialize({}, device="cpu", timeout=RANK_TIMEOUT_S)
    try:
        with pytest.raises(ValueError, match="need 2 devices"):
            tpipe.make_pp_mesh(2, device_type="cpu")
        mesh = tpipe.make_pp_mesh(1, device_type="cpu")
        assert mesh.mesh_dim_names == ("pp",)
        with pytest.raises(ValueError, match="not divisible"):
            tpipe.make_pp_mesh_over_slices(2, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


# -- forward, loss and gradients on 4 ranks ------------------------------------

# the rank scripts' loader: the param tree of a JAX npz (its `embed`,
# ..., `blocks.<i>.<name>` entries)
RANK_COMMON = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, convert, pipeline
from volcano_tpu_torch.workloads import model as tm, train as tt

def load(path):
    data = dict(np.load(path))
    tree = {k: data[k] for k in ("embed", "final_norm", "head")}
    n = 1 + max(int(k.split(".")[1]) for k in data if k.startswith("blocks."))
    tree["blocks"] = [{k.split(".")[2]: v for k, v in data.items()
                       if k.startswith(f"blocks.{i}.")} for i in range(n)]
    return convert.params_from_jax(tree, device="cpu"), data
"""

RANK_PIPE = RANK_COMMON + r"""
src, dst, timeout = sys.argv[1], sys.argv[2], float(sys.argv[3])
bootstrap.initialize(device="cpu", timeout=timeout)
params, data = load(src)
mesh = pipeline.make_pp_mesh(4, device_type="cpu")
outer, stages = pipeline.distribute_stages(
    *pipeline.stack_stage_params(params, 4), mesh)
tokens = torch.from_numpy(data["tokens"]).long()
out = {}
cfg = tm.tiny_config(n_layers=4)
x = params["embed"][tokens]
for key in ("positions", "per_sample"):
    pos = torch.from_numpy(data[key]).long()
    out[key] = pipeline.pipelined_apply_blocks(x, stages, cfg, pos, mesh,
                                               4).numpy()
out["loss"] = np.array(float(pipeline.pipelined_loss(outer, stages, tokens,
                                                     cfg, mesh, 4)))
for remat in (False, True):
    loss, g_outer, g_stage = pipeline.pipelined_value_and_grad(
        outer, stages, tokens, tm.tiny_config(n_layers=4, remat=remat),
        mesh, 4)
    out[f"remat{remat}.loss"] = np.array(float(loss))
    out.update((f"remat{remat}.{k}", g.numpy()) for k, g in g_outer.items())
    out.update((f"remat{remat}.stage.{k}", g[0].numpy())
               for k, g in g_stage.items())
out["stage"] = np.array(mesh.get_local_rank("pp"))
np.savez(dst, **out)
dist.destroy_process_group()
"""


def _spawn(script, argvs, slices=1):
    """`script` on WORLD gloo ranks with per-rank argv; the Popen objects
    (the caller waits)."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", script, *argv],
        env=rank_env(r, WORLD, port,
                     **({"TPU_SLICE_ID": r * slices // WORLD}
                        if slices > 1 else {})),
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r, argv in enumerate(argvs)]


def _wait(procs):
    try:
        for p in procs:
            _, err = p.communicate(timeout=PROC_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    """The port's pipelined forward, loss and gradients on 4 ranks at
    pp 4, and the flat JAX model's on the same params: (each rank's
    results, JAX's)."""
    folder = tmp_path_factory.mktemp("pipe")
    cfg = jm.tiny_config(n_layers=4)
    jp = _jax_params()
    tokens = _tokens()
    positions = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    per_sample = (np.arange(T)[None, :] + 10 * np.arange(B)[:, None]) \
        .astype(np.int32)
    np.savez(folder / "in.npz", tokens=tokens, positions=positions,
             per_sample=per_sample, **dict(_flat(_np_tree(jp))))
    procs = _spawn(RANK_PIPE, [[str(folder / "in.npz"),
                                str(folder / f"rank{r}.npz"),
                                str(RANK_TIMEOUT_S)] for r in range(WORLD)])
    try:
        x = jp["embed"].astype(cfg.dtype)[jnp.asarray(tokens)]
        want = {}
        for key, pos in (("positions", positions), ("per_sample", per_sample)):
            seq = x
            for blk in jp["blocks"]:
                seq, _ = jm._block(seq, blk, cfg, jnp.asarray(pos), None)
            want[key] = np.asarray(seq)
        loss, grads = jax.value_and_grad(jm.loss_fn)(
            jp, {"tokens": jnp.asarray(tokens)}, cfg)
        want["loss"] = float(loss)
        want["grads"] = _np_tree(grads)
    finally:
        _wait(procs)
    return [dict(np.load(folder / f"rank{r}.npz")) for r in range(WORLD)], \
        want


@pytest.mark.parametrize("key", ["positions", "per_sample"])
def test_pipelined_apply_blocks_matches_sequential(key, pipe_run):
    """The pipelined block stack at pp 4, 4 microbatches of 2 rows,
    against the reference's blocks applied in sequence, on every rank,
    within the reference's 2e-5: with shared positions, and with
    per-sample position ids, which must travel with their microbatch."""
    ranks, want = pipe_run
    for res in ranks:
        np.testing.assert_allclose(res[key], want[key], atol=ATOL_BLOCKS,
                                   rtol=ATOL_BLOCKS)


def test_pipelined_loss_matches_flat_loss(pipe_run):
    ranks, want = pipe_run
    assert sorted(int(res["stage"]) for res in ranks) == list(range(WORLD))
    for res in ranks:
        np.testing.assert_allclose(float(res["loss"]), want["loss"],
                                   rtol=SHARE)


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_grads_match_flat_grads(remat, pipe_run):
    """`pipelined_value_and_grad` against `jax.value_and_grad` of the
    flat `loss_fn` (equal to the pipelined loss's gradients in the
    reference): each stage's block gradients are the flat gradients of
    its blocks, and the outer leaves' (summed over pp) are the flat
    ones on every rank; within 1e-5 of each leaf's largest."""
    ranks, want = pipe_run
    grads = want["grads"]
    for res in ranks:
        s = int(res["stage"])
        np.testing.assert_allclose(float(res[f"remat{remat}.loss"]),
                                   want["loss"], rtol=SHARE)
        for name in ("embed", "final_norm", "head"):
            ref = grads[name]
            np.testing.assert_allclose(
                res[f"remat{remat}.{name}"], ref, rtol=0,
                atol=SHARE * np.abs(ref).max(), err_msg=name)
        for name, ref in grads["blocks"][s].items():
            got = res[f"remat{remat}.stage.{name}"][0]
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=SHARE * np.abs(ref).max(),
                                       err_msg=f"stage {s} {name}")


# -- the pipelined train step against JAX's ------------------------------------

RANK_PP_STEPS = RANK_COMMON + r"""
cases, folder, steps, timeout = (json.loads(sys.argv[1]), sys.argv[2],
                                 int(sys.argv[3]), float(sys.argv[4]))
info = bootstrap.initialize(device="cpu", timeout=timeout)
for i, (stages, slices) in enumerate(cases):
    params, data = load(f"{folder}/init{i}.npz")
    tokens = torch.from_numpy(data["tokens"]).long()
    if slices:
        mesh = pipeline.make_pp_mesh_over_slices(
            stages, device_type="cpu",
            slice_ids=[r * slices // dist.get_world_size()
                       for r in range(dist.get_world_size())])
    else:
        mesh = pipeline.make_pp_mesh(stages, device_type="cpu")
    cfg = tm.tiny_config(n_layers=4)
    outer, blocks = pipeline.distribute_stages(
        *pipeline.stack_stage_params(params, stages), mesh)
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
    state = opt.init(pipeline.joined(outer, blocks))
    step = pipeline.make_pipelined_train_step(cfg, mesh, opt, 4)
    losses, norms = [], []
    for _ in range(steps):
        outer, blocks, state, m = step(outer, blocks, state, {"tokens": tokens})
        losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    out = {"losses": np.array(losses), "norms": np.array(norms),
           "coord": np.array(mesh.get_coordinate())}
    out.update((k, x.full_tensor().numpy()) for k, x in outer.items())
    out.update((f"stage.{k}", x.full_tensor().numpy())
               for k, x in blocks.items())
    np.savez(f"{folder}/out{i}.rank{dist.get_rank()}.npz", **out)
dist.destroy_process_group()
"""

# (stages, slices): pp 4 flat, pp 2 with a stage per slice of 2 ranks
PP_CASES = [(4, 0), (2, 2)]
PP_IDS = ["pp4", "pp2_over_slices"]


def _jax_pp_run(stages, slices, jp, tokens):
    """JAX's STEPS pipelined steps on 4 virtual devices: (losses, the
    flat model's grad norm at each step's params, final params as a
    flat dict of the port's names)."""
    devices = jax.devices()[:WORLD]
    mesh = jpipe.make_pp_mesh_over_slices(stages, devices=devices) \
        if slices else jpipe.make_pp_mesh(stages, devices=devices[:stages])
    cfg = jm.tiny_config(n_layers=4)
    # fresh buffers: the step donates its params
    outer, blocks = jpipe.stack_stage_params(
        jax.tree.map(jnp.asarray, _np_tree(jp)), stages)
    outer_sh, stage_sh = jpipe.stage_param_shardings(blocks, outer, mesh)
    outer = jax.device_put(outer, outer_sh)
    blocks = jax.device_put(blocks, stage_sh)
    opt = jt.make_optimizer(lr=1e-2, warmup_steps=1)
    state = opt.init((outer, blocks))
    step = jpipe.make_pipelined_train_step(cfg, mesh, opt, n_microbatches=4)
    flat_grad = jax.jit(jax.grad(jm.loss_fn), static_argnums=(2,))
    losses, norms = [], []
    batch = {"tokens": jnp.asarray(tokens)}
    per = 4 // stages
    for _ in range(STEPS):
        flat = dict(outer, blocks=[
            {k: v[s][b] for k, v in blocks.items()}
            for s in range(stages) for b in range(per)])
        norms.append(float(jnp.sqrt(sum(
            jnp.sum(jnp.square(g))
            for g in jax.tree.leaves(flat_grad(flat, batch, cfg))))))
        outer, blocks, state, m = step(outer, blocks, state, batch)
        losses.append(float(m["loss"]))
    final = {k: np.asarray(v) for k, v in outer.items()}
    final.update((f"stage.{k}", np.asarray(v)) for k, v in blocks.items())
    return losses, norms, final


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Each case of PP_CASES by JAX and by the port (one 4-rank gloo
    group, the cases in turn, beside the JAX side): [(JAX's run, each
    rank's results)]."""
    folder = tmp_path_factory.mktemp("pp")
    jp = _jax_params()
    tokens = _tokens()
    for i in range(len(PP_CASES)):
        np.savez(folder / f"init{i}.npz", tokens=tokens,
                 **dict(_flat(_np_tree(jp))))
    procs = _spawn(RANK_PP_STEPS, [[json.dumps(PP_CASES), str(folder),
                                    str(STEPS), str(RANK_TIMEOUT_S)]] * WORLD,
                   slices=2)
    try:
        runs = [_jax_pp_run(stages, slices, jp, tokens)
                for stages, slices in PP_CASES]
    finally:
        _wait(procs)
    return [(run, [dict(np.load(folder / f"out{i}.rank{r}.npz"))
                   for r in range(WORLD)])
            for i, run in enumerate(runs)]


@pytest.mark.parametrize("case", range(len(PP_CASES)), ids=PP_IDS)
def test_pipelined_steps_match_jax(case, pp_runs):
    """3 steps of the tiny f32 config at 4 layers, batch 8 x 32 in 4
    microbatches, lr 1e-2, warmup 1, from JAX's params: at pp 4 (a
    stage a rank) and at pp 2 over slices (each stage on the 2 ranks of
    its slice, which agree bit for bit), against JAX's
    `make_pipelined_train_step` on 4 devices.  Losses and grad norms
    (JAX's flat gradient norm at the same params) within 1e-5; the
    params gathered on every rank by the Adam-step rule, and equal on
    every rank."""
    (losses, norms, final), ranks = pp_runs[case]
    stages, slices = PP_CASES[case]
    if slices:
        assert sorted(tuple(res["coord"]) for res in ranks) == \
            [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=SHARE)
        np.testing.assert_allclose(res["norms"], norms, rtol=SHARE)
        _assert_stepped_params(res, final, lr=1e-2)
    for res in ranks[1:]:
        for name in final:
            assert np.array_equal(ranks[0][name], res[name]), name

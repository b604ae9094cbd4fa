"""The sharded train step (params and AdamW state laid out over fsdp and
tp as the reference lays them out) against the JAX package's meshes, on
the CPU.

The JAX side runs on the conftest's virtual CPU devices; the port side
as 4-process gloo groups, one rank a process, with JAX's initial params
loaded by value into each layout.
"""

import json
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from test_torch_worker import (RANK_TIMEOUT_S, SHARE,
                               _assert_stepped_params, _flat, free_port,
                               rank_env, run_procs)
from volcano_tpu.workloads import mesh as jmesh
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch.workloads import checkpoint
from volcano_tpu_torch.workloads import mesh as tmesh
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt

WORLD = 4
GLOBAL_BATCH = 4
SEQ = 32
MESHES = [{"fsdp": 4}, {"fsdp": 2, "tp": 2}, {"dp": 2, "tp": 2},
          {"dcn": 2, "fsdp": 2}]
MESH_IDS = ["fsdp4", "fsdp2_tp2", "dp2_tp2", "dcn2_fsdp2"]


def _jax_mesh(axes):
    devices = jax.devices()[:WORLD]
    if "dcn" in axes:
        return jmesh.make_hybrid_mesh(axes, devices=devices)
    return jmesh.make_mesh(axes, devices=devices)


# -- the param specs -----------------------------------------------------

@pytest.mark.parametrize("axes", [{"fsdp": 2, "tp": 2}, {"dcn": 2, "fsdp": 2}],
                         ids=["flat", "hybrid"])
def test_param_specs_match_reference(axes):
    """Every leaf's spec equals the reference's PartitionSpec, and its
    placements shard each named axis at that dim."""
    jmesh_ = _jax_mesh(axes)
    jparams = jm.init_params(jax.random.key(0), jm.tiny_config())
    want = dict(_flat(jm.param_specs(jparams, jmesh_)))
    tparams = tm.init_params(tm.tiny_config(),
                             torch.Generator().manual_seed(0), "cpu")
    got = dict(_flat(tm.param_specs(tparams)))
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == tuple(want[name]), name
        assert "dcn" not in spec, name
    names = tmesh.HYBRID_AXES if "dcn" in axes else tmesh.AXES
    stub = types.SimpleNamespace(mesh_dim_names=names)
    shardings = dict(_flat(tm.param_shardings(tparams, stub)))
    for name, places in shardings.items():
        for axis, place in zip(names, places):
            dims = [i for i, a in enumerate(got[name]) if a == axis]
            assert place == (Shard(dims[0]) if dims else Replicate()), \
                (name, axis)
    assert shardings["blocks.0.wq"] == tm.placements(("fsdp", "tp"), stub)


def test_distribute_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not divide"):
        tm.distribute({"wq": torch.zeros(6, 4)},
                      types.SimpleNamespace(mesh_dim_names=tmesh.AXES,
                                            shape=(1, 4, 1, 1)))


# -- the sharded step over 4 ranks ---------------------------------------

RANK_SHARDED = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, convert, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
src, dst, axes, timeout = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), float(sys.argv[4])
info = bootstrap.initialize(device="cpu", timeout=timeout)
mesh = (mesh_lib.make_hybrid_mesh(axes, "cpu", slice_id=info.slice_id)
        if "dcn" in axes else mesh_lib.make_mesh(axes, "cpu"))
data = dict(np.load(src))
tree = {k: data[k] for k in ("embed", "final_norm", "head")}
n_layers = 1 + max(int(k.split(".")[1]) for k in data if k.startswith("blocks."))
tree["blocks"] = [{k.split(".")[2]: v for k, v in data.items()
                   if k.startswith(f"blocks.{i}.")} for i in range(n_layers)]
params = convert.params_from_jax(tree, device="cpu", mesh=mesh)
tokens = torch.from_numpy(data["tokens"]).long()
tokens = tokens[tt.batch_sharding(mesh).rows(len(tokens))]
cfg = tm.tiny_config()
opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
state = opt.init(params)
out = {"rows": np.array([tokens.shape[0]])}
out.update((f"local.{k}", tt.local(x).numpy().copy())
           for k, x in tt.named_leaves(params))
out.update((f"mu_shape.{k}", np.array(tt.local(x).shape))
           for k, x in tt.named_leaves(state["mu"]))
out.update((f"nu_shape.{k}", np.array(tt.local(x).shape))
           for k, x in tt.named_leaves(state["nu"]))
step = tt.make_train_step(cfg, opt, mesh)
_, grads = tt.value_and_grad(params, {"tokens": tokens}, cfg, mesh)
losses, norms = [], []
for _ in range(3):
    params, state, m = step(params, state, {"tokens": tokens})
    losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
out.update(losses=np.array(losses), norms=np.array(norms))
out.update((k, x.full_tensor().numpy()) for k, x in tt.named_leaves(params))
out.update((k, x.full_tensor().numpy())
           for k, x in tt.named_leaves(grads, "grad."))
np.savez(dst, **out)
dist.destroy_process_group()
"""


def _jax_run(axes):
    """JAX's 3 steps on a 4-device mesh: (init params, tokens, losses,
    grad norms, final params, the full batch's gradient, and each
    device's (index, shape) of every init param shard)."""
    mesh = _jax_mesh(axes)
    cfg = jm.tiny_config()
    opt = jt.make_optimizer(lr=1e-2, warmup_steps=1)
    params, state, _ = jt.init_sharded(jax.random.key(0), cfg, mesh, opt)
    devices = list(mesh.devices.flat)
    shards = {}
    for name, arr in _flat(params):
        by_dev = {s.device: s for s in arr.addressable_shards}
        shards[name] = [(by_dev[d].index, by_dev[d].data.shape)
                        for d in jax.devices()[:WORLD]]
    assert sorted(d.id for d in devices) == list(range(WORLD))
    init = jax.tree.map(np.asarray, params)
    batch = jt.synthetic_batch(jax.random.key(1), cfg, GLOBAL_BATCH, SEQ,
                               mesh)
    step = jt.make_train_step(cfg, mesh, opt)
    losses, norms = [], []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    grads = jax.grad(jm.loss_fn)(jax.tree.map(jax.numpy.asarray, init),
                                 {"tokens": batch["tokens"]}, cfg)
    return (init, np.asarray(batch["tokens"]), losses, norms,
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, grads), shards)


@pytest.mark.parametrize("axes", MESHES, ids=MESH_IDS)
def test_four_rank_sharded_step_matches_jax_mesh(axes, tmp_path):
    """3 steps of the tiny f32 config, lr 1e-2, warmup 1, global batch
    4 x 32, from JAX's initial params: losses and grad norms within 1e-5
    relative, the gathered gradients within 1e-5 of each leaf's largest,
    params by the Adam-step rule; each rank holds exactly the shard of
    every param (and of mu and nu) that the reference's device holds."""
    init, tokens, losses, norms, final, grads, shards = _jax_run(axes)
    src = tmp_path / "init.npz"
    np.savez(src, tokens=tokens, **dict(_flat(init)))
    port = free_port()
    slices = axes.get("dcn", 1)
    outs = run_procs(
        [[sys.executable, "-c", RANK_SHARDED, str(src),
          str(tmp_path / f"rank{r}.npz"), json.dumps(axes),
          str(RANK_TIMEOUT_S)] for r in range(WORLD)],
        [rank_env(r, WORLD, port, **(
            {"TPU_SLICE_ID": r * slices // WORLD} if slices > 1 else {}))
         for r in range(WORLD)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    data = GLOBAL_BATCH * axes.get("tp", 1) // WORLD
    want = dict(_flat(final))
    for r, res in enumerate(ranks):
        assert int(res["rows"][0]) == data
        np.testing.assert_allclose(res["losses"], losses, rtol=SHARE)
        np.testing.assert_allclose(res["norms"], norms, rtol=SHARE)
        for name, ref in _flat(grads):
            np.testing.assert_allclose(
                res[f"grad.{name}"], ref, rtol=0,
                atol=SHARE * np.abs(ref).max(), err_msg=name)
        _assert_stepped_params(res, want, lr=1e-2)
        for name, full in _flat(init):
            index, shape = shards[name][r]
            held = res[f"local.{name}"]
            assert held.shape == shape, (r, name)
            assert np.array_equal(held, full[index]), (r, name)
            assert tuple(res[f"mu_shape.{name}"]) == shape, (r, name)
            assert tuple(res[f"nu_shape.{name}"]) == shape, (r, name)
    # every rank applies its shard of one update: the gathered states
    # agree bit for bit
    for res in ranks[1:]:
        for name in want:
            assert np.array_equal(ranks[0][name], res[name]), name


# -- checkpoints across layouts -------------------------------------------

RANK_DCP = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, checkpoint, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
mode, ckpt, axes, timeout = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), float(sys.argv[4])
flags = json.loads(sys.argv[5]) if len(sys.argv) > 5 else {}
info = bootstrap.initialize(device="cpu", timeout=timeout)
mesh = (mesh_lib.make_hybrid_mesh(axes, "cpu", slice_id=info.slice_id)
        if "dcn" in axes else mesh_lib.make_mesh(axes, "cpu"))
cfg = tm.tiny_config(**flags)
opt = tt.make_optimizer(lr=1e-2, warmup_steps=1, mu_dtype=torch.bfloat16)
seed = 0 if mode == "save" else 42
params, state, _ = tt.init_sharded(torch.Generator().manual_seed(seed), cfg,
                                   mesh, opt)
step = tt.make_train_step(cfg, opt, mesh)
batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4, 32, mesh)
if mode == "save":
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    checkpoint.save(ckpt, 2, params, state)
else:
    params, state, got = checkpoint.restore(ckpt, params, state)
    assert got == 2 and state["count"] == 2
whole = {}
for key, tree in (("params", params), ("mu", state["mu"]),
                  ("nu", state["nu"])):
    # copies: a replicated leaf's full tensor is its own storage, which
    # the step below updates in place
    whole.update((f"{key}.{k}", x.full_tensor().float().numpy().copy())
                 for k, x in tt.named_leaves(tree))
_, _, m = step(params, state, batch)
whole["loss"] = np.array([float(m["loss"])])
if dist.get_rank() == 0:
    np.savez(ckpt + f".{mode}.npz", **whole)
dist.destroy_process_group()
"""


def _rank_dcp(mode, ckpt, axes, flags=None):
    world = int(np.prod(list(axes.values())))
    slices = axes.get("dcn", 1)
    port = free_port()
    outs = run_procs(
        [[sys.executable, "-c", RANK_DCP, mode, ckpt, json.dumps(axes),
          str(RANK_TIMEOUT_S), json.dumps(flags or {})]
         for _ in range(world)],
        [rank_env(r, world, port, **(
            {"TPU_SLICE_ID": r * slices // world} if slices > 1 else {}))
         for r in range(world)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return dict(np.load(ckpt + f".{mode}.npz"))


def test_sharded_checkpoint_restores_at_other_layouts(tmp_path):
    """A DCP save at fsdp 2 x tp 2 (each rank writes its shards),
    restored bit-identically in a process with no group (plain tensors)
    and by a dp 2 group (replicated DTensors), which then takes the same
    next step."""
    ckpt = str(tmp_path / "ckpt")
    saved = _rank_dcp("save", ckpt, {"fsdp": 2, "tp": 2})
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == \
        ["ckpt"]
    cfg = tm.tiny_config()
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1, mu_dtype=torch.bfloat16)
    params = tm.init_params(cfg, torch.Generator().manual_seed(42), "cpu")
    state = opt.init(params)
    params, state, got = checkpoint.restore(ckpt, params, state)
    assert got == 2 and state["count"] == 2
    for key, tree in (("params", params), ("mu", state["mu"]),
                      ("nu", state["nu"])):
        for name, x in tt.named_leaves(tree):
            assert np.array_equal(x.float().numpy(),
                                  saved[f"{key}.{name}"]), (key, name)
    restored = _rank_dcp("restore", ckpt, {"dp": 2})
    for name, x in saved.items():
        if name != "loss":
            assert np.array_equal(restored[name], x), name
    np.testing.assert_allclose(restored["loss"], saved["loss"], rtol=SHARE)


MOE_FLAGS = {"n_experts": 4, "moe_capacity_factor": 1.5}


def test_moe_checkpoint_restores_at_other_layouts(tmp_path):
    """An MoE state saved at dcn 2 x fsdp 2, where the expert leaves are
    promoted to shard their expert dim over dcn x fsdp (each rank one
    expert), restored bit-identically in a process with no group (plain
    tensors) and by an fsdp 4 group (the expert dim over fsdp alone),
    which then takes the same next step."""
    ckpt = str(tmp_path / "ckpt")
    saved = _rank_dcp("save", ckpt, {"dcn": 2, "fsdp": 2}, MOE_FLAGS)
    cfg = tm.tiny_config(**MOE_FLAGS)
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1, mu_dtype=torch.bfloat16)
    params = tm.init_params(cfg, torch.Generator().manual_seed(42), "cpu")
    state = opt.init(params)
    params, state, got = checkpoint.restore(ckpt, params, state)
    assert got == 2 and state["count"] == 2
    assert "params.blocks.1.moe_gate" in {f"params.{k}" for k, _ in
                                          tt.named_leaves(params)}
    for key, tree in (("params", params), ("mu", state["mu"]),
                      ("nu", state["nu"])):
        for name, x in tt.named_leaves(tree):
            assert np.array_equal(x.float().numpy(),
                                  saved[f"{key}.{name}"]), (key, name)
    restored = _rank_dcp("restore", ckpt, {"fsdp": 4}, MOE_FLAGS)
    for name, x in saved.items():
        if name != "loss":
            assert np.array_equal(restored[name], x), name
    np.testing.assert_allclose(restored["loss"], saved["loss"], rtol=SHARE)

"""Sequence parallelism (sp) in the port -- ring attention, Ulysses, and
the train step over an sp axis -- against the JAX package's meshes, on
the CPU.

The JAX side runs on the conftest's virtual CPU devices; the port side
as gloo groups, one rank a process, with JAX's inputs and initial params
loaded by value.
"""

import importlib
import json
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_torch_worker import (RANK_TIMEOUT_S, SHARE,
                               _assert_stepped_params, _flat, free_port,
                               rank_env, run_procs)
from volcano_tpu.workloads import mesh as jmesh
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import train as jt
from volcano_tpu.workloads.ring_attention import ring_attention as jring
from volcano_tpu.workloads.ulysses import ulysses_attention as julysses

jops = importlib.import_module("volcano_tpu.workloads.ops")
jfa = importlib.import_module("volcano_tpu.workloads.ops.flash_attention")

# tests/test_workloads.py's tolerance for ring and Ulysses against plain
# attention (f32, sum order)
ATOL = 2e-5
FALLBACK = "falling back to ring attention"


def _world(axes):
    return int(np.prod(list(axes.values())))


def _jax_mesh(axes):
    devices = jax.devices()[:_world(axes)]
    if "dcn" in axes:
        return jmesh.make_hybrid_mesh(axes, devices=devices)
    return jmesh.make_mesh(axes, devices=devices)


def _run_ranks(script, axes, *args):
    """`script` on one gloo rank a process over the mesh `axes`, each
    with argv (axes, *args, rank's output path, timeout); returns each
    rank's npz as a dict."""
    world = _world(axes)
    slices = axes.get("dcn", 1)
    port = free_port()
    dst = args[-1]
    outs = run_procs(
        [[sys.executable, "-c", script, json.dumps(axes), *map(str, args[:-1]),
          f"{dst}.rank{r}.npz", str(RANK_TIMEOUT_S)] for r in range(world)],
        [rank_env(r, world, port, **(
            {"TPU_SLICE_ID": r * slices // world} if slices > 1 else {}))
         for r in range(world)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(f"{dst}.rank{r}.npz")) for r in range(world)]


# -- ring and Ulysses attention alone -------------------------------------

RANK_ATTENTION = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, mesh as mesh_lib
from volcano_tpu_torch.workloads.ring_attention import ring_attention
from volcano_tpu_torch.workloads.ulysses import ulysses_attention
axes, kind, src, dst, timeout = (json.loads(sys.argv[1]), sys.argv[2],
                                 sys.argv[3], sys.argv[4], float(sys.argv[5]))
bootstrap.initialize(device="cpu", timeout=timeout)
mesh = mesh_lib.make_mesh(axes, "cpu")
coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
data = dict(np.load(src))

def local(x):
    t, h = x.shape[1] // sizes["sp"], x.shape[2] // sizes["tp"]
    s, j = coord["sp"], coord["tp"]
    return torch.from_numpy(np.ascontiguousarray(
        x[:, s * t:(s + 1) * t, j * h:(j + 1) * h]))

q, k, v = (local(data[n]).requires_grad_() for n in "qkv")
fn = ring_attention if kind == "ring" else ulysses_attention
out = fn(q, k, v, mesh.get_group("sp"))
grads = torch.autograd.grad((out * local(data["w"])).sum(), (q, k, v))
np.savez(dst, out=out.detach().numpy(), tp=coord["tp"], sp=coord["sp"],
         **{f"d{n}": g.numpy() for n, g in zip("qkv", grads)})
dist.destroy_process_group()
"""


def _jax_attention(kind, axes, q, k, v, w):
    """The reference's shard_map'd attention on a mesh of `axes`: its
    output and the gradients of sum(out * w) by q, k and v."""
    spec = P(("dp", "fsdp"), "sp", "tp", None)
    body = jring if kind == "ring" else julysses
    fn = jmesh.shard_map(lambda q, k, v: body(q, k, v, axis_name="sp"),
                         mesh=_jax_mesh(axes), in_specs=(spec,) * 3,
                         out_specs=spec, check_vma=False)
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("axes", [{"sp": 4}, {"tp": 2, "sp": 2}],
                         ids=["sp4", "tp2_sp2"])
def test_attention_matches_reference_shard_map(axes, kind, tmp_path):
    """`ring_attention` and `ulysses_attention` over the sp group of a
    4-rank mesh, each rank on its sequence block and tp heads, against
    the reference's shard_map versions: the output and the gradients of
    q, k and v, within tests/test_workloads.py's 2e-5."""
    b, t, h, d = 2, 32, 8, 8          # h / tp divisible by sp
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                  for _ in range(4))
    out, grads = _jax_attention(kind, axes, *map(jnp.asarray, (q, k, v, w)))
    src = tmp_path / "in.npz"
    np.savez(src, q=q, k=k, v=v, w=w)
    ranks = _run_ranks(RANK_ATTENTION, axes, kind, src,
                       str(tmp_path / "out"))
    sp, tp = axes["sp"], axes.get("tp", 1)
    seen = set()
    for res in ranks:
        s, j = int(res["sp"]), int(res["tp"])
        seen.add((s, j))
        cut = (slice(None), slice(s * t // sp, (s + 1) * t // sp),
               slice(j * h // tp, (j + 1) * h // tp))
        np.testing.assert_allclose(res["out"], out[cut], atol=ATOL, rtol=0)
        for n, g in zip("qkv", grads):
            np.testing.assert_allclose(res[f"d{n}"], g[cut], atol=ATOL,
                                       rtol=0, err_msg=f"d{n}")
    assert len(seen) == _world(axes)


# -- the train step over an sp axis ----------------------------------------

RANK_STEP = r"""
import json, sys, warnings
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, convert, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
axes, flags, steps, src, dst, timeout = (
    json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3]),
    sys.argv[4], sys.argv[5], float(sys.argv[6]))
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
shard = tt.batch_sharding(mesh)
tokens = tokens[shard.rows(tokens.shape[0]), shard.cols(tokens.shape[1])]
cfg = tm.tiny_config(**flags)
opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
state = opt.init(params)
step = tt.make_train_step(cfg, opt, mesh)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    _, grads = tt.value_and_grad(params, {"tokens": tokens}, cfg, mesh)
    losses, norms = [], []
    for _ in range(steps):
        params, state, m = step(params, state, {"tokens": tokens})
        losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
out = {"tokens": tokens.numpy(), "losses": np.array(losses),
       "norms": np.array(norms),
       # the attention dispatch's own warnings, not torch's notices
       "warnings": np.array(sorted({str(w.message) for w in caught
                                    if "use_ulysses_attention" in str(w.message)}))}
out.update((k, x.full_tensor().numpy()) for k, x in tt.named_leaves(params))
out.update((k, x.full_tensor().numpy())
           for k, x in tt.named_leaves(grads, "grad."))
np.savez(dst, **out)
dist.destroy_process_group()
"""


def _jax_step(axes, flags, steps, batch_size, seq):
    """JAX's `steps` steps of the tiny config with `flags` on a mesh of
    `axes`: (init params, global tokens, each device's token index,
    losses, grad norms, final params, the full batch's gradient, the
    warnings raised)."""
    mesh = _jax_mesh(axes)
    cfg = jm.tiny_config(**flags)
    opt = jt.make_optimizer(lr=1e-2, warmup_steps=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        params, state, _ = jt.init_sharded(jax.random.key(0), cfg, mesh, opt)
        init = jax.tree.map(np.asarray, params)
        batch = jt.synthetic_batch(jax.random.key(1), cfg, batch_size, seq,
                                   mesh)
        step = jt.make_train_step(cfg, mesh, opt)
        losses, norms = [], []
        for _ in range(steps):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    by_dev = {s.device: s.index for s in batch["tokens"].addressable_shards}
    index = [by_dev[d] for d in jax.devices()[:_world(axes)]]
    grads = jax.grad(jm.loss_fn)(jax.tree.map(jnp.asarray, init),
                                 {"tokens": batch["tokens"]}, cfg)
    return (init, np.asarray(batch["tokens"]), index, losses, norms,
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, grads),
            sorted({str(w.message) for w in caught
                    if "use_ulysses_attention" in str(w.message)}))


def _hold_step(axes, flags, tmp_path, steps=3, batch_size=4, seq=32):
    """The port's step against JAX's on the same mesh from the same
    params: each rank's tokens are its device's shard, losses and grad
    norms within 1e-5 relative, the gathered gradients within 1e-5 of
    each leaf's largest, params by the Adam-step rule, and the gathered
    states equal on every rank.  Returns the attention dispatch's
    warnings: (each rank's, JAX's)."""
    jax_run = _jax_step(axes, flags, steps, batch_size, seq)
    src = tmp_path / "init.npz"
    np.savez(src, tokens=jax_run[1], **dict(_flat(jax_run[0])))
    ranks = _run_ranks(RANK_STEP, axes, json.dumps(flags), steps, src,
                       str(tmp_path / "out"))
    return _assert_ranks_match(jax_run, ranks)


def _assert_ranks_match(jax_run, ranks):
    """`_hold_step`'s checks of each rank's results against `_jax_step`'s
    run; returns (each rank's warnings, JAX's)."""
    _, tokens, index, losses, norms, final, grads, jwarn = jax_run
    want = dict(_flat(final))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["tokens"], tokens[index[r]])
        np.testing.assert_allclose(res["losses"], losses, rtol=SHARE)
        np.testing.assert_allclose(res["norms"], norms, rtol=SHARE)
        for name, ref in _flat(grads):
            np.testing.assert_allclose(
                res[f"grad.{name}"], ref, rtol=0,
                atol=SHARE * np.abs(ref).max(), err_msg=name)
        _assert_stepped_params(res, want, lr=1e-2)
    for res in ranks[1:]:
        for name in want:
            assert np.array_equal(ranks[0][name], res[name]), name
    return [list(res["warnings"]) for res in ranks], jwarn


STEP_CASES = [
    ({"sp": 4}, {"use_ring_attention": True}),
    ({"fsdp": 2, "sp": 2}, {"use_ring_attention": True}),
    ({"sp": 4}, {"use_ulysses_attention": True}),
    ({"tp": 2, "sp": 2}, {"use_ulysses_attention": True}),
    ({"dp": 2, "sp": 2}, {}),
    ({"dcn": 2, "sp": 2}, {"use_ring_attention": True}),
]
STEP_IDS = ["sp4_ring", "fsdp2_sp2_ring", "sp4_ulysses", "tp2_sp2_ulysses",
            "dp2_sp2_gathered", "dcn2_sp2_ring"]


@pytest.mark.parametrize("axes,flags", STEP_CASES, ids=STEP_IDS)
def test_four_rank_sp_step_matches_jax_mesh(axes, flags, tmp_path):
    """3 steps of the tiny f32 config, lr 1e-2, warmup 1, global batch
    4 x 32, from JAX's initial params, on 4 gloo ranks against JAX's
    4-device mesh: the ring (flat, with fsdp, and on a hybrid mesh whose
    sp groups lie inside a slice), Ulysses (with and without tp), and the
    gathered path (sp with neither flag).  No warning on either side."""
    port_warn, jax_warn = _hold_step(axes, flags, tmp_path)
    assert jax_warn == [] and all(w == [] for w in port_warn)


def test_ulysses_falls_back_to_the_ring_with_the_reference_warning(tmp_path):
    """n_heads 2 at tp 2, sp 2: one head a tp rank does not divide over
    sp, so Ulysses degrades to the ring; the port warns the reference's
    words, on every rank, and trains as the reference does."""
    port_warn, jax_warn = _hold_step(
        {"tp": 2, "sp": 2}, {"use_ulysses_attention": True, "n_heads": 2},
        tmp_path, steps=1)
    assert len(jax_warn) == 1 and FALLBACK in jax_warn[0]
    assert all(w == jax_warn for w in port_warn)


def test_ulysses_flash_step_matches_jax(tmp_path, monkeypatch):
    """Ulysses with the flash path at head dim 128 (d_model 256, 2
    heads), 2 ranks at sp 2, t 256: each rank's flash call sees the whole
    sequence on one head, [b, 256, 1, 128] -- the plain versions of the
    kernels on the CPU -- against the reference with its Pallas kernels
    in interpret mode (monkeypatched here, as
    tests/test_flash_attention.py does)."""
    orig = jfa.flash_attention

    def interpret(*args, **kw):
        return orig(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(jfa, "flash_attention", interpret)
    monkeypatch.setattr(jops, "flash_attention", interpret)
    port_warn, jax_warn = _hold_step(
        {"sp": 2}, {"d_model": 256, "n_heads": 2, "use_flash_attention": True,
                    "use_ulysses_attention": True},
        tmp_path, steps=2, batch_size=2, seq=256)
    assert jax_warn == [] and all(w == [] for w in port_warn)

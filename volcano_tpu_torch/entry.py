"""Driver entry points of the port — the counterpart of the JAX package's
`__graft_entry__.py`.

entry(): a forward step of the flagship workload model at tiny shapes
in bf16.  train_entry(): one training step (loss, gradients, clip,
AdamW) at tiny shapes in f32.  dryrun_multichip(n): ONE training step of the tiny
model per parallelism family, each over a mesh of n ranks (the
reference's one-step matrix).  All run on `cuda` unless the caller
passes `device="cpu"`, and raise without a GPU otherwise.

    python -m volcano_tpu_torch.entry [cpu|cuda] [n_devices]
"""

from __future__ import annotations

import os
import queue
import sys
import traceback
from typing import Dict

import torch
import torch.multiprocessing as mp

from volcano_tpu_torch.workloads import bootstrap, pipeline
from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads import train
from volcano_tpu_torch.workloads.device import resolve_device
from volcano_tpu_torch.workloads.mesh import (choose_axis_sizes,
                                              make_hybrid_mesh, make_mesh)

# how long the matrix's ranks may take, all families together
DRYRUN_TIMEOUT_S = 600.0


def entry(device=None):
    """Return (fn, example_args) for a single-device forward step."""
    dev = resolve_device(device)
    cfg = model_lib.tiny_config(dtype=torch.bfloat16)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.zeros((4, 128), dtype=torch.int64, device=dev)

    def fn(params, tokens):
        return model_lib.forward(params, tokens, cfg)

    return fn, (params, tokens)


def train_entry(device=None):
    """Return (step, (params, opt_state, batch)) for one single-device
    training step; step returns (params, opt_state, metrics)."""
    dev = resolve_device(device)
    cfg = model_lib.tiny_config()
    optimizer = train.make_optimizer()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    batch = train.synthetic_batch(
        torch.Generator(device=dev).manual_seed(1), cfg, 4, 64)
    step = train.make_train_step(cfg, optimizer)
    return step, (params, optimizer.init(params), batch)


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _step_loss(axes, cfg_kwargs, device: str, batch_mult: int = 2) -> float:
    """ONE sharded training step on a mesh of `axes` over every rank (a
    'dcn' axis > 1 selects the hybrid two-level mesh), params and batch
    drawn from one torch seed on every rank and in every family, so
    meshes of one model compare the same weights."""
    if axes.get("dcn", 1) > 1:
        mesh = make_hybrid_mesh(axes, device)
    else:
        mesh = make_mesh(axes, device)
    cfg = model_lib.tiny_config(dtype=torch.float32, remat=True,
                                **cfg_kwargs)
    _check(cfg.n_heads % axes["tp"] == 0, (cfg.n_heads, axes))
    optimizer = train.make_optimizer()
    params, opt_state, _ = train.init_sharded(
        torch.Generator().manual_seed(0), cfg, mesh, optimizer)
    batch = train.synthetic_batch(
        torch.Generator().manual_seed(1), cfg,
        batch_size=batch_mult * axes["dp"] * axes["fsdp"]
        * axes.get("dcn", 1),
        seq_len=64 * max(1, axes["sp"]), mesh=mesh)
    step = train.make_train_step(cfg, optimizer, mesh)
    params, opt_state, metrics = step(params, opt_state, batch)
    loss = float(metrics["loss"])
    _check(loss == loss and loss > 0, f"bad loss {loss}")  # not NaN
    return loss


def _pp_step_loss(n_stages: int, pp_mesh) -> float:
    """One pipelined training step on `pp_mesh` (any mesh with a 'pp'
    axis: pipelines of consecutive ranks or a stage per slice); the
    loss."""
    dev = train.mesh_device(pp_mesh)
    cfg = model_lib.tiny_config(dtype=torch.float32, n_layers=n_stages,
                                remat=True)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   dev)
    outer, stage_blocks = pipeline.distribute_stages(
        *pipeline.stack_stage_params(params, n_stages), pp_mesh)
    opt = train.make_optimizer()
    opt_state = opt.init(pipeline.joined(outer, stage_blocks))
    pp_step = pipeline.make_pipelined_train_step(cfg, pp_mesh, opt,
                                                 n_microbatches=4)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    _, _, _, m = pp_step(outer, stage_blocks, opt_state, {"tokens": tokens})
    loss = float(m["loss"])
    _check(loss == loss and loss > 0, f"bad pp loss {loss}")
    return loss


def _pow2_split(n: int):
    """(the power-of-two part of n, the odd rest)."""
    p = 1
    while n % 2 == 0:
        p, n = p * 2, n // 2
    return p, n


def _matrix(n: int, device: str) -> Dict[str, float]:
    """The reference's families and axis choices
    (`__graft_entry__.dryrun_multichip`), each one step over the n ranks
    of the default group, with its two parity asserts."""
    results: Dict[str, float] = {}
    # 1. dp/fsdp/tp: the gradient-sync + param-shard + tp matmul paths
    if n % 8 == 0:
        axes = {"dp": 2, "fsdp": 2, "tp": n // 4, "sp": 1}
    else:
        axes = choose_axis_sizes(n)
    results["dp%d-fsdp%d-tp%d" % (axes["dp"], axes["fsdp"], axes["tp"])] \
        = _step_loss(axes, {}, device)
    # 2. sp: ring attention across sequence shards
    if n % 8 == 0:
        sp_axes = {"dp": 1, "fsdp": 2, "tp": 2, "sp": n // 4}
    else:
        sp_axes = choose_axis_sizes(n, sp=2) if n % 2 == 0 \
            else choose_axis_sizes(n)
    if sp_axes["sp"] > 1:
        results[f"ring-sp{sp_axes['sp']}"] = _step_loss(
            sp_axes, {"use_ring_attention": True}, device)
    if n % 4 == 0 and sp_axes.get("sp", 1) < 4:
        # sp 4: the ring takes several hops; tp and fsdp take powers of
        # two only, any odd rest lands on dp
        rem = n // 4
        tp = 1
        while tp * 2 <= min(4, rem) and rem % (tp * 2) == 0:
            tp *= 2
        fsdp, rem = _pow2_split(rem // tp)
        deep_sp = {"dp": rem, "fsdp": fsdp, "tp": tp, "sp": 4}
        results["ring-sp4-long"] = _step_loss(
            deep_sp, {"use_ring_attention": True}, device)
        # Ulysses: heads per tp shard must divide by sp, so tp 1
        uly = {"dp": rem * tp, "fsdp": fsdp, "tp": 1, "sp": 4}
        results["ulysses-sp4"] = _step_loss(
            uly, {"use_ulysses_attention": True}, device)
    # 2b. dcn: the hybrid two-level mesh, alone and with the ring
    if n % 8 == 0:
        results["dcn2-fsdp2-tp2"] = _step_loss(
            {"dcn": 2, "dp": n // 8, "fsdp": 2, "tp": 2, "sp": 1}, {},
            device)
        results["dcn2-sp2-ring"] = _step_loss(
            {"dcn": 2, "dp": n // 8, "fsdp": 2, "tp": 1, "sp": 2},
            {"use_ring_attention": True}, device)
    # 3. ep: MoE with capacity dispatch, experts over fsdp (the power of
    # two part of n / 2; the odd rest is dp), as many experts as fsdp
    if n % 2 == 0:
        ep_fsdp, rem = _pow2_split(n // 2)
        ep_axes = {"dp": rem, "fsdp": ep_fsdp, "tp": 2, "sp": 1}
        results[f"moe-ep{ep_fsdp}"] = _step_loss(
            ep_axes, {"n_experts": max(4, ep_fsdp), "expert_top_k": 2,
                      "moe_capacity_factor": 1.5}, device)
    # 3b. experts over slices (promoted to dcn x fsdp) against the flat
    # mesh of the same model and batch
    if n % 8 == 0:
        moe_kwargs = {"n_experts": 4, "expert_top_k": 2,
                      "moe_capacity_factor": 1.5}
        flat_moe = _step_loss({"dp": n // 4, "fsdp": 2, "tp": 2, "sp": 1},
                              moe_kwargs, device)
        results["moe-ep4-slices"] = _step_loss(
            {"dcn": 2, "dp": n // 8, "fsdp": 2, "tp": 2, "sp": 1},
            moe_kwargs, device)
        _check(abs(results["moe-ep4-slices"] - flat_moe) < 5e-3,
               (results["moe-ep4-slices"], flat_moe))
    # 4. pp: GPipe over pipeline stages (needs >= 2 ranks; the reference
    # runs it on the first n_stages devices, the port on replicas of the
    # pipeline over all ranks, which changes no value)
    n_stages = 4 if n % 4 == 0 else 2
    if n % n_stages:
        return results
    results[f"gpipe-pp{n_stages}"] = _pp_step_loss(
        n_stages, pipeline.make_pp_mesh(n_stages, device_type=device))
    # 4b. a stage per slice, against the flat pp2 mesh
    if n % 4 == 0:
        flat_pp2 = _pp_step_loss(
            2, pipeline.make_pp_mesh(2, device_type=device))
        results["gpipe-pp2-slices"] = _pp_step_loss(
            2, pipeline.make_pp_mesh_over_slices(2, device_type=device))
        _check(abs(results["gpipe-pp2-slices"] - flat_pp2) < 2e-3,
               (results["gpipe-pp2-slices"], flat_pp2))
    return results


def _dryrun_rank(rank: int, n: int, port: int, device: str, out) -> None:
    """One rank of the matrix: puts ("ok", rank, results) or ("error",
    rank, traceback) on `out`."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        env = {"TPU_WORKER_ID": str(rank), "NUM_PROCESSES": str(n),
               "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "LOCAL_RANK": str(rank)}
        # the store is the parent's: this rank joins it as a client
        os.environ[bootstrap.ENV_AGENT_STORE] = "True"
        bootstrap.initialize(env, device=device, timeout=DRYRUN_TIMEOUT_S)
        try:
            results = _matrix(n, device)
        finally:
            bootstrap.shutdown()
        out.put(("ok", rank, results))
    except BaseException:  # reported to the parent, which raises
        out.put(("error", rank, traceback.format_exc()))
        raise


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """Run ONE training step per parallelism family so every axis runs:
    dp x fsdp x tp, the sp ring (and sp 4, several hops), Ulysses, the
    hybrid dcn mesh alone and with the ring, MoE with its experts over
    fsdp and over slices (against the flat mesh within 5e-3), GPipe over
    pp and a stage per slice (against flat pp2 within 2e-3).

    Spawns n_devices ranks of one process group: gloo on
    `device="cpu"`, nccl on `cuda` (one GPU a rank).  Prints the
    reference's summary line and returns rank 0's losses by family."""
    dev = resolve_device(device).type
    if dev == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda needs "
                           f"{n_devices} GPUs, found "
                           f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    # held until the ranks are joined below
    store = bootstrap.local_store()
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n_devices, store.port, dev, out))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    results, errors = None, []
    try:
        # drained before the joins below (a full queue blocks its writer)
        for _ in range(n_devices):
            kind, rank, payload = out.get(timeout=DRYRUN_TIMEOUT_S)
            if kind == "error":
                errors.append(f"rank {rank}:\n{payload}")
            elif rank == 0:
                results = payload
    except queue.Empty:
        errors.append(f"not every rank reported within "
                      f"{DRYRUN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or results is None:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(errors))
    summary = " ".join(f"{k}:loss={v:.3f}" for k, v in results.items())
    skipped = "" if n_devices % (4 if n_devices % 4 == 0 else 2) == 0 \
        else f" (pp skipped: {n_devices} device(s))"
    print(f"dryrun_multichip({n_devices}): {summary}{skipped}", flush=True)
    return results


if __name__ == "__main__":
    where = sys.argv[1] if len(sys.argv) > 1 else None
    fn, args = entry(where)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    step, args = train_entry(where)
    _, _, metrics = step(*args)
    print("train_entry step: loss %.4f, grad_norm %.4f"
          % (float(metrics["loss"]), float(metrics["grad_norm"])))
    if len(sys.argv) > 2:
        dryrun_multichip(int(sys.argv[2]), where)

"""Pipeline parallelism — the port of `volcano_tpu.workloads.pipeline`:
GPipe over a `pp` mesh axis.

Rank s of the pp group holds stage s: the block stack with a leading
stage dim, sharded over pp (`stack_stage_params`,
`stage_param_shardings`).  Activations flow stage to stage by p2p
sends while M microbatches stream through.

Schedule (S stages, M microbatches, T = M + S - 1 ticks): at tick k
stage s applies its blocks to microbatch k - s, received from stage
s - 1 (stage 0 embeds it in-pipe), and sends the result on.  The
reference computes every stage at every tick and keeps only the last
stage's ticks S - 1 .. T - 1; the port skips the bubble ticks, which
changes no value.  Positions belong to their microbatch, so per-sample
position ids are handled as the reference's ride on the ring.

The backward runs the schedule in reverse: the last stage differentiates
the loss, and each stage, for microbatch M - 1 down to 0, receives the
gradient of its output from the next stage, runs the backward of its
blocks for that microbatch and sends the gradient of its input to the
previous one.  Sends and receives are issued in this fixed order on
every stage, so they pair without relying on the order in which
autograd would visit the hops.  The outer leaves (embed, final_norm,
head) are replicated over pp, as the reference's `P()`; their gradients
arise on stage 0 (embed) and on the last stage (final_norm, head) and
are summed over pp once, so that every stage applies the same update.

On a stage-per-slice mesh (`make_pp_mesh_over_slices`, axes
("pp", "pp_rep")), and on replicas of a pipeline (`make_pp_mesh` over
more ranks than stages), the ranks of one stage compute the same thing
on the same batch, each with its own peers of the other stages;
nothing is averaged over pp_rep.

Scope, as the reference's: dense block stacks (an MoE stack cannot be
leaf-stacked across stages); cfg.remat applies per block.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads import train as train_lib
from volcano_tpu_torch.workloads.device import resolve_device
from volcano_tpu_torch.workloads.mesh import group_by_slice
from volcano_tpu_torch.workloads.model import ModelConfig


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call bootstrap.initialize() "
                           "before building a mesh")
    return dist.get_world_size()


def make_pp_mesh(n_stages: int,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """A ("pp",) mesh over the `n_stages` ranks of the default group.  A
    group of a multiple of n_stages ranks runs as many replicas of the
    pipeline, consecutive ranks a pipeline, over an outer "pp_rep" axis:
    every rank takes part in every step (on nccl, a mesh over some of
    the ranks hung the others' next group)."""
    n = _world()
    if n < n_stages:
        raise ValueError(f"need {n_stages} devices, have {n}")
    if n % n_stages:
        raise ValueError(f"{n} devices not divisible into pipelines of "
                         f"{n_stages} stages")
    dev_type = resolve_device(device_type).type
    if n == n_stages:
        return DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=("pp",))
    return DeviceMesh(dev_type, torch.arange(n).reshape(-1, n_stages),
                      mesh_dim_names=("pp_rep", "pp"))


def make_pp_mesh_over_slices(n_stages: int,
                             device_type: Optional[str] = None,
                             slice_ids: Optional[Sequence[int]] = None
                             ) -> DeviceMesh:
    """Stage-per-slice mesh: pp OUTERMOST over the slices, each stage
    holding one slice whose ranks replicate it over the inner `pp_rep`
    axis, so the activation hops between stages are the only traffic
    that crosses slices.  The ranks of the default group are grouped by
    slice as `mesh.make_hybrid_mesh` groups them (`group_by_slice`: each
    rank's slice id when given, else equal chunks in rank order)."""
    groups = group_by_slice(range(_world()), n_stages, slice_ids)
    arr = np.stack([np.asarray(g) for g in groups])        # [S, per_slice]
    return DeviceMesh(resolve_device(device_type).type, torch.from_numpy(arr),
                      mesh_dim_names=("pp", "pp_rep"))


def stack_stage_params(params: Dict[str, Any], n_stages: int
                       ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Re-layout the model's params for pipelining: blocks[S * B] ->
    per-leaf stacks [S, B, ...], with embed, final_norm and head left
    whole.  Dense stacks only."""
    blocks = params["blocks"]
    if len(blocks) % n_stages != 0:
        raise ValueError(
            f"{len(blocks)} blocks not divisible by {n_stages} stages")
    keys0 = set(blocks[0])
    for i, blk in enumerate(blocks):
        if "router" in blk:
            raise ValueError(
                "pipeline parallelism supports dense block stacks only "
                f"(block {i} is MoE); use dp/fsdp/tp/sp/ep for MoE "
                "models")
        if set(blk) != keys0:
            raise ValueError(
                f"block {i} keys differ from block 0; stages must be "
                "homogeneous to stack")
    per_stage = len(blocks) // n_stages
    stage_blocks = {
        name: torch.stack([
            torch.stack([blocks[s * per_stage + b][name]
                         for b in range(per_stage)])
            for s in range(n_stages)])                   # [S, B, ...]
        for name in blocks[0]}
    outer = {k: v for k, v in params.items() if k != "blocks"}
    return outer, stage_blocks


def stage_param_shardings(stage_blocks, outer, mesh: DeviceMesh):
    """(outer placements, stage placements) on `mesh`: the stage stacks
    sharded on their stage dim over pp, everything else replicated."""
    def place(shard):
        return tuple(Shard(0) if shard and axis == "pp" else Replicate()
                     for axis in mesh.mesh_dim_names)
    return ({k: place(False) for k in outer},
            {k: place(True) for k in stage_blocks})


def distribute_stages(outer, stage_blocks, mesh: DeviceMesh):
    """(outer, stage_blocks) as DTensors laid out by
    `stage_param_shardings`; every rank passes the same whole tensors
    and keeps its shard only."""
    outer_sh, stage_sh = stage_param_shardings(stage_blocks, outer, mesh)

    def put(tree, placements):
        return {k: distribute_tensor(x, mesh, placements[k],
                                     src_data_rank=None)
                for k, x in tree.items()}
    return put(outer, outer_sh), put(stage_blocks, stage_sh)


def joined(outer, stage_blocks) -> Dict[str, Any]:
    """One param-structured tree of both, the stage stacks as its one
    block: what `train.AdamW` takes as params, grads and state."""
    return dict(outer, blocks=[stage_blocks])


def _apply_stage(x, blocks, cfg: ModelConfig, positions):
    """This rank's blocks (a list of the model's block dicts) over x,
    as model.forward_with_aux applies them (cfg.remat included)."""
    return model_lib._apply_blocks(x, blocks, cfg, positions,
                                   model_lib._Axes())[0]


class _Stage:
    """This rank's place in the pp group: its stage, the stage count and
    the global ranks of its neighbours."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("pp")
        self.n = mesh.size(mesh.mesh_dim_names.index("pp"))
        self.s = mesh.get_local_rank("pp")
        self.first, self.last = self.s == 0, self.s == self.n - 1

    def peer(self, step: int) -> int:
        return dist.get_global_rank(self.group, self.s + step)

    def send(self, x, step: int) -> None:
        dist.send(x.contiguous(), self.peer(step), group=self.group)

    def recv(self, like, step: int):
        buf = torch.empty_like(like)
        dist.recv(buf, self.peer(step), group=self.group)
        return buf


def _pipe_forward(stage: _Stage, inject, blocks, cfg: ModelConfig,
                  positions, n_microbatches: int, mb_shape, dtype, device):
    """The forward schedule on this rank: for each microbatch, its input
    (a leaf that records its gradient, except on stage 0, where
    `inject(m)` embeds it) and the stage's output."""
    ins, outs = [], []
    for m in range(n_microbatches):
        if stage.first:
            x = inject(m)
        else:
            x = stage.recv(torch.empty(mb_shape, dtype=dtype, device=device),
                           -1)
            x.requires_grad_(torch.is_grad_enabled())
        out = _apply_stage(x, blocks, cfg, positions[m])
        if not stage.last:
            stage.send(out.detach(), 1)
        ins.append(x)
        outs.append(out)
    return ins, outs


def _pipe_backward(stage: _Stage, ins, outs) -> None:
    """The backward schedule, microbatch M - 1 down to 0: the gradient of
    each output arrives from the next stage (the last stage's outputs
    were differentiated with the loss already), the stage's blocks run
    their backward, and the gradient of the input goes back."""
    for m in reversed(range(len(outs))):
        if not stage.last:
            torch.autograd.backward(outs[m], stage.recv(outs[m], 1))
        if not stage.first:
            stage.send(ins[m].grad, -1)


def _split(x, n_microbatches: int):
    b = x.shape[0]
    if b % n_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by "
                         f"{n_microbatches} microbatches")
    return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])


def _local_blocks(stage_blocks, grads: bool = False):
    """This rank's stage as a list of B block dicts, views of each leaf's
    local [1, B, ...] shard; with `grads`, each a leaf of its own that
    records its gradient (so a block's backward adds into its own
    gradient, not into a zeroed copy of the whole stack)."""
    local = {k: train_lib.local(x).detach()[0]
             for k, x in stage_blocks.items()}
    per_stage = next(iter(local.values())).shape[0]
    return [{k: x[b].requires_grad_(grads) for k, x in local.items()}
            for b in range(per_stage)]


@torch.no_grad()
def pipelined_apply_blocks(x, stage_blocks, cfg: ModelConfig, positions,
                           mesh: DeviceMesh, n_microbatches: int):
    """x [b, t, d] (embedded), positions [b, t] -> [b, t, d] after ALL
    blocks with the GPipe schedule, on every rank of the pp group.
    n_microbatches must divide b.  Each microbatch keeps its own
    positions, so per-sample position ids are handled correctly."""
    b, t, d = x.shape
    stage = _Stage(mesh)
    x_mb, pos_mb = _split(x, n_microbatches), _split(positions,
                                                     n_microbatches)
    _, outs = _pipe_forward(stage, lambda m: x_mb[m],
                            _local_blocks(stage_blocks), cfg, pos_mb,
                            n_microbatches, x_mb.shape[1:], x.dtype,
                            x.device)
    out = torch.cat(outs) if stage.last else x.new_empty((b, t, d))
    dist.broadcast(out, stage.peer(stage.n - 1 - stage.s), group=stage.group)
    return out


def _outer_loss(outer, x, tokens, cfg: ModelConfig):
    return model_lib.next_token_loss(
        model_lib._logits(x, outer, cfg, model_lib._Axes()), tokens)


def _run(outer, stage_blocks, tokens, cfg: ModelConfig, mesh: DeviceMesh,
         n_microbatches: int, grads: bool):
    """The pipelined loss on every rank of the pp group; with `grads`,
    also this rank's gradients of `outer` (summed over pp) and of its
    stage's leaves (local [1, B, ...], as the stage shards)."""
    stage = _Stage(mesh)
    tokens_mb = _split(tokens, n_microbatches)
    mb, t = tokens_mb.shape[1:]
    positions = torch.arange(t, device=tokens.device)[None, :] \
        .expand(n_microbatches, mb, t)
    outer_l = {k: train_lib.local(x).detach().requires_grad_(grads)
               for k, x in outer.items()}
    blocks = _local_blocks(stage_blocks, grads)

    with torch.set_grad_enabled(grads):
        table = outer_l["embed"].to(cfg.dtype)

        def inject(m):
            return table[tokens_mb[m]]

        ins, outs = _pipe_forward(stage, inject, blocks, cfg, positions,
                                  n_microbatches, (mb, t, cfg.d_model),
                                  cfg.dtype, tokens.device)
        if stage.last:
            loss = _outer_loss(outer_l, torch.cat(outs), tokens, cfg)
            if grads:
                loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=tokens.device)
        if grads:
            _pipe_backward(stage, ins, outs)
    dist.broadcast(loss, stage.peer(stage.n - 1 - stage.s),
                   group=stage.group)
    if not grads:
        return loss, None, None
    g_outer = {k: x.grad if x.grad is not None else torch.zeros_like(x)
               for k, x in outer_l.items()}
    flat = torch.cat([g.reshape(-1) for g in g_outer.values()])
    dist.all_reduce(flat, group=stage.group)
    for g, piece in zip(g_outer.values(),
                        flat.split([g.numel() for g in g_outer.values()])):
        g.copy_(piece.view_as(g))
    return loss, g_outer, {
        k: torch.stack([blk[k].grad for blk in blocks])[None]
        for k in blocks[0]}


@torch.no_grad()
def pipelined_loss(outer, stage_blocks, tokens, cfg: ModelConfig,
                   mesh: DeviceMesh, n_microbatches: int) -> torch.Tensor:
    """The full LM loss with the block stack pipelined over pp, on every
    rank of the pp group.  Only the token ids are replicated across
    stages: embedding happens in-pipe on stage 0, so no rank holds the
    whole embedded batch.  `pipelined_value_and_grad` differentiates
    it."""
    return _run(outer, stage_blocks, tokens, cfg, mesh, n_microbatches,
                False)[0]


def pipelined_value_and_grad(outer, stage_blocks, tokens, cfg: ModelConfig,
                             mesh: DeviceMesh, n_microbatches: int):
    """(loss, outer grads, stage grads) of `pipelined_loss`: outer grads
    whole and equal on every rank, stage grads this rank's local
    [1, B, ...] shard, as plain tensors."""
    return _run(outer, stage_blocks, tokens, cfg, mesh, n_microbatches,
                True)


def _global_norm(g_outer, g_stage, mesh: DeviceMesh) -> torch.Tensor:
    """The global norm of (outer, stage_blocks)' gradients: the stage
    leaves' squares summed over pp, the outer leaves (equal on every
    stage) counted once."""
    stage_sq = torch.stack([g.float().square().sum()
                            for g in g_stage.values()]).sum()
    dist.all_reduce(stage_sq, group=mesh.get_group("pp"))
    outer_sq = torch.stack([g.float().square().sum()
                            for g in g_outer.values()]).sum()
    return (stage_sq + outer_sq).sqrt()


def make_pipelined_train_step(cfg: ModelConfig, mesh: DeviceMesh,
                              optimizer: train_lib.AdamW,
                              n_microbatches: int):
    """step(outer, stage_blocks, opt_state, batch) -> (outer,
    stage_blocks, opt_state, metrics): the pipelined loss's value and
    gradients, the global norm's clip and AdamW (`optimizer`, whose
    state is `optimizer.init(joined(outer, stage_blocks))`), applied in
    place to this rank's shards.  Metrics: `loss` and `grad_norm` (the
    same on every rank of the pp group)."""

    def step(outer, stage_blocks, opt_state, batch):
        loss, g_outer, g_stage = pipelined_value_and_grad(
            outer, stage_blocks, batch["tokens"], cfg, mesh, n_microbatches)
        g_norm = _global_norm(g_outer, g_stage, mesh)
        optimizer.update(joined(outer, stage_blocks),
                         joined(g_outer, g_stage), opt_state, g_norm)
        return outer, stage_blocks, opt_state, {"loss": loss,
                                                "grad_norm": g_norm}

    return step

"""Ulysses-style sequence parallelism — the port of
`volcano_tpu.workloads.ulysses`.

Two all-to-alls over the sp process group re-partition the problem so
every rank runs ordinary full-sequence causal attention on a head
subset (DeepSpeed-Ulysses):

  [b, t/sp, h, d]  --all_to_all(seq<-heads)-->  [b, t, h/sp, d]
       full-sequence causal attention on h/sp heads
  [b, t, h/sp, d]  --all_to_all(heads<-seq)-->  [b, t/sp, h, d]

Because each rank sees the whole sequence for its heads, the inner
attention can be the hand-written flash kernels (`use_flash`).  The
exchange is `all_to_all_single` on a contiguous buffer inside
`AllToAll`, whose backward is the inverse exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from volcano_tpu_torch.workloads.ops.flash_attention import flash_attention
from volcano_tpu_torch.workloads.ring_attention import local_causal_attention


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """The tiled all-to-all of `lax.all_to_all(..., tiled=True)`: x is
    cut into n chunks along split_dim, chunk j goes to rank j of
    `group`, and the chunks received are concatenated along concat_dim
    in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class AllToAll(torch.autograd.Function):
    """`all_to_all`; the backward is the inverse exchange (split and
    concatenate swapped)."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (all_to_all(grad, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def ulysses_attention(q, k, v, group, use_flash: bool = False):
    """Causal attention over the sp process group `group` (None: one
    rank); q/k/v: [b, t_local, h_local, d] with h_local % sp == 0.
    Returns [b, t_local, h_local, d]."""
    sp = 1 if group is None else dist.get_world_size(group)
    if sp == 1:
        return local_causal_attention(q, k, v)
    # heads split over the ranks, the sequence chunks received
    # concatenated in rank order: the global sequence in token order
    qg, kg, vg = (AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    if use_flash:
        og = flash_attention(qg, kg, vg)
    else:
        og = local_causal_attention(qg, kg, vg)
    # back to all heads on the local sequence shard
    return AllToAll.apply(og, group, 1, 2)

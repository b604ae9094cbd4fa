"""Mixture-of-experts layer — the port of `volcano_tpu.workloads.moe`.

Every other block's MLP is a routed layer of `n_experts` SwiGLU experts:
top-k routing on an f32 softmax of `x @ router` with the GShard
load-balancing auxiliary loss (`_route`), and two dispatch modes
(`moe_mlp`'s capacity_factor):

- 0 (dense): every expert sees every token, combined by the routing
  weights; exact.
- > 0 (GShard capacity): each expert takes at most
  C = ceil(cf * t * k / E) tokens of a row, positions counted along the
  sequence choice by choice; overflow tokens are dropped (weight 0).

The reference writes capacity dispatch as one-hot [b, t, E, C] einsums.
The port dispatches by index: each slot of the [E, b, C, d] expert
input gathers the one token that holds it (or a zero row), and each
token gathers its k outputs back, weighted by the combine weights cast
to the activation dtype, summed in f32 and rounded once, as the
reference's combine product does.  A slot takes exactly one token or
none, so it is the same function without the one-hot tensors.

Expert parallelism (`ax`, the model's `_Axes`): expert leaves are
sharded on their expert dim over the ep group (fsdp, or dcn x fsdp when
`model.param_specs` promotes them) and are never gathered.  Tokens move
to the experts instead: each rank dispatches its own rows into
[E, b_local, C, d], one all-to-all over ep gives it
[E / ep, ep * b_local, C, d] for its experts, and the reverse all-to-all
returns the outputs to their rows (the reference's "token -> expert
regroup is the all_to_all boundary").  Under tp each expert's ff dim is
split as the dense MLP's is: Megatron's f before the experts (on the
tokens and on the combine weights, whose gradient each tp rank holds
only for its own columns' path) and one g after the combine, on
[b, t, d].  Under sp each rank routes its block of the sequence:
capacity positions are offset by the earlier sp ranks' per-expert
counts, and the aux loss uses the global token fractions (see `_route`).
A slot is then filled by one sp rank only, so the ranks' buffers are
summed over sp and each keeps 1/sp of the slots (a reduce-scatter along
the capacity dim): each slot's expert work is done once, and the
outputs come back by the matching all-gather.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from volcano_tpu_torch.workloads.ulysses import AllToAll


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, scale: float,
                    device=None) -> Dict[str, torch.Tensor]:
    """The router [d, E] and the experts' SwiGLU weights [E, d, ff],
    [E, d, ff], [E, ff, d], f32, drawn from `generator` on its own device
    and moved to `device` (default: the generator's)."""
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(*shape, std):
        return (torch.randn(shape, generator=generator, device=gdev)
                * std).to(device)

    return {
        "router": normal(d_model, n_experts, std=scale),
        "moe_gate": normal(n_experts, d_model, d_ff, std=scale),
        "moe_up": normal(n_experts, d_model, d_ff, std=scale),
        "moe_down": normal(n_experts, d_ff, d_model, std=d_ff ** -0.5),
    }


# each expert leaf's mesh axis per dim (merged into model._PARAM_SPECS):
# expert dim over fsdp (expert parallelism), ff dim over tp
MOE_PARAM_SPECS = {
    "router": ("fsdp", None),
    "moe_gate": ("fsdp", None, "tp"),
    "moe_up": ("fsdp", None, "tp"),
    "moe_down": ("fsdp", "tp", None),
}

# leaves whose leading dim is the expert dim: on a hybrid (dcn) mesh
# `model.param_specs` promotes it to (dcn, fsdp) when the expert count
# divides (the router's leading dim is d_model, so it stays per slice)
EXPERT_DIM_PARAMS = frozenset({"moe_gate", "moe_up", "moe_down"})


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, in
    `jax.lax.top_k`'s order: descending, ties to the lower index (a
    stable sort; `torch.topk` does not promise the order of ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, n_experts: int, k: int, ax=None):
    """(probs [b, t, E] f32, top_vals [b, t, k], top_idx [b, t, k], aux).

    The aux loss is E * sum(token_frac * prob_frac), both means over the
    global (b, t).  On a mesh each rank holds some rows and a block of
    the sequence, and the step takes the mean of its loss over the data
    axes and the sum over sp.  So token_frac (no gradient) is averaged
    over every rank of the mesh (tp ranks hold equal copies), and
    prob_frac stays the rank's own mean divided by sp: after the step's
    reductions the aux is the reference's, and so is its gradient."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, k)
    if k > 1:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    # k == 1 keeps the raw prob as the combine weight (Switch style):
    # renormalising to 1.0 would cut the router off from the LM loss

    # token_frac normalised by k, so the uniform-routing floor is 1.0
    token_frac = F.one_hot(top_idx, n_experts).float().sum(2) \
        .mean(dim=(0, 1)) / k
    prob_frac = probs.mean(dim=(0, 1))
    if ax is not None and ax.tokens is not None:
        dist.all_reduce(token_frac, group=ax.tokens)
        token_frac = token_frac / ax.tokens_size
        prob_frac = prob_frac / ax.sp_size
    aux = n_experts * (token_frac * prob_frac).sum()
    return probs, top_vals, top_idx, aux


def _expert_ffn(ei, blk, dtype):
    """ei: [E, b, C, d] -> [E, b, C, d] through each expert's SwiGLU."""
    gate = F.silu(torch.einsum("ebcd,edf->ebcf", ei,
                               blk["moe_gate"].to(dtype)))
    up = torch.einsum("ebcd,edf->ebcf", ei, blk["moe_up"].to(dtype))
    return torch.einsum("ebcf,efd->ebcd", gate * up,
                        blk["moe_down"].to(dtype))


def _experts(expert_in, blk, dtype, ax):
    """The experts on [E, b_local, C, d]: under ep the rows go to the
    ranks that hold their experts and the outputs come back."""
    ep = None if ax is None else ax.ep
    if ep is not None:
        expert_in = AllToAll.apply(expert_in, ep, 0, 1)
    out = _expert_ffn(expert_in, blk, dtype)
    if ep is not None:
        out = AllToAll.apply(out, ep, 1, 0)
    return out


def _positions(top_idx, n_experts: int, capacity: int, width: int, ax):
    """Each token's slot in the [E, width] buffer of each of its k
    experts, and whether it is kept: the reference's counting (a cumsum
    over the sequence a choice, after the tokens every earlier choice
    kept), over the global sequence.  Under sp the sequence is split, so
    each choice's positions are offset by the earlier sp ranks' counts,
    and the tokens an expert kept of a choice come from all of them."""
    masks = F.one_hot(top_idx, n_experts).float()        # [b, t, k, E]
    mine = masks.sum(dim=1)                              # [b, k, E]
    before, total = torch.zeros_like(mine), mine
    if ax is not None and ax.sp is not None:
        every = mine.new_empty((ax.sp_size,) + tuple(mine.shape))
        dist.all_gather_into_tensor(every.flatten(0, 1), mine.contiguous(),
                                    group=ax.sp)
        before = every[:ax.sp_rank].sum(dim=0)
        total = every.sum(dim=0)
    counts = torch.zeros_like(mine[:, 0])                # [b, E]
    slots, kept = [], []
    for i in range(top_idx.shape[-1]):
        mask = masks[:, :, i]                            # [b, t, E]
        pos = torch.cumsum(mask, dim=1) - mask + \
            (counts + before[:, i])[:, None, :]
        # the positions this choice fills run on from counts, so the
        # tokens kept are those below the capacity
        counts = counts + torch.minimum(
            total[:, i], (capacity - counts).clamp(min=0))
        here = (pos * mask).sum(dim=-1)                  # [b, t]
        slots.append(top_idx[..., i] * width + here.long())
        kept.append(here < capacity)
    return slots, kept


def moe_mlp(x, blk, n_experts: int, top_k: int = 2,
            capacity_factor: float = 0.0, ax=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, t, d] -> (y [b, t, d], aux_loss scalar).

    `blk` holds the router (whole, as the forward gathers it) and this
    rank's expert leaves.  capacity_factor == 0: dense dispatch (every
    expert sees every token).  capacity_factor > 0: each expert
    processes at most C = ceil(cf * t * k / E) tokens of a row, t the
    global sequence length; overflow tokens are dropped.  `ax` (the
    model's `_Axes`, None on one device) carries the ep, tp and sp
    groups."""
    dtype = x.dtype
    k = min(top_k, n_experts)  # a 1-expert model must not crash top_k
    probs, top_vals, top_idx, aux = _route(x, blk["router"], n_experts, k,
                                           ax)
    if ax is not None:
        x, top_vals = ax.copy_to_tp(x), ax.copy_to_tp(top_vals)

    if capacity_factor <= 0:
        combine = torch.zeros_like(probs)
        for i in range(k):
            combine = combine + F.one_hot(
                top_idx[..., i], n_experts).float() * top_vals[..., i:i + 1]
        # every expert sees the whole sequence (t plays the capacity role)
        expert_out = _experts(x.expand(n_experts, *x.shape), blk, dtype, ax)
        y = torch.einsum("ebtd,bte->btd", expert_out, combine.to(dtype))
        return (y if ax is None else ax.reduce_from_tp(y)), aux

    b, t, d = x.shape
    sp = 1 if ax is None else ax.sp_size
    capacity = max(1, int(math.ceil(capacity_factor * sp * t * k
                                    / n_experts)))
    # each expert's slots, rounded up to a multiple of sp so that every
    # sp rank keeps as many of them (the extra ones stay empty)
    width = -(-capacity // sp) * sp
    slots, kept = _positions(top_idx, n_experts, capacity, width, ax)
    n_slots = n_experts * width
    # each slot's token: index t (a zero row) where none is; a dropped
    # token writes to the spare column n_slots, which is cut off
    src = torch.full((b, n_slots + 1), t, dtype=torch.long, device=x.device)
    rows = torch.arange(t, device=x.device).expand(b, t)
    weights = []
    for i in range(k):
        # the reference dispatches where the combine weight is > 0
        go = kept[i] & (top_vals[..., i] > 0)
        src.scatter_(1, torch.where(go, slots[i], n_slots), rows)
        weights.append(top_vals[..., i] * go)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    expert_in = torch.gather(
        x_pad, 1, src[:, :n_slots, None].expand(b, n_slots, d))
    expert_in = expert_in.view(b, n_experts, width, d).transpose(0, 1)
    if ax is not None:
        # each rank runs the experts on its width / sp of the slots
        expert_in = ax.scatter_over_sp(expert_in, 2)
    expert_out = _experts(expert_in, blk, dtype, ax)     # [E, b, W, d]
    if ax is not None:
        expert_out = ax.gather_over_sp(expert_out, 2)
    flat = expert_out.transpose(0, 1).reshape(b, n_slots, d)
    y = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for i in range(k):
        idx = torch.where(kept[i], slots[i], 0)
        out = torch.gather(flat, 1, idx[..., None].expand(b, t, d))
        y = y + weights[i].to(dtype).float()[..., None] * out.float()
    y = y.to(dtype)
    return (y if ax is None else ax.reduce_from_tp(y)), aux

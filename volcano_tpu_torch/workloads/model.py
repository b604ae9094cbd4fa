"""Flagship validation workload: decoder-only transformer LM in PyTorch.

The port of `volcano_tpu.workloads.model`'s forward.  Parameters stay a
dict with the JAX pytree's names and layout: every `W` is [d_in, d_out]
and is applied as `x @ W`, kept in f32 and cast to the activation dtype
at use.  Attention goes through the flash kernel
(`ops.flash_attention`) when `cfg.use_flash_attention`, else through the
eager `local_causal_attention`.

`cfg.remat` runs each block under `torch.utils.checkpoint` (the
counterpart of `jax.checkpoint` with the nothing-saveable policy) when
gradients are being recorded; without them it changes nothing.
`next_token_loss` and `loss_fn` are the training objective.

Sharding follows the reference's `_PARAM_SPECS`: `param_specs` gives
each leaf its axes, `param_shardings` its DTensor placements on a
(dp, fsdp, tp, sp) or (dcn, dp, fsdp, tp, sp) `DeviceMesh`, and
`distribute` lays a param tree out by them.  With a mesh, the forward
runs on this rank's local shards (plain tensors, so the flash kernels
never see a DTensor) and spells out what GSPMD inserts for the
reference: each weight is all-gathered over fsdp at its use (its
gradient comes back reduce-scattered); under tp the Megatron layout,
q/k/v, w_gate and w_up column-sharded and wo and w_down row-sharded
ending in an all-reduce over tp, with attention on the rank's
n_heads / tp heads; the embedding table gathered whole for the lookup;
the head's vocab-sharded logits gathered over tp before the loss.  The
residual stream stays full width and replicated over tp by construction
(the reference anchors it with `_constrain_residual`, a sharding
constraint that local tensors do not need).

Under sp each rank holds its block of the sequence (tokens
[b_local, t / sp], positions offset by its sp rank) and attention
follows the reference's branch order (`_attention`): Ulysses, else the
ring, else flash on one sequence shard (sp = 1), else the eager path on
the keys all-gathered over sp.  The loss rolls its targets over the
global sequence (`next_token_loss` with the sp group).  Ring and
Ulysses flags do nothing without sp > 1, as in the reference with
mesh=None.

Mixture-of-experts (`cfg.n_experts > 0`): every odd block's MLP is a
routed layer (`moe.moe_mlp`), dense or GShard capacity dispatch.  Its
expert leaves are sharded on their expert dim over fsdp, or over
(dcn, fsdp) on a hybrid mesh when the expert count divides
(`param_specs`), and are never gathered: the tokens go to the experts
by an all-to-all over that group (`_Axes.ep`), and the router is an
ordinary fsdp weight.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.checkpoint import checkpoint

from volcano_tpu_torch.workloads.mesh import sub_mesh
from volcano_tpu_torch.workloads.moe import (EXPERT_DIM_PARAMS,
                                             MOE_PARAM_SPECS,
                                             init_moe_params, moe_mlp)
from volcano_tpu_torch.workloads.ops.flash_attention import flash_attention
from volcano_tpu_torch.workloads.ring_attention import (
    local_causal_attention, ring_attention, ring_shift)
from volcano_tpu_torch.workloads.spans import mark_in, mark_out, span
from volcano_tpu_torch.workloads.ulysses import ulysses_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # Mixture-of-experts: every other block's MLP is a routed expert
    # layer (experts sharded over fsdp x tp); 0 = dense model.  > 0
    # capacity factor switches dense dispatch to GShard capacity
    # dispatch (each expert takes at most ceil(cf * t * k / E) tokens)
    n_experts: int = 0
    expert_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 0.0
    use_ring_attention: bool = False
    use_ulysses_attention: bool = False
    # hand-written CUDA flash-attention kernel (the reference's dispatch:
    # shapes that don't block-align take the plain path)
    use_flash_attention: bool = False
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tiny_config(**overrides) -> ModelConfig:
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                d_ff=128, max_seq=128, dtype=torch.float32, remat=False)
    base.update(overrides)
    return ModelConfig(**base)


def flagship_config(**overrides) -> ModelConfig:
    """The `wide` config of the repo's training bench (d2048-L8): vocab
    32000, d_model 2048, 8 layers, 16 heads of 128, d_ff 8192, t 2048,
    bf16, flash attention."""
    base = dict(vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
                d_ff=8192, max_seq=2048, dtype=torch.bfloat16,
                use_flash_attention=True, remat=False)
    base.update(overrides)
    return ModelConfig(**base)


def flagship_moe_config(**overrides) -> ModelConfig:
    """The flagship's widths with the MoE settings of the reference's
    one-step matrix (`__graft_entry__.py:187`): 4 experts in the odd
    layers, top-2, capacity factor 1.5."""
    base = dict(n_experts=4, expert_top_k=2, moe_capacity_factor=1.5)
    base.update(overrides)
    return flagship_config(**base)


def _is_moe_block(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.n_experts > 0 and layer_idx % 2 == 1


# -- parameters -------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random f32 params in the reference's layout, drawn from
    `generator` on its own device and moved to `device` (default: the
    generator's).  torch cannot reproduce `jax.random`: to compare with
    the JAX model, load its params through `convert.params_from_jax`."""
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(*shape, std):
        return (torch.randn(shape, generator=generator, device=gdev)
                * std).to(device)

    def ones(n):
        return torch.ones(n, device=device)

    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab_size, d, std=scale),
        "final_norm": ones(d),
        "head": normal(d, cfg.vocab_size, std=scale),
        "blocks": [],
    }
    for i in range(cfg.n_layers):
        block = {
            "attn_norm": ones(d),
            "wq": normal(d, d, std=scale),
            "wk": normal(d, d, std=scale),
            "wv": normal(d, d, std=scale),
            "wo": normal(d, d, std=scale),
            "mlp_norm": ones(d),
        }
        if _is_moe_block(cfg, i):
            block.update(init_moe_params(generator, d, f, cfg.n_experts,
                                         scale, device))
        else:
            block.update({
                "w_gate": normal(d, f, std=scale),
                "w_up": normal(d, f, std=scale),
                "w_down": normal(f, d, std=f ** -0.5),
            })
        params["blocks"].append(block)
    return params


# -- sharding ---------------------------------------------------------

# each leaf's mesh axis per dim (None: not sharded), as the reference's
# PartitionSpecs, the MoE leaves' included
_PARAM_SPECS: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("tp", "fsdp"),
    "final_norm": (None,),
    "head": ("fsdp", "tp"),
    "attn_norm": (None,),
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "mlp_norm": (None,),
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    **MOE_PARAM_SPECS,
}


def map_named(fn: Callable[[str, Any], Any],
              tree: Dict[str, Any]) -> Dict[str, Any]:
    """A dict of the param tree's structure with fn(leaf name, leaf)."""
    out: Dict[str, Any] = {k: fn(k, v) for k, v in tree.items()
                           if k != "blocks"}
    if "blocks" in tree:
        out["blocks"] = [{k: fn(k, v) for k, v in blk.items()}
                         for blk in tree["blocks"]]
    return out


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else {}


def expert_axes(n_experts: int, mesh=None) -> Tuple[str, ...]:
    """The mesh axes an expert leaf's expert dim shards over, the
    expert-parallel group: (dcn, fsdp) on a hybrid mesh when the expert
    count divides over them (experts over slices), else fsdp."""
    sizes = _sizes(mesh)
    n = sizes.get("dcn", 1) * sizes.get("fsdp", 1)
    if sizes.get("dcn", 1) > 1 and n_experts % n == 0:
        return ("dcn", "fsdp")
    return ("fsdp",)


def _spec(name: str, leaf, mesh) -> Tuple[Any, ...]:
    spec = _PARAM_SPECS.get(name, (None,))
    if name in EXPERT_DIM_PARAMS and \
            expert_axes(leaf.shape[0], mesh) != ("fsdp",):
        spec = (("dcn", "fsdp"),) + spec[1:]
    return spec


def param_specs(params, mesh=None) -> Dict[str, Any]:
    """The spec tree of a param tree: each leaf's tuple of mesh axes, one
    a dim, as the reference's `param_specs` gives its PartitionSpecs.
    Dense params never name dcn: they are replicated across slices, and
    the gradient mean carries the one cross-slice reduction.  On a
    hybrid mesh the expert dim of the MoE expert leaves is promoted from
    fsdp to (dcn, fsdp) when the expert count divides (`expert_axes`):
    each slice holds E / (dcn fsdp) experts, and the token regroup's
    all-to-all is the only expert traffic crossing dcn."""
    return map_named(lambda name, leaf: _spec(name, leaf, mesh), params)


def placements(spec, mesh) -> tuple:
    """DTensor placements on `mesh` of a spec: Shard(i) on each mesh dim
    that the spec names at tensor dim i, Replicate on the others."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(params, mesh) -> Dict[str, Any]:
    """Each leaf's DTensor placements on `mesh` (`param_specs`)."""
    return map_named(lambda _, spec: placements(spec, mesh),
                     param_specs(params, mesh))


def distribute(tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A param-structured tree (params, or AdamW's mu or nu), the same
    whole tensors on every rank, as DTensors laid out by
    `param_shardings`: each rank keeps a copy of its shard only.
    Raises unless every sharded dim divides over its axes."""
    sizes = _sizes(mesh)

    def shard(name, x):
        spec = _spec(name, x, mesh)
        for dim, axes in enumerate(spec):
            n = 1
            for axis in (axes if isinstance(axes, tuple) else (axes,)):
                n *= sizes.get(axis, 1) if axis else 1
            if x.shape[dim] % n:
                raise ValueError(f"{name} {tuple(x.shape)}: dim {dim} does "
                                 f"not divide over {axes} ({n} ranks)")
        return distribute_tensor(x, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return map_named(shard, tree)


class _Axes:
    """The fsdp, tp and sp process groups the forward's collectives run
    over; None for an axis of size 1 (and for all without a mesh), where
    the collectives are skipped.  `sp_rank` is this rank's block of the
    sequence.  With an MoE `cfg`: `ep`, the expert-parallel group
    (`expert_axes`), and `tokens`, every rank of the mesh, over which
    the aux loss's token fractions are averaged (`moe._route`)."""

    def __init__(self, mesh=None, cfg: Optional[ModelConfig] = None):
        sizes = _sizes(mesh)

        def group(axis):
            return mesh.get_group(axis) if sizes.get(axis, 1) > 1 else None

        self.fsdp, self.tp, self.sp = group("fsdp"), group("tp"), group("sp")
        self.tp_size = sizes.get("tp", 1)
        self.sp_size = sizes.get("sp", 1)
        self.sp_rank = mesh.get_local_rank("sp") if self.sp else 0
        self.ep = self.tokens = None
        self.tokens_size = 1
        if mesh is not None and cfg is not None and cfg.n_experts > 0:
            axes = expert_axes(cfg.n_experts, mesh)
            if math.prod(sizes[a] for a in axes) > 1:
                self.ep = sub_mesh(mesh, axes, "ep").get_group()
            if mesh.size() > 1:
                self.tokens = sub_mesh(mesh, mesh.mesh_dim_names,
                                       "moe_tokens").get_group()
                self.tokens_size = mesh.size()

    def copy_to_tp(self, x):
        return _copy_to_tp(x, self)

    def reduce_from_tp(self, x):
        return _reduce_from_tp(x, self)

    def scatter_over_sp(self, x, dim: int):
        """The sum of the sp ranks' x, this rank's chunk along `dim`."""
        return x if self.sp is None else _Scatter.apply(x, dim, self.sp)

    def gather_over_sp(self, x, dim: int):
        """The sp ranks' chunks of `scatter_over_sp` put back together,
        on every sp rank (each uses its own part of the gradient)."""
        return x if self.sp is None else _Gather.apply(x, dim, self.sp, True)


def _all_gather(x, dim: int, group):
    """x's shards over `group` concatenated along `dim`."""
    n = dist.get_world_size(group)
    # the shards stacked along a new leading dim, passed as their
    # concatenation along dim 0 as the collective takes them
    buf = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(buf.flatten(0, 1), x.contiguous(),
                                group=group)
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(x, dim: int, group):
    """x summed over `group`, this rank's chunk along `dim`."""
    chunks = x.chunk(dist.get_world_size(group), dim=dim)
    out = x.new_empty(chunks[0].shape)
    # contiguous: cat keeps a channels-last-like layout of its inputs
    # (an attention gradient has one), which the collective would read
    # as if it were row-major
    dist.reduce_scatter_tensor(out, torch.cat(chunks).contiguous(),
                               group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather x along `dim` over `group`.  Backward: with `partial`,
    each rank holds its own part of the gradient (its own rows of the
    batch), so the pieces are summed and scattered (reduce-scatter);
    without, every rank holds the same gradient and keeps its chunk."""

    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.partial:
            n = dist.get_world_size(ctx.group)
            return (grad.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
                    .contiguous(), None, None, None)
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter x along `dim` over `group`: the sum over the ranks,
    this rank's chunk.  Backward: the chunks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


class _CopyToTp(torch.autograd.Function):
    """Identity forward; backward the sum over tp of the gradient, which
    each tp rank holds only for its own columns' path (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTp(torch.autograd.Function):
    """The sum over tp of a row-parallel product's partial sums; the
    backward passes the (tp-replicated) gradient through (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _use(w, name: str, ax: _Axes, whole: bool = False):
    """A weight at its use: this rank's shard gathered over fsdp, and
    with `whole` over tp too (the embedding's lookup)."""
    for dim, axis in enumerate(_PARAM_SPECS[name]):
        if axis == "fsdp" and ax.fsdp is not None:
            w = _Gather.apply(w, dim, ax.fsdp, True)
        elif axis == "tp" and whole and ax.tp is not None:
            w = _Gather.apply(w, dim, ax.tp, False)
    return w


def _copy_to_tp(x, ax: _Axes):
    return x if ax.tp is None else _CopyToTp.apply(x, ax.tp)


def _reduce_from_tp(x, ax: _Axes):
    return x if ax.tp is None else _ReduceFromTp.apply(x, ax.tp)


# -- forward ----------------------------------------------------------

def _part(name: str, backward: bool = True):
    """Runs fn(x, ...) as the model's part `name` (`spans`): inside its
    profiler range, and with `backward` its `.bwd` range over the
    autograd nodes the call makes."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(x, *args, **kwargs):
            with span(name):
                bwd = mark_in(x, name) if backward else None
                return mark_out(fn(x, *args, **kwargs), bwd)
        return run
    return wrap


@_part("vtp::cast")
def _cast(w, dtype):
    """An f32 weight in the activation dtype at its use."""
    return w.to(dtype)


@_part("vtp::norm")
def _rms_norm(x, scale, eps=1e-6):
    # normalize in f32 and cast back LAST, as the reference does, so the
    # f32 scale param never upcasts the residual stream
    var = x.float().square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


@_part("vtp::rotary")
def _rotary(x, positions):
    """Rotary position embedding, half-split layout; x: [b, t, h, d]."""
    d = x.shape[-1]
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, device=x.device))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * (log_base / half))
    angles = positions[:, :, None, None].float() * freqs      # b,t,1,half
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@_part("vtp::attn")
def _attention(x, blk, cfg: ModelConfig, positions, ax: _Axes):
    b, t, _ = x.shape
    x = _copy_to_tp(x, ax)
    shape = (b, t, cfg.n_heads // ax.tp_size, cfg.head_dim)
    q = (x @ _cast(_use(blk["wq"], "wq", ax), x.dtype)).reshape(shape)
    k = (x @ _cast(_use(blk["wk"], "wk", ax), x.dtype)).reshape(shape)
    v = (x @ _cast(_use(blk["wv"], "wv", ax), x.dtype)).reshape(shape)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    o = _attention_core(q, k, v, cfg, ax)
    return _reduce_from_tp(
        o.reshape(b, t, -1) @ _cast(_use(blk["wo"], "wo", ax), x.dtype), ax)


@_part("vtp::attn.core")
def _attention_core(q, k, v, cfg: ModelConfig, ax: _Axes):
    """Attention over rotated q, k, v [b, t, h, d] -> o [b, t, h, d]."""
    t = q.shape[1]
    sp, tp = ax.sp_size, ax.tp_size
    # the reference's branch order (volcano_tpu/workloads/model.py:186)
    if cfg.use_ulysses_attention and sp > 1 and (cfg.n_heads // tp) % sp == 0:
        o = ulysses_attention(q, k, v, ax.sp,
                              use_flash=cfg.use_flash_attention)
    elif (cfg.use_ring_attention or cfg.use_ulysses_attention) and sp > 1:
        if cfg.use_ulysses_attention and not cfg.use_ring_attention:
            warnings.warn(
                f"use_ulysses_attention needs (n_heads/tp) % sp == 0 "
                f"(heads={cfg.n_heads}, tp={tp}, sp={sp}); falling "
                f"back to ring attention", stacklevel=3)
        o = ring_attention(q, k, v, ax.sp)
    elif cfg.use_flash_attention and sp == 1:
        o = flash_attention(q, k, v)
    elif sp > 1:
        # the reference's eager attention on the GSPMD-gathered sequence:
        # K and V gathered over sp (each rank's dK, dV partial, so the
        # gradient comes back reduce-scattered), this rank's rows against
        # the keys up to its last row
        end = (ax.sp_rank + 1) * t
        o = local_causal_attention(
            q, _Gather.apply(k, 1, ax.sp, True)[:, :end],
            _Gather.apply(v, 1, ax.sp, True)[:, :end], q_start=ax.sp_rank * t)
    else:
        o = local_causal_attention(q, k, v)
    return o


@_part("vtp::mlp")
def _mlp(x, blk, ax: _Axes):
    x = _copy_to_tp(x, ax)
    gate = torch.nn.functional.silu(
        x @ _cast(_use(blk["w_gate"], "w_gate", ax), x.dtype))
    up = x @ _cast(_use(blk["w_up"], "w_up", ax), x.dtype)
    return _reduce_from_tp(
        (gate * up) @ _cast(_use(blk["w_down"], "w_down", ax), x.dtype), ax)


@_part("vtp::mlp")
def _moe(x, blk, cfg: ModelConfig, ax: _Axes):
    """(the routed MLP's output, its aux loss)."""
    # the router gathered over fsdp like any weight; the expert leaves
    # stay this rank's (the tokens go to them)
    return moe_mlp(x, dict(blk, router=_use(blk["router"], "router", ax)),
                   cfg.n_experts, cfg.expert_top_k, cfg.moe_capacity_factor,
                   ax)


@_part("vtp::block", backward=False)
def _block(x, blk, cfg: ModelConfig, positions, ax: _Axes):
    """Returns (x, moe_aux_loss); aux is 0 for dense blocks.  The
    residual adds are `vtp::block`'s own time."""
    x = x + _attention(_rms_norm(x, blk["attn_norm"]), blk, cfg, positions,
                       ax)
    h = _rms_norm(x, blk["mlp_norm"])
    if "router" in blk:
        y, aux = _moe(h, blk, cfg, ax)
        return x + y, aux
    return x + _mlp(h, blk, ax), torch.zeros((), device=x.device)


def forward_with_aux(params, tokens, cfg: ModelConfig, mesh=None):
    """tokens [b, t] -> (logits [b, t, vocab], moe aux loss scalar).
    With a mesh, params are this rank's local shards (plain tensors laid
    out by `param_shardings`) and tokens its rows and, under sp, its
    block of the sequence."""
    ax = _Axes(mesh, cfg)
    b, t = tokens.shape
    # the table gathered whole for the lookup, as the reference
    # replicates it
    x = _embed(_use(params["embed"], "embed", ax, whole=True), tokens,
               cfg.dtype)
    positions = (ax.sp_rank * t + torch.arange(t, device=tokens.device))[
        None, :].expand(b, t)
    x, aux_total = _apply_blocks(x, params["blocks"], cfg, positions, ax)
    return _logits(x, params, cfg, ax), aux_total


@_part("vtp::embed")
def _embed(table, tokens, dtype):
    return table[tokens].to(dtype)


def _apply_blocks(x, blocks, cfg: ModelConfig, positions, ax: _Axes):
    """(x after `blocks`, the sum of their MoE aux losses); under
    cfg.remat each block keeps only its inputs and is recomputed in the
    backward."""
    aux_total = torch.zeros((), device=x.device)
    for blk in blocks:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block, x, blk, cfg, positions, ax,
                                use_reentrant=False)
        else:
            x, aux = _block(x, blk, cfg, positions, ax)
        aux_total = aux_total + aux
    return x, aux_total


@_part("vtp::head")
def _logits(x, params, cfg: ModelConfig, ax: _Axes):
    """The final norm and the head over x.  Logits stay in the model
    dtype, as in the reference; under tp each rank computes its vocab
    columns, gathered before the loss."""
    x = _copy_to_tp(_rms_norm(x, params["final_norm"]), ax)
    logits = x @ _cast(_use(params["head"], "head", ax), cfg.dtype)
    if ax.tp is not None:
        logits = _Gather.apply(logits, logits.dim() - 1, ax.tp, False)
    return logits


def forward(params, tokens, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """tokens [b, t] -> logits [b, t, vocab]."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]


@_part("vtp::loss")
def next_token_loss(logits, tokens, sp=None) -> torch.Tensor:
    """Shared next-token CE: logits [b, t, V], tokens [b, t] -> scalar.
    The last position predicts the rolled-around token and is masked,
    so the mean is over b * (t - 1) positions.  logsumexp minus the
    picked logit, upcast to f32 inside the reduction only: the logits
    stay in the model dtype.

    With `sp`, the sp process group, logits and tokens are this rank's
    block of the sequence: the targets roll over the global sequence
    (the last local position's target is the next rank's first token,
    and only the global last position is masked), and the local sum is
    divided by the global count b * (sp t - 1), so the sum over sp is
    the rows' mean."""
    if sp is None:
        targets = torch.roll(tokens, -1, dims=1)
        n_sp, last = 1, True
    else:
        n_sp, r = dist.get_world_size(sp), dist.get_rank(sp)
        nxt = ring_shift(tokens[:, :1], sp, -1)      # rank r + 1's first
        targets = torch.cat([tokens[:, 1:], nxt], dim=1)
        last = r == n_sp - 1
    lse = torch.logsumexp(logits.float(), dim=-1)                # [b, t]
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0] \
        .float()
    nll = lse - picked
    mask = torch.ones_like(nll)
    if last:
        mask[:, -1] = 0.0
    b, t = tokens.shape
    return (nll * mask).sum() / (b * (n_sp * t - 1))


def loss_fn(params, batch, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Next-token cross entropy (+ MoE load-balancing aux);
    batch: {"tokens": [b, t]}.  Under sp
    this is the rank's share of its rows' loss (`next_token_loss`)."""
    tokens = batch["tokens"]
    logits, moe_aux = forward_with_aux(params, tokens, cfg, mesh)
    return next_token_loss(logits, tokens, _Axes(mesh).sp) + \
        cfg.moe_aux_weight * moe_aux


class DecoderLM(nn.Module):
    """A thin module over the parameter dict: registers the same tensors
    under the pytree's names (`embed`, `blocks.<i>.wq`, ...) and calls
    `forward`."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        for name in ("embed", "final_norm", "head"):
            self.register_parameter(
                name, nn.Parameter(params[name], requires_grad=False))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                              for k, v in blk.items()})
            for blk in params["blocks"])

    def params(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {name: getattr(self, name)
                               for name in ("embed", "final_norm", "head")}
        out["blocks"] = [dict(blk.items()) for blk in self.blocks]
        return out

    def forward(self, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg, mesh)

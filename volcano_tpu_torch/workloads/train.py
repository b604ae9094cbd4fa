"""Training step — the port of `volcano_tpu.workloads.train`.

`make_optimizer` is the reference's optax chain written out by hand:
`clip_by_global_norm(1.0)`, then AdamW (decay on every leaf) under a
linear-warmup cosine schedule (`warmup_cosine_decay_schedule`, this
module's own copy of optax's).  `train_step` takes the value and
gradient of `model.loss_fn` and applies the update to the params in
place, the counterpart of the reference's donated buffers.

Params and optimizer state are dicts with the model's param structure
(`{"embed", "final_norm", "head", "blocks": [{...}, ...]}`).

With a mesh (`mesh.make_mesh` / `make_hybrid_mesh`, one process per
GPU) params and AdamW's mu and nu are DTensors laid out as the
reference lays them out (`model.param_shardings`: sharded over fsdp and
tp, replicated over dp, dcn and sp; the count stays an int), and each
rank holds its rows of the global batch over the data axes dcn x dp x
fsdp and its block of the sequence over sp (`batch_sharding`, the
reference's `P(data_axes, "sp")`).  The step runs the forward on the
local shards (`model.forward_with_aux` gathers each weight over fsdp at
its use) and reduces the gradients to the global batch's mean: under
sp each rank's gradients are its partials of its rows' loss, summed
over sp first; then each leaf is summed over the data axes it is not
sharded over (a leaf sharded over fsdp comes back from the backward
reduce-scattered, summed, over fsdp; an MoE expert leaf arrives summed
over its expert-parallel group, fsdp or dcn x fsdp, whose tokens it
processed), and divided by the data group's size.  The clip's global norm
sums each leaf's local squares over the axes it can be sharded on,
dcn x fsdp x tp (`grad_global_norm`; sp holds whole copies, so it counts them once), and
AdamW runs on the local shards.  The loss is the rows' mean over their
b * (t - 1) positions (under sp the sum of each rank's share), so the
mean over the data group equals the reference's global mean only with
equal rows per rank, which `batch_sharding` enforces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from volcano_tpu_torch.workloads import mesh as mesh_lib
from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads.model import ModelConfig

Schedule = Callable[[int], float]

# the reference's optax chain: clip_by_global_norm(1.0), then adamw with
# optax's default b1, b2 and eps
MAX_GRAD_NORM = 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8
# gradients are all-reduced in flat buckets of at most this many
# elements (256 MB of f32), not one collective a leaf
BUCKET_ELEMS = 1 << 26
# the names of the flattened sub-meshes: the data axes (dcn x dp x
# fsdp), the replica axes of an fsdp shard (dcn x dp) and the axes a
# leaf shards over (fsdp x tp, with dcn on a hybrid mesh)
DATA_MESH = "data"
REPLICA_MESH = "replica"
SHARD_MESH = "shard"


def named_leaves(tree: Dict[str, Any], prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a param-structured dict: the top-level ones,
    then each block's, in insertion order (which `tree_map` keeps),
    named by their path (`embed`, `blocks.0.wq`, ...) after `prefix`."""
    for name, x in tree.items():
        if name != "blocks":
            yield prefix + name, x
    for i, blk in enumerate(tree.get("blocks", ())):
        for name, x in blk.items():
            yield f"{prefix}blocks.{i}.{name}", x


def local(x):
    """This rank's shard of a DTensor (a view of its storage); any other
    tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def leaves(tree: Dict[str, Any]) -> Iterator[torch.Tensor]:
    """The tensors of a param-structured dict, in `named_leaves` order."""
    return (x for _, x in named_leaves(tree))


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor],
             tree: Dict[str, Any]) -> Dict[str, Any]:
    """A dict of the same structure and order with fn of each tensor."""
    return model_lib.map_named(lambda _, x: fn(x), tree)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's schedule: linear from init_value to peak_value over
    warmup_steps, then cosine down to end_value at decay_steps (counted
    from 0, warmup included), constant after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > "
                         f"warmup_steps; got {decay_steps}, {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """`clip_by_global_norm(MAX_GRAD_NORM)` followed by optax's `adamw`,
    on the params in place.  State: {"count": int, "mu": tree in mu_dtype,
    "nu": tree in f32}.  Per leaf, with count incremented first:

        mu = b1 mu + (1 - b1) g        nu = b2 nu + (1 - b2) g^2
        u  = mu_hat / (sqrt(nu_hat) + eps) + wd p
        p -= lr(count - 1) u

    with mu_hat, nu_hat bias-corrected by count (mu_hat before mu is
    cast to mu_dtype).  Weight decay applies to every leaf, norms
    included, and the first update has lr(0).  As in optax, the stored
    mu is decayed in its own dtype: with bf16 mu, b1 is bf16(0.9)."""

    def __init__(self, schedule: Schedule, weight_decay: float,
                 mu_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        # JAX casts the Python constant to the moment's dtype
        self._b1_mu = float(torch.tensor(B1, dtype=mu_dtype or
                                         torch.float32))

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params: Dict[str, Any], grads: Dict[str, Any],
               state: Dict[str, Any],
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update to params and state in place, on each leaf's
        local shard when they are DTensors; returns the global norm of
        the unclipped grads (a 0-dim tensor), `g_norm` when given (the
        sharded step's `grad_global_norm`), else `global_norm` of grads."""
        g_leaves = [local(g) for g in leaves(grads)]
        if g_norm is None:
            g_norm = global_norm(g_leaves)
        # clip as optax does: g when the norm is below the limit, else
        # g / norm * limit (a tensor op, so the host never waits)
        clip = torch.where(g_norm < MAX_GRAD_NORM, 1.0,
                           MAX_GRAD_NORM / g_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        bc1 = 1.0 - B1 ** state["count"]
        bc2 = 1.0 - B2 ** state["count"]
        for p, g, mu, nu in zip(leaves(params), g_leaves,
                                leaves(state["mu"]), leaves(state["nu"])):
            p, mu, nu = local(p), local(mu), local(nu)
            g = g * clip
            m = (1 - B1) * g + self._b1_mu * mu
            nu.copy_((1 - B2) * g.square() + B2 * nu)
            u = (m / bc1) / ((nu / bc2).sqrt() + EPS)
            mu.copy_(m)
            p.sub_(lr * (u + self.weight_decay * p))
        return g_norm


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100,
                   mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """mu_dtype=torch.bfloat16 halves the first-moment memory while nu
    and the params stay f32."""
    schedule = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, 10_000, end_value=lr * 0.1)
    return AdamW(schedule, weight_decay, mu_dtype)


# -- the mesh paths -----------------------------------------------------

def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _sp_group(mesh: DeviceMesh):
    """The sp process group, None when sp is 1."""
    return mesh.get_group("sp") if _axis_sizes(mesh).get("sp", 1) > 1 \
        else None


def data_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over: dp+fsdp, plus the
    inter-slice dcn axis on a hybrid mesh."""
    return ("dcn", "dp", "fsdp") if "dcn" in mesh.mesh_dim_names \
        else ("dp", "fsdp")


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 1-D sub-mesh of the data axes flattened, whose group carries
    the gradient reduction."""
    return mesh_lib.sub_mesh(mesh, data_axes(mesh), DATA_MESH)


def _replica_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The data axes but fsdp: the ranks that hold the same fsdp shard."""
    return mesh_lib.sub_mesh(mesh, data_axes(mesh)[:-1], REPLICA_MESH)


def _shard_axes(mesh: DeviceMesh) -> tuple:
    """The axes a leaf can shard over: fsdp x tp, and dcn on a hybrid
    mesh (MoE expert leaves promoted over slices)."""
    return ("dcn", "fsdp", "tp") if "dcn" in mesh.mesh_dim_names \
        else ("fsdp", "tp")


def _shard_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 1-D sub-mesh of `_shard_axes`."""
    return mesh_lib.sub_mesh(mesh, _shard_axes(mesh), SHARD_MESH)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(size: int, index: int, count: int, what: str) -> slice:
    if size % count:
        raise ValueError(f"{what} {size} does not divide over {count} ranks")
    per = size // count
    return slice(index * per, (index + 1) * per)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The part of the global batch one rank holds, as the reference's
    `P(data_axes, "sp")` lays it out: the rows of block `index` of
    `count` equal blocks, where `index` is the rank's coordinate along
    the data axes in mesh order (dcn major), and the sequence columns of
    block `sp_index` of `sp_count`."""
    index: int
    count: int
    sp_index: int = 0
    sp_count: int = 1

    def rows(self, global_batch: int) -> slice:
        return _block(global_batch, self.index, self.count,
                      "global batch")

    def cols(self, seq_len: int) -> slice:
        return _block(seq_len, self.sp_index, self.sp_count,
                      "sequence length")


def batch_sharding(mesh: DeviceMesh) -> BatchShard:
    """Tokens [b, t]: batch over data_axes, the same rows on every tp
    rank, the sequence over sp."""
    sizes = _axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for axis in data_axes(mesh):
        index = index * sizes[axis] + coord[axis]
        count *= sizes[axis]
    return BatchShard(index, count, coord["sp"], sizes["sp"])


def init_sharded(generator: torch.Generator, cfg: ModelConfig,
                 mesh: DeviceMesh, optimizer: AdamW):
    """(params, opt_state, placements) on this rank's device, laid out
    as the reference's `init_sharded` lays them out: every rank draws
    the same params from the same seed, keeps its shard (DTensors by
    `model.param_shardings`, which `placements` gives) and frees the
    rest; mu and nu take the params' placements, the count is an int."""
    params = model_lib.distribute(
        model_lib.init_params(cfg, generator, mesh_device(mesh)), mesh)
    return params, optimizer.init(params), \
        model_lib.param_shardings(params, mesh)


def _flush(bucket: List[torch.Tensor], group, n: int) -> None:
    flat = torch.cat([t.reshape(-1) for t in bucket])
    if group is not None:
        dist.all_reduce(flat, group=group)
    # the mean, written back in the same pass
    for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
        torch.div(piece.view_as(t), n, out=t)


def _sum_and_divide(tensors: List[torch.Tensor], group, n: int) -> None:
    """Replace each tensor, in place, by its sum over `group` (None: no
    reduction) divided by n, in flat buckets of at most BUCKET_ELEMS
    elements of one dtype."""
    bucket: List[torch.Tensor] = []
    elems = 0
    for t in tensors:
        if bucket and (elems + t.numel() > BUCKET_ELEMS
                       or t.dtype != bucket[0].dtype):
            _flush(bucket, group, n)
            bucket, elems = [], 0
        bucket.append(t)
        elems += t.numel()
    if bucket:
        _flush(bucket, group, n)


def all_reduce_mean(tensors: List[torch.Tensor], mesh: DeviceMesh) -> None:
    """Replace each tensor, in place, by its mean over the data group,
    in flat buckets of at most BUCKET_ELEMS elements of one dtype."""
    group_mesh = data_mesh(mesh)
    _sum_and_divide(tensors, group_mesh.get_group(), group_mesh.size())


def _sharded_over(placements, mesh: DeviceMesh, axes: tuple) -> int:
    """The number of shards a leaf with `placements` has over `axes`."""
    sizes = _axis_sizes(mesh)
    n = 1
    for axis, place in zip(mesh.mesh_dim_names, placements):
        if axis in axes and isinstance(place, Shard):
            n *= sizes[axis]
    return n


def _reduce_grads(grads: List[torch.Tensor], placements: List[tuple],
                  mesh: DeviceMesh) -> None:
    """Turn each rank's local gradients, in place, into its shards of
    the global batch's mean gradient.  Under sp every leaf is first
    summed over sp (each rank's are its partials of its rows' loss).
    Then each leaf is summed over the data axes it is not sharded over:
    over fsdp it arrives summed already (the backward's reduce-scatter,
    or, for an MoE expert leaf, the tokens of its expert-parallel group
    that it processed).  Every leaf is divided by the data group's
    size."""
    sp = _sp_group(mesh)
    if sp is not None:
        _sum_and_divide(grads, sp, 1)
    axes = data_axes(mesh)
    n = data_mesh(mesh).size()
    by_axes: Dict[tuple, List[torch.Tensor]] = {axes: []}
    for g, place in zip(grads, placements):
        rest = tuple(a for a in axes
                     if not _sharded_over(place, mesh, (a,)) > 1)
        by_axes.setdefault(rest, []).append(g)
    names = {axes: DATA_MESH, axes[:-1]: REPLICA_MESH}
    for rest, members in by_axes.items():
        if not members:
            continue
        group_mesh = mesh_lib.sub_mesh(mesh, rest, names.get(
            rest, "_".join(rest))) if rest else None
        _sum_and_divide(members, group_mesh.get_group()
                        if group_mesh is not None and group_mesh.size() > 1
                        else None, n)


def grad_global_norm(grads: Dict[str, Any], mesh: DeviceMesh
                     ) -> torch.Tensor:
    """optax's `global_norm` of the global gradient from each rank's
    shards of it (DTensors; the same on every rank): the local squares
    summed over the ranks of `_shard_axes`, each leaf weighted by its
    shards over the group's size, so a leaf held whole by every rank
    counts once.  Without a sharded axis it is `global_norm` of the local
    gradients."""
    g_leaves = list(leaves(grads))
    local_grads = [local(g) for g in g_leaves]
    group_mesh = _shard_mesh(mesh)
    n = group_mesh.size()
    if n == 1:
        return global_norm(local_grads)
    weights = torch.tensor(
        [_sharded_over(g.placements, mesh, _shard_axes(mesh)) / n
         for g in g_leaves],
        dtype=torch.float32, device=local_grads[0].device)
    norms = torch.stack([torch.linalg.vector_norm(g.float())
                         for g in local_grads])
    total = (norms.square() * weights).sum()
    dist.all_reduce(total, group=group_mesh.get_group())
    return total.sqrt()


def value_and_grad(params: Dict[str, Any], batch: Dict[str, Any],
                   cfg: ModelConfig, mesh: Optional[DeviceMesh] = None):
    """(loss, grads) of `model.loss_fn`; grads have the params'
    structure.  With a mesh, params are DTensors, batch holds this
    rank's rows, the forward runs on the local shards, and the loss and
    grads returned are the global batch's mean (grads as DTensors with
    the params' placements)."""
    # the leaves differentiated: detached views of the params' storage
    # (of their local shards, with a mesh)
    shards = tree_map(lambda x: local(x).detach().requires_grad_(True),
                      params)
    with torch.enable_grad():
        loss = model_lib.loss_fn(shards, batch, cfg, mesh)
        g_list = list(torch.autograd.grad(loss, list(leaves(shards))))
    loss = loss.detach()
    if mesh is None:
        g_leaves = iter(g_list)
        return loss, tree_map(lambda _: next(g_leaves), params)
    placements = [p.placements for p in leaves(params)]
    _reduce_grads(g_list, placements, mesh)
    sp = _sp_group(mesh)
    if sp is not None:
        dist.all_reduce(loss, group=sp)      # the rows' loss
    all_reduce_mean([loss], mesh)
    g_leaves = iter(zip(g_list, placements))

    def as_dtensor(_):
        g, place = next(g_leaves)
        return DTensor.from_local(g, mesh, place, run_check=False)

    return loss, tree_map(as_dtensor, params)


def train_step(params, opt_state, batch, cfg: ModelConfig,
               optimizer: AdamW, mesh: Optional[DeviceMesh] = None):
    """Value and grad of `loss_fn`, then the optimizer's update.  The
    params and the optimizer state are updated in place under
    `torch.no_grad()` (the reference donates their buffers to the step)
    and returned.  Metrics: `loss` and `grad_norm`, the norm of the
    unclipped grads, as 0-dim tensors on the params' device; with a
    mesh, both are global (the same on every rank)."""
    loss, grads = value_and_grad(params, batch, cfg, mesh)
    g_norm = None if mesh is None else grad_global_norm(grads, mesh)
    grad_norm = optimizer.update(params, grads, opt_state, g_norm)
    return params, opt_state, {"loss": loss, "grad_norm": grad_norm}


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    mesh: Optional[DeviceMesh] = None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    PyTorch runs eagerly, so there is nothing to compile; with a mesh,
    the step's groups are formed here, on every rank at once."""
    if mesh is not None:
        data_mesh(mesh)
        _replica_mesh(mesh)
        _shard_mesh(mesh)

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, optimizer, mesh)

    return step


def synthetic_batch(generator: torch.Generator, cfg: ModelConfig,
                    batch_size: int, seq_len: int,
                    mesh: Optional[DeviceMesh] = None) -> Dict[str, Any]:
    """Uniform random int64 tokens [batch_size, seq_len] on the
    generator's device.  With a mesh, batch_size is the global batch:
    every rank draws all of it, which needs the same generator state on
    every rank (a CPU generator agrees on any device), and keeps its own
    rows and sequence block (`batch_sharding`), moved to its device."""
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=generator.device,
                           dtype=torch.int64)
    if mesh is not None:
        shard = batch_sharding(mesh)
        tokens = tokens[shard.rows(batch_size), shard.cols(seq_len)] \
            .contiguous().to(mesh_device(mesh))
    return {"tokens": tokens}

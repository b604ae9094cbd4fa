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
GPU) the step is data-parallel: each rank holds its rows of the global
batch (`batch_sharding`), computes the loss and gradients of its rows,
and all-reduces both as the mean over the flattened data group
(dcn x dp x fsdp), so every rank applies the same clipped update to the
same params and reports the global loss.  The per-rank loss is a mean
over its b * (t - 1) positions, so this equals the reference's global
mean only with equal rows per rank, which `batch_sharding` enforces.

fsdp runs here as a data axis only: params and optimizer state are
replicated on every rank, not sharded.  The results equal the
reference's; the memory per GPU does not.  Sharding params over fsdp
(FSDP2 / DTensor), and the tp and sp axes, are ROADMAP A.3: a mesh with
tp > 1 or sp > 1 raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

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
# the name of the flattened data sub-mesh (dcn x dp x fsdp)
DATA_MESH = "data"


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


def leaves(tree: Dict[str, Any]) -> Iterator[torch.Tensor]:
    """The tensors of a param-structured dict, in `named_leaves` order."""
    return (x for _, x in named_leaves(tree))


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor],
             tree: Dict[str, Any]) -> Dict[str, Any]:
    """A dict of the same structure and order with fn of each tensor."""
    out: Dict[str, Any] = {k: fn(v) for k, v in tree.items()
                           if k != "blocks"}
    if "blocks" in tree:
        out["blocks"] = [{k: fn(v) for k, v in blk.items()}
                         for blk in tree["blocks"]]
    return out


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
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one update to params and state in place; returns the
        global norm of the unclipped grads (a 0-dim tensor)."""
        g_leaves = list(leaves(grads))
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


# -- the data-parallel mesh paths ---------------------------------------

def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _check_mesh(mesh) -> None:
    sizes = _axis_sizes(mesh)
    if sizes.get("tp", 1) > 1 or sizes.get("sp", 1) > 1:
        raise NotImplementedError(
            f"mesh {sizes}: only the data axes (dcn, dp, fsdp) are ported; "
            "tp and sp are ROADMAP A.3")


def data_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over: dp+fsdp, plus the
    inter-slice dcn axis on a hybrid mesh."""
    return ("dcn", "dp", "fsdp") if "dcn" in mesh.mesh_dim_names \
        else ("dp", "fsdp")


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 1-D sub-mesh of the data axes flattened, whose group carries
    the gradient reduction.  Every rank must call it at the same point
    the first time (it forms a group); later calls return the same
    mesh."""
    return mesh[data_axes(mesh)]._flatten(DATA_MESH)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The rows of the global batch one rank holds: block `index` of
    `count` equal blocks, where `index` is the rank's coordinate along
    the data axes in mesh order (dcn major), as the reference's
    `P(data_axes, "sp")` lays the batch out."""
    index: int
    count: int

    def rows(self, global_batch: int) -> slice:
        if global_batch % self.count:
            raise ValueError(
                f"global batch {global_batch} does not divide over "
                f"{self.count} data-parallel ranks")
        per = global_batch // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: DeviceMesh) -> BatchShard:
    """Tokens [b, t]: batch over data_axes; the sequence would shard over
    sp, which must be 1 here."""
    _check_mesh(mesh)
    sizes = _axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, count = 0, 1
    for axis in data_axes(mesh):
        index = index * sizes[axis] + coord[axis]
        count *= sizes[axis]
    return BatchShard(index, count)


def init_sharded(generator: torch.Generator, cfg: ModelConfig,
                 mesh: DeviceMesh, optimizer: AdamW):
    """(params, opt_state, placements) on this rank's device, replicated
    across the data axes: every rank draws the same params from the same
    seed.  `placements` gives each param leaf its DTensor placements on
    the mesh (all `Replicate()` in this slice)."""
    _check_mesh(mesh)
    params = model_lib.init_params(cfg, generator, mesh_device(mesh))
    opt_state = optimizer.init(params)
    placements = tree_map(lambda _: (Replicate(),) * mesh.ndim, params)
    return params, opt_state, placements


def _flush(bucket: List[torch.Tensor], group, n: int) -> None:
    flat = torch.cat([t.reshape(-1) for t in bucket])
    dist.all_reduce(flat, group=group)
    # the mean, written back in the same pass
    for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
        torch.div(piece.view_as(t), n, out=t)


def all_reduce_mean(tensors: List[torch.Tensor], mesh: DeviceMesh) -> None:
    """Replace each tensor, in place, by its mean over the data group,
    in flat buckets of at most BUCKET_ELEMS elements of one dtype."""
    group_mesh = data_mesh(mesh)
    group, n = group_mesh.get_group(), group_mesh.size()
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


def value_and_grad(params: Dict[str, Any], batch: Dict[str, Any],
                   cfg: ModelConfig, mesh: Optional[DeviceMesh] = None):
    """(loss, grads) of `model.loss_fn`; grads have the params'
    structure.  Marks the params as requiring grad.  With a mesh, batch
    holds this rank's rows, and the loss and grads returned are their
    means over the data group."""
    if mesh is not None:
        _check_mesh(mesh)
    p_leaves = list(leaves(params))
    with torch.enable_grad():
        for p in p_leaves:
            p.requires_grad_(True)
        loss = model_lib.loss_fn(params, batch, cfg)
        g_list = list(torch.autograd.grad(loss, p_leaves))
    loss = loss.detach()
    if mesh is not None:
        all_reduce_mean(g_list, mesh)
        all_reduce_mean([loss], mesh)
    g_leaves = iter(g_list)
    grads = tree_map(lambda _: next(g_leaves), params)
    return loss, grads


def train_step(params, opt_state, batch, cfg: ModelConfig,
               optimizer: AdamW, mesh: Optional[DeviceMesh] = None):
    """Value and grad of `loss_fn`, then the optimizer's update.  The
    params and the optimizer state are updated in place under
    `torch.no_grad()` (the reference donates their buffers to the step)
    and returned.  Metrics: `loss` and `grad_norm`, the norm of the
    unclipped grads, as 0-dim tensors on the params' device; with a
    mesh, both are global (the same on every rank)."""
    loss, grads = value_and_grad(params, batch, cfg, mesh)
    grad_norm = optimizer.update(params, grads, opt_state)
    return params, opt_state, {"loss": loss, "grad_norm": grad_norm}


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    mesh: Optional[DeviceMesh] = None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    PyTorch runs eagerly, so there is nothing to compile; with a mesh,
    the data group is formed here, on every rank at once."""
    if mesh is not None:
        _check_mesh(mesh)
        data_mesh(mesh)

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
    rows (`batch_sharding`), moved to its device."""
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=generator.device,
                           dtype=torch.int64)
    if mesh is not None:
        tokens = tokens[batch_sharding(mesh).rows(batch_size)] \
            .to(mesh_device(mesh))
    return {"tokens": tokens}

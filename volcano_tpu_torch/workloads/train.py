"""Training step on one GPU — the port of `volcano_tpu.workloads.train`.

`make_optimizer` is the reference's optax chain written out by hand:
`clip_by_global_norm(1.0)`, then AdamW (decay on every leaf) under a
linear-warmup cosine schedule (`warmup_cosine_decay_schedule`, this
module's own copy of optax's).  `train_step` takes the value and
gradient of `model.loss_fn` and applies the update to the params in
place, the counterpart of the reference's donated buffers.

Params and optimizer state are dicts with the model's param structure
(`{"embed", "final_norm", "head", "blocks": [{...}, ...]}`).  Not yet
ported: the sharded paths (`mesh`, `init_sharded`, `batch_sharding`,
`data_axes`), which raise or are absent until the parallel slice.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads.model import ModelConfig

Schedule = Callable[[int], float]

# the reference's optax chain: clip_by_global_norm(1.0), then adamw with
# optax's default b1, b2 and eps
MAX_GRAD_NORM = 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training is not ported yet; pass mesh=None")


def leaves(tree: Dict[str, Any]) -> Iterator[torch.Tensor]:
    """The tensors of a param-structured dict: the top-level ones, then
    each block's, in insertion order (which `tree_map` keeps)."""
    for name, x in tree.items():
        if name != "blocks":
            yield x
    for blk in tree.get("blocks", ()):
        yield from blk.values()


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


def value_and_grad(params: Dict[str, Any], batch: Dict[str, Any],
                   cfg: ModelConfig, mesh=None):
    """(loss, grads) of `model.loss_fn`; grads have the params'
    structure.  Marks the params as requiring grad."""
    _no_mesh(mesh)
    p_leaves = list(leaves(params))
    with torch.enable_grad():
        for p in p_leaves:
            p.requires_grad_(True)
        loss = model_lib.loss_fn(params, batch, cfg)
        g_leaves = iter(torch.autograd.grad(loss, p_leaves))
    grads = tree_map(lambda _: next(g_leaves), params)
    return loss.detach(), grads


def train_step(params, opt_state, batch, cfg: ModelConfig,
               optimizer: AdamW, mesh=None):
    """Value and grad of `loss_fn`, then the optimizer's update.  The
    params and the optimizer state are updated in place under
    `torch.no_grad()` (the reference donates their buffers to the step)
    and returned.  Metrics: `loss` and `grad_norm`, the norm of the
    unclipped grads, as 0-dim tensors on the params' device."""
    loss, grads = value_and_grad(params, batch, cfg, mesh)
    grad_norm = optimizer.update(params, grads, opt_state)
    return params, opt_state, {"loss": loss, "grad_norm": grad_norm}


def make_train_step(cfg: ModelConfig, optimizer: AdamW, mesh=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    PyTorch runs eagerly, so there is nothing to compile."""
    _no_mesh(mesh)

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, optimizer)

    return step


def synthetic_batch(generator: torch.Generator, cfg: ModelConfig,
                    batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Uniform random int64 tokens [batch_size, seq_len] on the
    generator's device."""
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=generator.device,
                           dtype=torch.int64)
    return {"tokens": tokens}

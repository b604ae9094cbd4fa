"""The plain reference of the cells' decoder LM, in float32.

Written from the published descriptions, with no kernel, cache or
batching of the program's: a Llama-style pre-norm block (RMSNorm with
eps, rotary embedding on the half-split layout with base theta, causal
softmax attention with scale 1/sqrt(head_dim), a SwiGLU MLP), an
untied output head, and the next-token cross entropy averaged over the
b (t - 1) positions that have a target.  `adamw_step` is AdamW
(Loshchilov and Hutter) after clipping by the global norm, on a
linear-warmup cosine schedule.

Parameters are dicts in the port's layout (`W` [d_in, d_out], applied
as x @ W), handed over by the benchmark.  Each layer is recomputed in
the backward (`checkpoint`), so the reference fits beside its state.
`train_replicas` is `train` over a copy of the params on each of several
devices, each taking a block of the batch's rows: the gradients are
summed leaf by leaf on the device that owns the leaf, which updates it
and holds its moments, and the updated leaf is copied to the others;
plain tensors copied from device to device, in one process.

`Precision("fp8")` is the control: every matmul operand rounded to
float8 e4m3 (a scale a tensor) and multiplied in f32, the step below
the cells' bfloat16.  TF32 is off (`no_tf32`).

This file imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# heads whose scores are computed together
HEADS = 8

# AdamW's settings that the program fixes (`train.make_optimizer` and
# the constants of `workloads/train.py`); a mix gives lr, weight_decay
# and warmup_steps, the ones the program takes
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_GRAD_NORM = 1.0
DECAY_STEPS = 10_000
END_LR_RATIO = 0.1


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class Precision:
    """How the reference multiplies: "f32", or "fp8" (the control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def _r(self, x):
        return _RoundFp8.apply(x) if self.kind == "fp8" else x

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self._r(a), self._r(b))


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(x, theta):
    """x [b, t, h, hd]: pairs (i, i + hd/2) rotated by position * theta^(-2i/hd)."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) * 2 / hd)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, prec: Precision):
    t, hd = q.shape[1], q.shape[-1]
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.einsum("bhqk,bkhd->bqhd", p, v)


def attention(q, k, v, prec: Precision):
    """Causal softmax attention; q, k, v [b, t, h, hd].  HEADS heads at
    a time, each group recomputed in the backward, so that the scores
    of one group are alive at once."""
    outs = []
    for h in range(0, q.shape[2], HEADS):
        part = (x[:, :, h:h + HEADS] for x in (q, k, v))
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attention, *part, prec,
                                   use_reentrant=False))
        else:
            outs.append(_attention(*part, prec))
    return torch.cat(outs, dim=2)


def swiglu(x, wg, wu, wd, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def block(x, blk, cfg, prec: Precision):
    b, t, d = x.shape
    h = rms_norm(x, blk["attn_norm"], cfg.eps)
    shape = (b, t, cfg.n_heads, cfg.head_dim)
    q = rotary(prec.mm(h, blk["wq"]).view(shape), cfg.rope_theta)
    k = rotary(prec.mm(h, blk["wk"]).view(shape), cfg.rope_theta)
    v = prec.mm(h, blk["wv"]).view(shape)
    x = x + prec.mm(attention(q, k, v, prec).reshape(b, t, d), blk["wo"])
    h = rms_norm(x, blk["mlp_norm"], cfg.eps)
    return x + swiglu(h, blk["w_gate"], blk["w_up"], blk["w_down"], prec)


def hidden(params, tokens, cfg, prec: Precision):
    """The final norm's output [b, t, d]."""
    x = params["embed"][tokens]
    for blk in params["blocks"]:
        if torch.is_grad_enabled():
            x = checkpoint(block, x, blk, cfg, prec, use_reentrant=False)
        else:
            x = block(x, blk, cfg, prec)
    return rms_norm(x, params["final_norm"], cfg.eps)


def logits_at(params, tokens, positions, cfg, prec: Precision):
    """f32 logits [b, p, vocab] of rows `tokens` [b, t] at each row's
    `positions` [b, p]."""
    with torch.no_grad():
        h = hidden(params, tokens, cfg, prec)
        rows = torch.arange(h.shape[0], device=h.device)[:, None]
        return prec.mm(h[rows, positions], params["head"])


def loss(params, tokens, cfg, prec: Precision):
    """Next-token cross entropy over b (t - 1) positions."""
    h = hidden(params, tokens, cfg, prec)
    logits = prec.mm(h[:, :-1], params["head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def named(tree: Dict[str, Any]):
    for name, x in tree.items():
        if name != "blocks":
            yield name, x
    for i, blk in enumerate(tree.get("blocks", ())):
        for name, x in blk.items():
            yield f"blocks.{i}.{name}", x


def tree_like(tree: Dict[str, Any], values: Dict[str, Any]):
    out = {k: values[k] for k in tree if k != "blocks"}
    out["blocks"] = [{k: values[f"blocks.{i}.{k}"] for k in blk}
                     for i, blk in enumerate(tree["blocks"])]
    return out


def grads(params, tokens, cfg, prec: Precision):
    """(loss, {name: gradient})."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in named(params)}
    with torch.enable_grad():
        value = loss(tree_like(params, leaves), tokens, cfg, prec)
        gs = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, gs))


def lr_at(count: int, opt: Dict[str, float]) -> float:
    """Linear warmup from 0 to lr, then a cosine down to
    lr x END_LR_RATIO at DECAY_STEPS (counted from 0)."""
    lr, warm, decay = opt["lr"], opt["warmup_steps"], DECAY_STEPS
    if count < warm:
        return lr * count / warm
    c = min(count - warm, decay - warm)
    cos = 0.5 * (1 + math.cos(math.pi * c / (decay - warm)))
    return lr * ((1 - END_LR_RATIO) * cos + END_LR_RATIO)


@torch.no_grad()
def adamw_step(params, g: Dict[str, torch.Tensor], state: Dict[str, Any],
               opt: Dict[str, float]) -> Dict[str, float]:
    """Clip g by its global norm, then one AdamW update of params and
    state in place; returns each leaf's clipped gradient's norm."""
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(
        x, dtype=torch.float64)) ** 2 for x in g.values()))
    clip = min(1.0, MAX_GRAD_NORM / norm)
    lr = lr_at(state["count"], opt)
    state["count"] += 1
    n = state["count"]
    b1, b2 = B1, B2
    clipped = {}
    for name, p in named(params):
        gc = g[name] * clip
        clipped[name] = float(gc.norm())
        mu = state["mu"].setdefault(name, torch.zeros_like(p))
        nu = state["nu"].setdefault(name, torch.zeros_like(p))
        mu.mul_(b1).add_(gc, alpha=1 - b1)
        nu.mul_(b2).addcmul_(gc, gc, value=1 - b2)
        u = (mu / (1 - b1 ** n)) / ((nu / (1 - b2 ** n)).sqrt() + EPS)
        p.sub_(lr * (u + opt["weight_decay"] * p))
    return clipped


def train(params, batches, cfg, opt, prec: Precision) -> Dict[str, Any]:
    """len(batches) steps from params (updated in place).  Returns
    `losses` and `first` ({leaf: norm of its clipped first gradient})."""
    state: Dict[str, Any] = {"count": 0, "mu": {}, "nu": {}}
    out: Dict[str, Any] = {"losses": []}
    for i, tokens in enumerate(batches):
        value, g = grads(params, tokens, cfg, prec)
        out["losses"].append(float(value))
        clipped = adamw_step(params, g, state, opt)
        if i == 0:
            out["first"] = clipped
        del g
    del state
    return out


def owners(tree: Dict[str, Any], n: int) -> Dict[str, int]:
    """Each leaf's owner among n devices: the largest leaf first, each to
    the device with the fewest elements so far."""
    sizes = {name: x.numel() for name, x in named(tree)}
    load = [0] * n
    out = {}
    for name in sorted(sizes, key=lambda k: (-sizes[k], k)):
        k = min(range(n), key=lambda i: (load[i], i))
        out[name] = k
        load[k] += sizes[name]
    return out


def train_replicas(replicas, batches, cfg, opt, prec: Precision,
                   map_=map) -> Dict[str, Any]:
    """`train` with `replicas`, one param tree a device (the same values;
    all updated in place).  Each step, replica k takes the k-th of
    equal blocks of the batch's rows; the loss is the rows' mean; each
    leaf's gradient is the blocks' gradients weighted by their rows and
    summed on its owner (`owners`), which runs AdamW on it; the leaf is
    then copied to every other replica.  `map_` takes the replicas'
    gradients (a thread pool's `map` takes them at once, a thread a
    device)."""
    n = len(replicas)
    own = owners(replicas[0], n)
    leaves = [dict(named(r)) for r in replicas]
    view = tree_like(replicas[0], {name: leaves[k][name]
                                   for name, k in own.items()})
    state: Dict[str, Any] = {"count": 0, "mu": {}, "nu": {}}
    out: Dict[str, Any] = {"losses": []}
    for i, tokens in enumerate(batches):
        b = tokens.shape[0]
        blocks = [r for r in torch.arange(b).tensor_split(n) if len(r)]

        def one(k):
            dev = leaves[k]["embed"].device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            return grads(replicas[k], tokens[blocks[k]].to(dev), cfg, prec)

        done = list(map_(one, range(len(blocks))))
        values = [value * (len(rows) / b)
                  for rows, (value, _) in zip(blocks, done)]
        parts = [g for _, g in done]
        del done
        out["losses"].append(sum(float(v) for v in values))
        g = {}
        for name, k in own.items():
            dev = leaves[k][name].device
            g[name] = sum(part.pop(name).to(dev) * (len(rows) / b)
                          for rows, part in zip(blocks, parts))
        clipped = adamw_step(view, g, state, opt)
        if i == 0:
            out["first"] = clipped
        del g, parts
        with torch.no_grad():
            for k in range(n):
                for name, p in leaves[k].items():
                    if own[name] != k:
                        p.copy_(leaves[own[name]][name])
    del state
    return out

"""Flagship validation workload: decoder-only transformer LM in PyTorch.

The port of `volcano_tpu.workloads.model`'s forward.  Parameters stay a
dict with the JAX pytree's names and layout: every `W` is [d_in, d_out]
and is applied as `x @ W`, kept in f32 and cast to the activation dtype
at use.  Attention goes through the flash kernel
(`ops.flash_attention`) when `cfg.use_flash_attention`, else through the
eager `local_causal_attention`.

Not yet ported: mixture-of-experts blocks (`n_experts > 0` raises
NotImplementedError), the sharded mesh paths (ring and Ulysses flags do
nothing without a mesh, as in the reference with mesh=None), and remat,
which changes no value in inference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from volcano_tpu_torch.workloads.ops.flash_attention import flash_attention
from volcano_tpu_torch.workloads.ring_attention import local_causal_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # Mixture-of-experts (every other block routed); 0 = dense model.
    # Only dense models are ported.
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


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts blocks are not ported yet (n_experts > 0)")


# -- parameters -------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random f32 params in the reference's layout, drawn from
    `generator` on its own device and moved to `device` (default: the
    generator's).  torch cannot reproduce `jax.random`: to compare with
    the JAX model, load its params through `convert.params_from_jax`."""
    _dense_only(cfg)
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
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "attn_norm": ones(d),
            "wq": normal(d, d, std=scale),
            "wk": normal(d, d, std=scale),
            "wv": normal(d, d, std=scale),
            "wo": normal(d, d, std=scale),
            "mlp_norm": ones(d),
            "w_gate": normal(d, f, std=scale),
            "w_up": normal(d, f, std=scale),
            "w_down": normal(f, d, std=f ** -0.5),
        })
    return params


# -- forward ----------------------------------------------------------

def _rms_norm(x, scale, eps=1e-6):
    # normalize in f32 and cast back LAST, as the reference does, so the
    # f32 scale param never upcasts the residual stream
    var = x.float().square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


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


def _attention(x, blk, cfg: ModelConfig, positions):
    b, t, d = x.shape
    shape = (b, t, cfg.n_heads, cfg.head_dim)
    q = (x @ blk["wq"].to(x.dtype)).reshape(shape)
    k = (x @ blk["wk"].to(x.dtype)).reshape(shape)
    v = (x @ blk["wv"].to(x.dtype)).reshape(shape)
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    if cfg.use_flash_attention:
        o = flash_attention(q, k, v)
    else:
        o = local_causal_attention(q, k, v)
    return o.reshape(b, t, d) @ blk["wo"].to(x.dtype)


def _mlp(x, blk):
    gate = torch.nn.functional.silu(x @ blk["w_gate"].to(x.dtype))
    up = x @ blk["w_up"].to(x.dtype)
    return (gate * up) @ blk["w_down"].to(x.dtype)


def _block(x, blk, cfg: ModelConfig, positions):
    """Returns (x, moe_aux_loss); aux is 0 for dense blocks."""
    x = x + _attention(_rms_norm(x, blk["attn_norm"]), blk, cfg, positions)
    h = _rms_norm(x, blk["mlp_norm"])
    return x + _mlp(h, blk), torch.zeros((), device=x.device)


def forward_with_aux(params, tokens, cfg: ModelConfig, mesh=None):
    """tokens [b, t] -> (logits [b, t, vocab], moe aux loss scalar)."""
    _dense_only(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution is not ported yet; pass mesh=None")
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
    aux_total = torch.zeros((), device=x.device)
    for blk in params["blocks"]:
        x, aux = _block(x, blk, cfg, positions)
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"])
    # logits stay in the model dtype, as in the reference
    return x @ params["head"].to(cfg.dtype), aux_total


def forward(params, tokens, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """tokens [b, t] -> logits [b, t, vocab]."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]


class DecoderLM(nn.Module):
    """A thin module over the parameter dict: registers the same tensors
    under the pytree's names (`embed`, `blocks.<i>.wq`, ...) and calls
    `forward`."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        _dense_only(cfg)
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

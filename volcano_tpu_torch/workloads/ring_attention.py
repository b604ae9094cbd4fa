"""Eager causal attention — the port of
`volcano_tpu.workloads.ring_attention`'s `_block_attn` and
`local_causal_attention`.

Like the reference, the eager path scales by `1/sqrt(d)` cast to the
input dtype and runs its einsums in that dtype, so at bf16 it differs
from the flash kernel (which works in f32).  The sequence-parallel
`ring_attention` (a `ppermute` ring) waits for the parallel slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, q_start, k_start, scale, causal):
    """One (q-block x kv-block) attention contribution.

    q: [b, tq, h, d]; k,v: [b, tk, h, d].  Returns the unnormalised
    o_partial [b, tq, h, d], row max m [b, tq, h] and row sum l.
    """
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale   # [b, tq, h, tk]
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_start + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_start + torch.arange(tk, device=q.device)[None, :]
        mask = (q_pos >= k_pos)[None, :, None, :]
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [b, tq, h]
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)            # fully-masked rows
    l = p.sum(dim=-1)                                    # [b, tq, h]
    o = torch.einsum("bqhk,bkhd->bqhd", p, v)
    return o, m, l


def local_causal_attention(q, k, v):
    """Plain causal attention (no sequence parallelism)."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    o, m, l = _block_attn(q, k, v, 0, 0, scale.to(q.device), causal=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (o / safe_l[..., None]).to(q.dtype)

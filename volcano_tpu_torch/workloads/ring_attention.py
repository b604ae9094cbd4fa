"""Ring attention and eager causal attention — the port of
`volcano_tpu.workloads.ring_attention`.

`ring_attention(q, k, v, group)` is sequence-parallel causal attention
over the sp process group: each rank holds one sequence block of Q/K/V,
and the K/V blocks rotate around the ring (`ring_shift`, one
`batch_isend_irecv` a hop, the counterpart of `lax.ppermute`) while an
online softmax accumulates in f32, so every Q block sees every K/V block
and a rank never holds more than 1/sp of the sequence.

Like the reference, the eager paths (`_block_attn`, and so the ring and
`local_causal_attention`) scale by `1/sqrt(d)` cast to the input dtype
and run their einsums in that dtype, so at bf16 they differ from the
flash kernel (which works in f32).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


def _scale(q):
    """1/sqrt(d) in q's dtype, as the reference casts it."""
    return (1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)) \
        .to(q.device)


def ring_shift(x, group, step: int = 1):
    """Rank r of `group` sends x to rank (r + step) % n and returns the
    block of rank (r - step) % n: one `batch_isend_irecv` (no gradient;
    `_RingShift` is the differentiable form)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    """`ring_shift` one hop forward; the backward sends the gradient one
    hop the other way, the transpose JAX derives for `ppermute`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(grad, ctx.group, -1), None


def ring_attention(q, k, v, group, causal: bool = True):
    """Causal ring attention over the sp process group `group`.

    q, k, v: [b, t_local, h, d], this rank's sequence block (rank r of
    the group holds positions [r t_local, (r + 1) t_local)).  Returns
    [b, t_local, h, d].  After i hops a rank holds the K/V block of rank
    (r - i) % sp; the last hop, which would return the blocks to their
    owners, is not sent."""
    sp, my = dist.get_world_size(group), dist.get_rank(group)
    b, t_local, h, d = q.shape
    scale = _scale(q)
    o_acc = torch.zeros((b, t_local, h, d), dtype=torch.float32,
                        device=q.device)
    m_acc = torch.full((b, t_local, h), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((b, t_local, h), dtype=torch.float32,
                        device=q.device)
    k_blk, v_blk = k, v
    for i in range(sp):
        kv_idx = (my - i) % sp
        o, m, l = _block_attn(q, k_blk, v_blk, q_start=my * t_local,
                              k_start=kv_idx * t_local, scale=scale,
                              causal=causal)
        m_new = torch.maximum(m_acc, m)
        corr = torch.exp(m_acc - m_new)
        p_corr = torch.exp(m - m_new)
        l_acc = l_acc * corr + l * p_corr
        o_acc = o_acc * corr[..., None] + o.float() * p_corr[..., None]
        m_acc = m_new
        if i < sp - 1:
            k_blk = _RingShift.apply(k_blk, group)
            v_blk = _RingShift.apply(v_blk, group)
    safe_l = torch.where(l_acc == 0.0, 1.0, l_acc)
    return (o_acc / safe_l[..., None]).to(q.dtype)


def local_causal_attention(q, k, v, q_start: int = 0):
    """Plain causal attention (no sequence parallelism).  With q_start,
    q holds the rows from position q_start on of a sequence whose keys
    k and v start at position 0 (the rows of one sp rank against the
    keys gathered up to its last row)."""
    o, m, l = _block_attn(q, k, v, q_start, 0, _scale(q), causal=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (o / safe_l[..., None]).to(q.dtype)

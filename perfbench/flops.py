"""Operations and bytes the benchmark counts, from shapes alone.

`train_flops` is the PaLM accounting (appendix B) that the port's bench
uses (`volcano_tpu_torch/bench.py` `train_flops`): 6 x the parameters a
token passes through x tokens, the input embedding (a lookup) left out
and the output head counted, plus 3 x the causal attention forward.

The flash kernels' costs count what the inputs need: the causal scores
t (t + 1) / 2 a head, each input byte read once and each output byte
written once.  The backward needs five products over the scores (S
recomputed, dP, dV, dK, dQ; FlashAttention-2's 2.5 x the forward); the
port splits it in two kernels that both compute S and dP.  They are
charged once, to `flash_bwd_dkv`, and `flash_bwd_dq` is charged dQ
alone, so that a fused backward that drops the recompute does not read
as a lower share.  `bound` and
`kernel_group` are copies of `chip_smoke.py`'s.
"""

from __future__ import annotations

from typing import Tuple

from perfbench.cells import Sizes


def active_params(s: Sizes) -> int:
    """Parameters one token passes through as matmul operands or norm
    scales, the input embedding left out."""
    d, f = s.d_model, s.d_ff
    n = d * s.vocab + d                        # head, final norm
    # q, k, v, o, the SwiGLU MLP, two norms
    return n + s.n_layers * (4 * d * d + 3 * d * f + 2 * d)


def attention_fwd_flops(s: Sizes, b: int, t: int) -> float:
    """The causal attention forward of every layer, as the port's bench
    counts it: 4 b h t^2 hd / 2."""
    return s.n_layers * 4.0 * b * s.n_heads * t * t * s.head_dim / 2


def train_flops(s: Sizes, b: int, t: int) -> float:
    """Model FLOP of one training step over b x t tokens."""
    return 6.0 * active_params(s) * b * t + 3.0 * attention_fwd_flops(s, b, t)


def forward_flops(s: Sizes, b: int, t: int) -> float:
    """Model FLOP of one forward over b x t tokens."""
    return 2.0 * active_params(s) * b * t + attention_fwd_flops(s, b, t)


# -- the flash kernels ---------------------------------------------------

def flash_costs(kernel: str, b: int, t: int, h: int, d: int,
                elem: int = 2, d_v: int = None, h_kv: int = None
                ) -> Tuple[float, float]:
    """(FLOP, bytes) one causal launch of `kernel` needs with `h` query
    heads of q/k head dim `d`, `h_kv` key/value heads (default `h`) of v
    head dim `d_v` (default `d`), [b, t] positions and `elem`-byte
    tensors.  A product over the t (t + 1) / 2 causal scores of a head
    is 2 d a score where it contracts or spans q and k (Q K^T, dK, dQ),
    2 d_v where it contracts or spans v (P V, dP, dV).

    flash_fwd:     S = Q K^T, O = P V; reads q, k, v; writes o, lse.
    flash_bwd_dq:  dQ = dS K (its S and dP recompute flash_bwd_dkv's),
                   Delta = rowsum(dO O); reads q, k, v, do, out, lse;
                   writes dq, Delta.
    flash_bwd_dkv: S, dP = dO V^T, dV = P^T dO, dK = dS^T Q; reads q,
                   k, v, do, lse, Delta; writes dk, dv.

    With the defaults every value is that of one head dim for q, k and v
    and as many key/value heads as query heads."""
    d_v = d if d_v is None else d_v
    h_kv = h if h_kv is None else h_kv
    scores = b * h * t * (t + 1) / 2
    qk = 2.0 * d * scores                  # one product over d
    pv = 2.0 * d_v * scores                # one product over d_v
    q = b * t * h * d * elem               # q, dq
    o = b * t * h * d_v * elem             # o, do
    k = b * t * h_kv * d * elem            # k, dk
    v = b * t * h_kv * d_v * elem          # v, dv
    rows = b * h * t * 4                   # one f32 [b, h, t]
    if kernel == "flash_fwd":
        return qk + pv, q + k + v + o + rows
    if kernel == "flash_bwd_dq":
        return qk + 2.0 * b * h * t * d_v, \
            q + k + v + o + o + rows + q + rows
    if kernel == "flash_bwd_dkv":
        return 2 * qk + 2 * pv, q + k + v + o + 2 * rows + k + v
    raise ValueError(f"unknown kernel {kernel!r}")


def bound(flops: float, nbytes: float, flop_peak: float,
          byte_peak: float) -> Tuple[float, str]:
    """The least time in seconds the chip could take, and which of the
    two bounds it."""
    op_s, byte_s = flops / flop_peak, nbytes / byte_peak
    return max(op_s, byte_s), "operations" if op_s >= byte_s else "bytes"


def kernel_group(name: str) -> str:
    low = name.lower()
    for key in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if key in low:
            return key
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "elementwise"

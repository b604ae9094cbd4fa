"""PyTorch validation workloads — the GPU counterpart of
`volcano_tpu.workloads`.

The flagship decoder LM (`model`), its eager attention
(`ring_attention.local_causal_attention`), the flash-attention forward
kernel (`ops`), and the serving replica (`serve`).  Training, sharding
and the parallel families are still to be ported (ROADMAP.md).
"""

"""PyTorch validation workloads — the GPU counterpart of
`volcano_tpu.workloads`.

The flagship decoder LM (`model`), its eager attention
(`ring_attention.local_causal_attention`), the flash-attention kernels
(`ops`), the training step (`train`, on one GPU or data-parallel over a
`mesh`), the serving replica (`serve`), and the scheduled worker
(`worker`, with `bootstrap`, `checkpoint` and `progress`).  Sharding
params, and the other parallel families, are still to be ported
(ROADMAP.md).
"""

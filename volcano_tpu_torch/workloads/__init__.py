"""PyTorch validation workloads — the GPU counterpart of
`volcano_tpu.workloads`.

The flagship decoder LM (`model`), its eager attention
(`ring_attention.local_causal_attention`), the flash-attention kernels
(`ops`), the single-device training step (`train`) and the serving
replica (`serve`).  Sharding, the worker and checkpointing, and the
parallel families are still to be ported (ROADMAP.md).
"""

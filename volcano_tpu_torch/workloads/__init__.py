"""PyTorch validation workloads — the GPU counterpart of
`volcano_tpu.workloads`.

The flagship decoder LM (`model`), its attention (eager
`ring_attention.local_causal_attention`, the flash-attention kernels in
`ops`, and over an sp axis `ring_attention.ring_attention` and
`ulysses.ulysses_attention`), the training step (`train`, on one GPU or
over a `mesh`: dp, fsdp, tp, sp and dcn), the serving replica
(`serve`), and the scheduled worker (`worker`, with `bootstrap`,
`checkpoint` and `progress`).  Mixture-of-experts and pipeline
parallelism are still to be ported (ROADMAP.md).
"""

"""Hand-written CUDA kernels for the workload hot ops."""

from volcano_tpu_torch.workloads.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]

"""volcano-tpu's workloads in PyTorch, for NVIDIA Hopper GPUs.

A second package beside `volcano_tpu`, mirroring its paths and public
names so that each module has one counterpart to be held against.  It
imports `torch` and `numpy`, never `jax` and nothing of `volcano_tpu`:
what it needs of the JAX package's stdlib-only modules it keeps as its
own copy.  The attention kernel that `volcano_tpu` wrote in Pallas for
the TPU is a CUDA C++ kernel here (`csrc/`), built with `nvcc` at first
use.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

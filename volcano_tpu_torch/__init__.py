"""volcano-tpu in PyTorch, for NVIDIA Hopper GPUs.

A second package beside `volcano_tpu`, mirroring its paths and public
names so that each module has one counterpart to be held against.  It
imports nothing of `jax` and nothing of `volcano_tpu`: what it needs of
the JAX package's stdlib-only modules it keeps as its own copy.

Two halves:

- The workloads (`workloads/`) import `torch` and `numpy`.  The
  attention kernels that `volcano_tpu` wrote in Pallas for the TPU are
  CUDA C++ kernels here (`csrc/`), built with `nvcc` at first use.
  Entry points run on `cuda` unless the caller passes `device="cpu"`.
- The control plane (everything else: `api/`, `cache/`, `framework/`,
  `actions/`, `plugins/`, `controllers/`, `webhooks/`, `agent/`,
  `scheduler`, `simulator`) is stdlib-only, so a scheduler host needs
  no CUDA.  Its accelerator layer is the GPU one: `nvidia.com/gpu`
  devices, NVLink domains (`nvidia.com/gpu.clique`) under InfiniBand
  fabrics, the `torch` job plugin and the agent's GPU chip collector
  and health handler.
"""

__version__ = "0.1.0"

# Opt-in runtime lock-order auditing (analysis/lockaudit.py): arming
# must happen here — before ANY repo module creates a lock — so audited
# runs wrap every threading.Lock/RLock/Condition site in the package.
import os as _os

if _os.environ.get("VTP_LOCK_AUDIT"):
    from volcano_tpu_torch.analysis import lockaudit as _lockaudit
    _lockaudit.install_from_env()

# Opt-in runtime snapshot-freeze/data-race auditing (the `-race`
# analog, analysis/freezeaudit.py): armed here so every process of an
# audited plane freezes its scheduler sessions and reports to
# VTP_RACE_AUDIT_OUT.
if _os.environ.get("VTP_RACE_AUDIT"):
    from volcano_tpu_torch.analysis import freezeaudit as _freezeaudit
    _freezeaudit.install_from_env()

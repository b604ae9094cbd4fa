"""Where the port's entry points run.

The counterpart of the JAX package's platform selection
(`JAX_PLATFORMS`): an entry point runs on the GPU unless its caller
asks for the CPU, and never drops to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`cuda` by default, `cpu` only when asked; raises when `cuda` is
    asked for (or defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run "
            "on the CPU")
    return dev

"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheets, dense rates without sparsity, at the full power
limit: (bf16 FLOP/s, HBM bytes/s).  An unknown card is refused: a
roofline share against another card's peak would be a wrong number.
The card's power limit is read beside them (`power_limit`), since a
card set below its maximum runs slower under load.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Tuple

# matched in this order against `torch.cuda.get_device_name()`
PEAKS = (
    ("H100 PCIe", (756e12, 2.0e12)),
    ("H100 NVL", (835e12, 3.9e12)),
    ("H100 80GB HBM3", (989e12, 3.35e12)),     # SXM
)


def peaks(name: str) -> Tuple[float, float]:
    for key, val in PEAKS:
        if key in name:
            return val
    raise ValueError(f"no published peak for the card {name!r}; "
                     f"known: {[k for k, _ in PEAKS]}")


def power_limit() -> Optional[str]:
    """The first card's `power.limit` from nvidia-smi, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.strip().splitlines()
    return line[0].split(",")[-1].strip() if line else None

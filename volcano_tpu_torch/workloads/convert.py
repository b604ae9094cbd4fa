"""Load the JAX model's parameters into the port.

torch cannot reproduce `jax.random`, so a comparison with the JAX model
loads its params by value: the caller turns the JAX pytree into numpy
arrays (`jax.tree.map(np.asarray, params)`) and hands them here.  The
layouts are the same ([d_in, d_out] weights), so nothing is transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    # bf16 (ml_dtypes) has no torch.from_numpy path: widen it to f32;
    # np.array copies, so the tensor owns writable, contiguous memory
    wide = a.dtype.kind != "f" or a.dtype.itemsize < 4
    t = torch.from_numpy(np.array(a, dtype=np.float32 if wide else a.dtype))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Dict[str, Any], device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX `init_params` pytree (as numpy) -> the port's param dict,
    on `device`, in `dtype` (default: f32, as the JAX params are)."""
    out: Dict[str, Any] = {k: _tensor(v, device, dtype)
                           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: _tensor(v, device, dtype) for k, v in blk.items()}
                     for blk in tree["blocks"]]
    return out

"""Load the JAX model's parameters and optimizer state into the port.

torch cannot reproduce `jax.random`, so a comparison with the JAX model
loads its params by value: the caller turns the JAX pytree into numpy
arrays (`jax.tree.map(np.asarray, params)`) and hands them here.  The
layouts are the same ([d_in, d_out] weights), so nothing is transposed.
`opt_state_from_jax` does the same for the reference's optax state, so
a JAX-trained state can be continued in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch.workloads.device import resolve_device


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    # bf16 (ml_dtypes) has no torch.from_numpy path: widen it to f32;
    # np.array copies, so the tensor owns writable, contiguous memory
    wide = a.dtype.kind != "f" or a.dtype.itemsize < 4
    t = torch.from_numpy(np.array(a, dtype=np.float32 if wide else a.dtype))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Dict[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX `init_params` pytree (as numpy) -> the port's param dict,
    on `device` (`cuda` unless `"cpu"` is asked for, as every entry
    point), in `dtype` (default: f32, as the JAX params are)."""
    device = resolve_device(device)
    out: Dict[str, Any] = {k: _tensor(v, device, dtype)
                           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: _tensor(v, device, dtype) for k, v in blk.items()}
                     for blk in tree["blocks"]]
    return out


def opt_state_from_jax(state, device=None,
                       mu_dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, Any]:
    """The reference optimizer's state (`train.make_optimizer`'s optax
    chain, as numpy: `(clip EmptyState, (ScaleByAdamState(count, mu,
    nu), ...))`) -> the port's `AdamW` state `{"count", "mu", "nu"}` on
    `device`.  `mu_dtype` defaults to the dtype the reference kept mu
    in (bf16 or f32); nu is f32."""
    adam = state[1][0]
    if mu_dtype is None:
        first = np.asarray(adam.mu["embed"])
        mu_dtype = torch.bfloat16 if first.dtype.name == "bfloat16" \
            else torch.float32
    return {"count": int(np.asarray(adam.count)),
            "mu": params_from_jax(adam.mu, device, mu_dtype),
            "nu": params_from_jax(adam.nu, device, torch.float32)}

"""Load the JAX model's parameters and optimizer state into the port.

torch cannot reproduce `jax.random`, so a comparison with the JAX model
loads its params by value: the caller turns the JAX pytree into numpy
arrays (`jax.tree.map(np.asarray, params)`) and hands them here.  The
layouts are the same ([d_in, d_out] weights), so nothing is transposed.
`opt_state_from_jax` does the same for the reference's optax state, so
a JAX-trained state can be continued in the port.  Given a mesh, both
return the state sharded as `train.init_sharded` lays it out (DTensors
by `model.param_shardings`), so JAX's values load into every layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads.device import resolve_device


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    # bf16 (ml_dtypes) has no torch.from_numpy path: widen it to f32;
    # np.array copies, so the tensor owns writable, contiguous memory
    wide = a.dtype.kind != "f" or a.dtype.itemsize < 4
    t = torch.from_numpy(np.array(a, dtype=np.float32 if wide else a.dtype))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Dict[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None,
                    mesh=None) -> Dict[str, Any]:
    """The JAX `init_params` pytree (as numpy) -> the port's param dict,
    on `device` (`cuda` unless `"cpu"` is asked for, as every entry
    point), in `dtype` (default: f32, as the JAX params are); with a
    mesh, as DTensors holding this rank's shards (`model.distribute`)."""
    device = resolve_device(device)
    out = model_lib.map_named(lambda _, v: _tensor(v, device, dtype), tree)
    return out if mesh is None else model_lib.distribute(out, mesh)


def opt_state_from_jax(state, device=None,
                       mu_dtype: Optional[torch.dtype] = None,
                       mesh=None) -> Dict[str, Any]:
    """The reference optimizer's state (`train.make_optimizer`'s optax
    chain, as numpy: `(clip EmptyState, (ScaleByAdamState(count, mu,
    nu), ...))`) -> the port's `AdamW` state `{"count", "mu", "nu"}` on
    `device`, sharded like the params with a mesh.  `mu_dtype` defaults
    to the dtype the reference kept mu in (bf16 or f32); nu is f32."""
    adam = state[1][0]
    if mu_dtype is None:
        first = np.asarray(adam.mu["embed"])
        mu_dtype = torch.bfloat16 if first.dtype.name == "bfloat16" \
            else torch.float32
    return {"count": int(np.asarray(adam.count)),
            "mu": params_from_jax(adam.mu, device, mu_dtype, mesh),
            "nu": params_from_jax(adam.nu, device, torch.float32, mesh)}

"""Driver entry points of the port — the counterpart of the JAX package's
`__graft_entry__.py`.

entry(): a forward step of the flagship workload model at tiny shapes
in bf16.  train_entry(): one training step (loss, gradients, clip,
AdamW) at tiny shapes in f32.  Both run on `cuda` unless the caller
passes `device="cpu"`, and raise without a GPU otherwise.

    python -m volcano_tpu_torch.entry [cpu|cuda]
"""

from __future__ import annotations

import sys

import torch

from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads import train
from volcano_tpu_torch.workloads.device import resolve_device


def entry(device=None):
    """Return (fn, example_args) for a single-device forward step."""
    dev = resolve_device(device)
    cfg = model_lib.tiny_config(dtype=torch.bfloat16)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.zeros((4, 128), dtype=torch.int64, device=dev)

    def fn(params, tokens):
        return model_lib.forward(params, tokens, cfg)

    return fn, (params, tokens)


def train_entry(device=None):
    """Return (step, (params, opt_state, batch)) for one single-device
    training step; step returns (params, opt_state, metrics)."""
    dev = resolve_device(device)
    cfg = model_lib.tiny_config()
    optimizer = train.make_optimizer()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    batch = train.synthetic_batch(
        torch.Generator(device=dev).manual_seed(1), cfg, 4, 64)
    step = train.make_train_step(cfg, optimizer)
    return step, (params, optimizer.init(params), batch)


if __name__ == "__main__":
    where = sys.argv[1] if len(sys.argv) > 1 else None
    fn, args = entry(where)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    step, args = train_entry(where)
    _, _, metrics = step(*args)
    print("train_entry step: loss %.4f, grad_norm %.4f"
          % (float(metrics["loss"]), float(metrics["grad_norm"])))

"""What the drivers share: the program's model config from a cell's
sizes, and the time since the process started."""

from __future__ import annotations

import torch

from perfbench.cells import Sizes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(s: Sizes):
    """The port's `ModelConfig` at these sizes: flash attention, no
    remat (the cells' traffic asks for none)."""
    from volcano_tpu_torch.workloads.model import ModelConfig
    kw = dict(vocab_size=s.vocab, d_model=s.d_model, n_layers=s.n_layers,
              n_heads=s.n_heads, d_ff=s.d_ff, max_seq=s.max_seq,
              dtype=DTYPES[s.dtype], use_flash_attention=True,
              remat=False)
    return ModelConfig(**kw)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

"""Workload checkpoint/resume on `torch.distributed.checkpoint` (DCP) —
the port of `volcano_tpu.workloads.checkpoint`.

The scheduler side is stateless by design; the WORKLOAD side
checkpoints params + optimizer state so a preempted/restarted gang
resumes instead of recomputing.  A checkpoint is the directory
`<dir>/<step>`: DCP writes it as `<dir>/<step>.tmp` (several files: one
per writing rank plus the metadata), and rank 0 renames it into place
once every rank has written, so a reader never sees a partial one.
The state is saved flat (`params.blocks.0.wq`, ..., `opt_state.count`),
with the optimizer's int count as a 0-dim tensor.  Sharded state
(DTensors, `train.init_sharded`) is written as each rank's shards, and
replicated tensors once; a restore reads whatever each target tensor
holds, so a checkpoint restores at any world size and layout (fsdp and
tp shards, replicas, or plain tensors in a process without a group) —
the elastic contract.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from volcano_tpu_torch.workloads import bootstrap
from volcano_tpu_torch.workloads.train import named_leaves

TMP_SUFFIX = ".tmp"


def _flat_state(params: Dict[str, Any],
                opt_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flat DCP state dict, each entry a detached view of (or, for
    the count, a tensor holding) the state it names."""
    flat = {k: x.detach() for k, x in named_leaves(params, "params.")}
    flat["opt_state.count"] = torch.tensor(int(opt_state["count"]),
                                           dtype=torch.int64)
    for key in ("mu", "nu"):
        flat.update((k, x.detach())
                    for k, x in named_leaves(opt_state[key],
                                             f"opt_state.{key}."))
    return flat


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def close_all() -> None:
    """Process shutdown / tests.  `save` is synchronous, so nothing is
    left in flight; idempotent, as the reference's is."""


def save(directory: str, step: int, params: Dict[str, Any],
         opt_state: Dict[str, Any], max_to_keep: int = 3) -> None:
    """Save a training state atomically under directory/<step>, keep
    the newest `max_to_keep` steps, and return once the checkpoint is
    durable.  Every rank of the default group calls it (collective).

    The train step updates params and optimizer state in place (the
    port's counterpart of the reference's donation), so the state must
    be saved before the next step runs: this returns only when the
    files are written and synced."""
    directory = os.path.abspath(directory)
    final = os.path.join(directory, str(int(step)))
    tmp = final + TMP_SUFFIX
    if os.path.exists(final):
        raise FileExistsError(f"a checkpoint of step {step} exists: {final}")
    if _is_rank0():
        os.makedirs(directory, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)     # left by a crashed save
    _barrier()
    dcp.save(_flat_state(params, opt_state),
             storage_writer=dcp.FileSystemWriter(tmp, sync_files=True),
             no_dist=not dist.is_initialized())
    _barrier()
    if _is_rank0():
        os.rename(tmp, final)
        _fsync_dir(directory)
        steps = sorted(_steps(directory))
        for old in steps[:max(len(steps) - max_to_keep, 0)]:
            shutil.rmtree(os.path.join(directory, str(old)))
    _barrier()


def _steps(directory: str):
    return [int(name) for name in os.listdir(directory) if name.isdigit()
            and os.path.isdir(os.path.join(directory, name))]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, None when there is none;
    a missing directory is not created."""
    if not os.path.isdir(directory):
        return None
    return max(_steps(directory), default=None)


def restore(directory: str, params_like: Dict[str, Any],
            opt_state_like: Dict[str, Any],
            step: Optional[int] = None) -> Tuple[Any, Any, int]:
    """Restore (params, opt_state, step) in place into the *_like trees
    (e.g. freshly initialized state), which keep their devices, dtypes
    and layouts; the latest step unless `step` is given."""
    if not os.path.isdir(directory):
        # don't create an empty checkpoint dir just by probing
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    flat = _flat_state(params_like, opt_state_like)
    with torch.no_grad():
        dcp.load(flat, storage_reader=dcp.FileSystemReader(
            os.path.join(directory, str(step))),
            no_dist=not dist.is_initialized())
    opt_state_like["count"] = int(flat["opt_state.count"])
    return params_like, opt_state_like, step


def resume_state(params_like: Any, opt_state_like: Any,
                 directory: str = "",
                 resume_step: Optional[int] = None,
                 environ=None) -> Tuple[Any, Any, int]:
    """Failover-resume entry: restore (params, opt_state, start_step)
    from the checkpoint the control plane asserts exists, or fall back
    to the passed fresh state at step 0.

    directory/resume_step default from the injected env
    (VTP_CHECKPOINT_DIR / VTP_RESUME_STEP, workloads/bootstrap.py).
    The stamped resume step is a FLOOR, not an exact pin: a newer
    checkpoint (the workload kept saving between the stamp and the
    drain) is preferred — restore latest, then sanity-check it is not
    older than the stamp (an older-only dir means the checkpoint
    store lost data; restoring silently would quietly rewind
    training, so that raises)."""
    env = os.environ if environ is None else environ
    directory = directory or env.get(bootstrap.ENV_CHECKPOINT_DIR, "")
    if resume_step is None:
        raw = env.get(bootstrap.ENV_RESUME_STEP, "")
        resume_step = int(raw) if raw else None
    if not directory or latest_step(directory) is None:
        if resume_step is not None:
            raise FileNotFoundError(
                f"control plane stamped resume step {resume_step} but "
                f"no checkpoint exists under {directory!r}")
        return params_like, opt_state_like, 0
    params, opt_state, step = restore(directory, params_like,
                                      opt_state_like)
    if resume_step is not None and step < resume_step:
        raise RuntimeError(
            f"latest checkpoint step {step} < stamped resume step "
            f"{resume_step}: checkpoint store lost data")
    return params, opt_state, step

"""torch.distributed bootstrap from scheduler-injected environment — the
port of `volcano_tpu.workloads.bootstrap`.

The job plugin injects into every worker pod:

    TPU_WORKER_ID        - this worker's GLOBAL process index (its rank)
    TPU_WORKER_HOSTNAMES - comma-separated worker hostnames (all slices)
    COORDINATOR_ADDRESS  - host:port of process 0 (the TCP rendezvous)
    NUM_PROCESSES        - total process count (the world size)
    TPU_SLICE_ID         - this worker's slice (multi-slice only)
    TPU_NUM_SLICES       - slice count (multi-slice only; default 1)

`from_env` parses them exactly as the reference does.  A pod may hold
several GPUs: the reference's one process drives them all, the port
runs one process a GPU (the launcher in `worker.main` starts them with
LOCAL_RANK and LOCAL_WORLD_SIZE).  Such a process is rank
`TPU_WORKER_ID x LOCAL_WORLD_SIZE + LOCAL_RANK` of a world of
`NUM_PROCESSES x LOCAL_WORLD_SIZE` (`rank_and_world`); a process
started with LOCAL_RANK alone is one rank, `TPU_WORKER_ID`.

`initialize` forms the process group: nccl on `cuda`, gloo on `cpu`,
one GPU per process (`cuda:LOCAL_RANK`, default `cuda:0`).  Unlike the
reference, which skips `jax.distributed` for one process, it also forms
a one-rank group then, so that the device mesh, the collective proof
and the gradient reduction run the same code at every world size.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from volcano_tpu_torch.api.goodput import ENV_EPOCH, ENV_PROGRESS_FILE
from volcano_tpu_torch.workloads.device import resolve_device

ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_COORDINATOR = "COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "NUM_PROCESSES"
ENV_SLICE_ID = "TPU_SLICE_ID"
ENV_NUM_SLICES = "TPU_NUM_SLICES"
# failover resume contract (the failover controller stamps the job,
# the job plugin injects, workloads/checkpoint.resume_state consumes):
ENV_CHECKPOINT_DIR = "VTP_CHECKPOINT_DIR"
ENV_RESUME_STEP = "VTP_RESUME_STEP"
# the GPU this process drives when a pod runs several processes, and
# how many processes the pod runs (set by the launcher in worker.main)
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
DEFAULT_COORDINATOR_PORT = 8476
# how long a collective (the rendezvous included) may wait for a peer
# before it raises, so that a lost rank fails the job instead of hanging it
DEFAULT_TIMEOUT_S = 600.0


@dataclass
class BootstrapInfo:
    process_id: int = 0
    num_processes: int = 1
    coordinator_address: str = ""
    hostnames: Optional[List[str]] = None
    slice_id: int = 0
    num_slices: int = 1
    # failover resume: where the job checkpoints, and the step the
    # control plane asserts was durably saved before the slice died
    checkpoint_dir: str = ""
    resume_step: Optional[int] = None
    # goodput: where this worker publishes step progress, and the
    # control plane's restart/resize epoch for the record
    progress_file: str = ""
    epoch: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


def from_env(environ=None) -> BootstrapInfo:
    env = os.environ if environ is None else environ
    hostnames = [h for h in env.get(ENV_HOSTNAMES, "").split(",") if h]
    num = int(env.get(ENV_NUM_PROCESSES, len(hostnames) or 1))
    coordinator = env.get(ENV_COORDINATOR, "")
    if not coordinator and hostnames:
        coordinator = f"{hostnames[0]}:{DEFAULT_COORDINATOR_PORT}"
    resume_raw = env.get(ENV_RESUME_STEP, "")
    try:
        resume_step = int(resume_raw) if resume_raw else None
    except ValueError:
        resume_step = None     # malformed env must not kill bootstrap
    try:
        epoch = int(env.get(ENV_EPOCH, 0) or 0)
    except ValueError:
        epoch = 0
    return BootstrapInfo(
        process_id=int(env.get(ENV_WORKER_ID, 0)),
        num_processes=num,
        coordinator_address=coordinator,
        hostnames=hostnames or None,
        slice_id=int(env.get(ENV_SLICE_ID, 0)),
        num_slices=int(env.get(ENV_NUM_SLICES, 1)),
        checkpoint_dir=env.get(ENV_CHECKPOINT_DIR, ""),
        resume_step=resume_step,
        progress_file=env.get(ENV_PROGRESS_FILE, ""),
        epoch=epoch,
    )


def local_layout(environ=None) -> Tuple[int, int]:
    """(this process's index in its pod, the pod's process count): the
    launcher's (LOCAL_RANK, LOCAL_WORLD_SIZE).  Without LOCAL_WORLD_SIZE
    the process is its pod's only rank, (0, 1), whatever GPU LOCAL_RANK
    names."""
    env = os.environ if environ is None else environ
    if ENV_LOCAL_WORLD_SIZE not in env:
        return 0, 1
    index, n_local = int(env.get(ENV_LOCAL_RANK, 0)), \
        int(env[ENV_LOCAL_WORLD_SIZE])
    if not 0 <= index < n_local:
        raise ValueError(f"{ENV_LOCAL_RANK}={index} outside a pod of "
                         f"{n_local} processes")
    return index, n_local


def rank_and_world(info: BootstrapInfo, environ=None) -> Tuple[int, int]:
    """This process's global rank and the job's world size: each of the
    NUM_PROCESSES pods runs LOCAL_WORLD_SIZE ranks, pod-major."""
    index, n_local = local_layout(environ)
    return info.process_id * n_local + index, info.num_processes * n_local


def initialize(environ=None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> BootstrapInfo:
    """Form the default process group from the injected env (rank and
    world by `rank_and_world`) and return the parsed info.  `device`:
    `cuda` (the default; nccl on `cuda:LOCAL_RANK`, raises
    without a GPU) or `cpu` (gloo).  A group of several processes meets
    at `tcp://COORDINATOR_ADDRESS`; a one-process group uses a store of
    its own and opens no port.  Raises if a group already exists or the
    rendezvous fails."""
    env = os.environ if environ is None else environ
    info = from_env(env)
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    rank, world = rank_and_world(info, env)
    kwargs = dict(rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout))
    if dev.type == "cuda":
        local = torch.device("cuda", int(env.get(ENV_LOCAL_RANK, 0)))
        torch.cuda.set_device(local)
        # binding the group to its GPU forms the communicator now, so a
        # failed nccl init raises here and not at the first collective
        kwargs.update(backend="nccl", device_id=local)
    else:
        kwargs.update(backend="gloo")
    if world > 1:
        if not info.coordinator_address:
            raise ValueError(
                f"{world} processes but no {ENV_COORDINATOR} "
                f"or {ENV_HOSTNAMES} to meet at")
        dist.init_process_group(
            init_method=f"tcp://{info.coordinator_address}", **kwargs)
    else:
        dist.init_process_group(store=dist.HashStore(), **kwargs)
    return info

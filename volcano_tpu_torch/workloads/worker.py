"""Worker entrypoint: scheduler-injected env -> live process group and
device mesh — the port of `volcano_tpu.workloads.worker`.

`python -m volcano_tpu_torch.workloads.worker` is what a vcjob's worker
container runs.  It consumes the job plugin's contract end-to-end:

  1. bootstrap.initialize()  — TPU_WORKER_ID / NUM_PROCESSES /
     COORDINATOR_ADDRESS -> torch.distributed.init_process_group
  2. build the device mesh over every process's GPU
  3. run a cross-process collective (the mesh-is-real proof)
  4. resume from the stamped checkpoint, if any, and run a few
     data-parallel train steps, publishing goodput progress

Prints ONE JSON line, the last of stdout, with {process_id,
num_processes, device_count, collective_sum, loss, start_step, slice_id,
num_slices}.  Knobs via env: WORKER_STEPS, WORKER_DP (mesh dp override),
WORKER_GLOBAL_BATCH, and WORKER_DEVICE=cpu to run on the CPU under gloo
(the counterpart of the reference's JAX_PLATFORMS); without it the
worker runs on `cuda` under nccl and raises when there is no GPU.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from volcano_tpu_torch.workloads import bootstrap, checkpoint
from volcano_tpu_torch.workloads import mesh as mesh_lib
from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads import train
from volcano_tpu_torch.workloads.device import resolve_device
from volcano_tpu_torch.workloads.progress import ProgressReporter

ENV_DEVICE = "WORKER_DEVICE"
SEQ_LEN = 32


def worker_config() -> model_lib.ModelConfig:
    """The reference worker's model: the flagship LM at tiny shapes."""
    return model_lib.ModelConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq=64, dtype=torch.float32, use_flash_attention=False)


def run(environ=None) -> dict:
    env = os.environ if environ is None else environ
    device = resolve_device(env.get(ENV_DEVICE) or None)
    info = bootstrap.initialize(env, device=device)
    try:
        return _train(info, env, device.type)
    finally:
        dist.destroy_process_group()


def _train(info: bootstrap.BootstrapInfo, env, device_type: str) -> dict:
    n_dev = dist.get_world_size()          # one GPU per process
    if info.is_multislice:
        # hybrid dcn x ICI: dp rides the dcn axis across slices so the
        # gradient reduction is the ONLY per-step cross-slice traffic
        per_slice = n_dev // info.num_slices
        dp = int(env.get("WORKER_DP", 1))
        mesh = mesh_lib.make_hybrid_mesh(
            {"dcn": info.num_slices, "dp": dp, "fsdp": per_slice // dp},
            device_type, slice_id=info.slice_id)
    else:
        dp = int(env.get("WORKER_DP", n_dev))
        mesh = mesh_lib.make_mesh({"dp": dp, "fsdp": n_dev // dp},
                                  device_type)
    device = train.mesh_device(mesh)

    # collective sanity: every device contributes 1; the global sum
    # crossing process (and slice) boundaries proves the group spans
    # the job
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    collective_sum = float(ones.item())

    cfg = worker_config()
    optimizer = train.make_optimizer()
    params, opt_state, _ = train.init_sharded(
        torch.Generator().manual_seed(0), cfg, mesh, optimizer)
    # failover resume (VTP_CHECKPOINT_DIR / VTP_RESUME_STEP from the
    # job plugin): restore the last durable state instead of starting
    # over
    start_step = 0
    if info.checkpoint_dir or info.resume_step is not None:
        params, opt_state, start_step = checkpoint.resume_state(
            params, opt_state, directory=info.checkpoint_dir,
            resume_step=info.resume_step, environ=env)
    # WORKER_GLOBAL_BATCH pins the GLOBAL batch across elastic resizes
    # (defaults to one sample per device); every rank draws it from the
    # same CPU generator and keeps its rows
    global_batch = int(env.get("WORKER_GLOBAL_BATCH", n_dev))
    batch = train.synthetic_batch(torch.Generator().manual_seed(1), cfg,
                                  global_batch, SEQ_LEN, mesh)
    step = train.make_train_step(cfg, optimizer, mesh)
    reporter = ProgressReporter.from_env(env)
    if reporter is not None:
        reporter.report(step=start_step, examples=0.0)
    loss = float("nan")
    steps_done = 0
    for _ in range(int(env.get("WORKER_STEPS", "3"))):
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        steps_done += 1
        if reporter is not None:
            reporter.report(step=start_step + steps_done,
                            examples=steps_done * global_batch)
    return {
        "process_id": info.process_id,
        "num_processes": info.num_processes,
        "device_count": n_dev,
        "collective_sum": collective_sum,
        "loss": round(loss, 4),
        "start_step": start_step,
        "slice_id": info.slice_id,
        "num_slices": info.num_slices,
    }


def main() -> int:
    out = run()
    print(json.dumps(out), flush=True)
    ok = (out["collective_sum"] == out["device_count"]
          and out["loss"] == out["loss"])          # NaN check
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

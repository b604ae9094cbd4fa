"""Worker entrypoint: scheduler-injected env -> live process group and
device mesh — the port of `volcano_tpu.workloads.worker`.

`python -m volcano_tpu_torch.workloads.worker` is what a vcjob's worker
container runs.  It consumes the job plugin's contract end-to-end:

  1. bootstrap.initialize()  — TPU_WORKER_ID / NUM_PROCESSES /
     COORDINATOR_ADDRESS -> torch.distributed.init_process_group
  2. build the device mesh over every process's GPU
  3. run a cross-process collective (the mesh-is-real proof)
  4. resume from the stamped checkpoint, if any, and run a few train
     steps on the mesh (params sharded as the reference shards them),
     publishing goodput progress

A pod drives every GPU it holds, as the reference's one process drives
every device of its pod: when it sees n_local > 1 GPUs
(`torch.cuda.device_count()`, which honours CUDA_VISIBLE_DEVICES),
`main` starts one child process a GPU with LOCAL_RANK and
LOCAL_WORLD_SIZE set (`launch`), and each child is one rank of the job
(`bootstrap.rank_and_world`).  If a child fails or is killed, the others
are ended and the pod exits non-zero, so a lost GPU fails the pod at
once.  A process started with LOCAL_RANK already set is one rank and
starts nothing.

Each pod prints ONE JSON line, the last of its stdout, with
{process_id, num_processes, device_count, collective_sum, loss,
start_step, slice_id, num_slices}: process_id and num_processes are the
pod's index and the pod count, device_count the GPUs of the job.  The
pod's first rank prints it and publishes the pod's progress.  Knobs via
env: WORKER_STEPS, WORKER_DP (mesh dp override), WORKER_GLOBAL_BATCH,
and WORKER_DEVICE=cpu to run on the CPU under gloo (the counterpart of
the reference's JAX_PLATFORMS), with WORKER_LOCAL_DEVICES ranks a pod
(default 1; the counterpart of the reference tests'
--xla_force_host_platform_device_count); without it the worker runs on
`cuda` under nccl and raises when there is no GPU.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from volcano_tpu_torch.workloads import bootstrap, checkpoint
from volcano_tpu_torch.workloads import mesh as mesh_lib
from volcano_tpu_torch.workloads import model as model_lib
from volcano_tpu_torch.workloads import train
from volcano_tpu_torch.workloads.device import resolve_device
from volcano_tpu_torch.workloads.progress import ProgressReporter

ENV_DEVICE = "WORKER_DEVICE"
ENV_LOCAL_DEVICES = "WORKER_LOCAL_DEVICES"
SEQ_LEN = 32
# how often the launcher looks at its children, and how long a child
# ended by the launcher gets before it is killed
POLL_S = 0.2
TERMINATE_GRACE_S = 10.0


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
    # (defaults to one sample per GPU of the job); every rank draws it
    # from the same CPU generator and keeps its rows
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


def local_device_count(environ=None) -> int:
    """The ranks this pod runs: 1 for a process that is already one
    rank (LOCAL_RANK set by its caller), else the GPUs it sees, or on
    the CPU WORKER_LOCAL_DEVICES (default 1)."""
    env = os.environ if environ is None else environ
    if bootstrap.ENV_LOCAL_RANK in env:
        return 1
    if resolve_device(env.get(ENV_DEVICE) or None).type == "cuda":
        return torch.cuda.device_count()
    return int(env.get(ENV_LOCAL_DEVICES, 1))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _end(procs) -> None:
    """Terminate the children still running; kill those that outlast
    TERMINATE_GRACE_S."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + TERMINATE_GRACE_S
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(n_local: int, environ=None) -> int:
    """Run this pod as n_local child processes of this module, child i
    with LOCAL_RANK=i and LOCAL_WORLD_SIZE=n_local, sharing this
    process's stdout and stderr.  Returns 0 when every child exits 0;
    when one fails or is killed, ends the others and returns its code
    (1 for a signal).  SIGTERM and SIGINT end the children too.

    Not `torch.distributed.run`: its elastic agent looks up the host's
    fully qualified name (`socket.getfqdn`) for its event records, and a
    pod must start without name resolution; the job's coordinator comes
    from the plugin's env, so no rendezvous of the agent's is needed."""
    env = dict(os.environ if environ is None else environ)
    info = bootstrap.from_env(env)
    if info.num_processes == 1 and not info.coordinator_address:
        # a one-pod job meets on this host
        env[bootstrap.ENV_COORDINATOR] = f"127.0.0.1:{_free_port()}"
    env[bootstrap.ENV_LOCAL_WORLD_SIZE] = str(n_local)
    procs = []

    def stop(signum, _frame):
        raise SystemExit(128 + signum)

    handlers = {sig: signal.signal(sig, stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        for i in range(n_local):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "volcano_tpu_torch.workloads.worker"],
                env=dict(env, **{bootstrap.ENV_LOCAL_RANK: str(i)})))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                print(f"worker: a rank of this pod exited {failed[0]}; "
                      "ending the others", file=sys.stderr, flush=True)
                return failed[0] if failed[0] > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(POLL_S)
    finally:
        _end(procs)
        for sig, handler in handlers.items():
            signal.signal(sig, handler)


def main() -> int:
    n_local = local_device_count()
    if n_local > 1:
        return launch(n_local)
    out = run()
    if bootstrap.local_layout()[0] == 0:
        print(json.dumps(out), flush=True)
    ok = (out["collective_sum"] == out["device_count"]
          and out["loss"] == out["loss"])          # NaN check
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's worker over several GPUs of one host, on nccl: one process
a GPU (LOCAL_RANK), a flat mesh and a hybrid one, against one process's
loss on the whole global batch computed on the CPU.

Needs two or more CUDA GPUs and skips without them.  Imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt
from volcano_tpu_torch.workloads import worker as tworker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 300
# the worker prints its loss rounded to 4 digits; f32 on two devices
# differs by sum order only
PRINTED = 5e-5
SHARE = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_process_loss(global_batch, steps):
    cfg = tworker.worker_config()
    opt = tt.make_optimizer()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg,
                               global_batch, tworker.SEQ_LEN)
    step = tt.make_train_step(cfg, opt)
    for _ in range(steps):
        params, state, m = step(params, state, batch)
    return float(m["loss"])


@pytest.mark.gpu
@pytest.mark.parametrize("slices", [1, 2], ids=["flat", "two_slices"])
def test_workers_over_nccl_match_one_process(slices):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs 2 or more CUDA GPUs, found {n}")
    port = free_port()
    envs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k != "WORKER_DEVICE"}
        env.update(PYTHONPATH=REPO, TPU_WORKER_ID=str(r),
                   NUM_PROCESSES=str(n), LOCAL_RANK=str(r),
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   WORKER_GLOBAL_BATCH=str(n), WORKER_STEPS="3")
        if slices > 1:
            env.update(TPU_SLICE_ID=str(r * slices // n),
                       TPU_NUM_SLICES=str(slices))
        envs.append(env)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.workloads.worker"],
        env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for env in envs]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=PROC_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [r["collective_sum"] for r in results] == [float(n)] * n
    assert [r["device_count"] for r in results] == [n] * n
    assert len({r["loss"] for r in results}) == 1
    ref = _one_process_loss(n, 3)
    print(json.dumps({"gpus": n, "slices": slices, "loss": results[0]["loss"],
                      "one_process_loss": ref}))
    assert abs(results[0]["loss"] - ref) <= PRINTED + SHARE * abs(ref)

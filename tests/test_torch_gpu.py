"""The port on CUDA GPUs, on nccl: the worker over several GPUs of one
host, as one process a GPU (LOCAL_RANK) and as pods whose launcher
starts a rank a visible GPU, against one process's loss on the whole
global batch computed on the CPU; the flagship d2048-L8 trained at full
width with params and AdamW state sharded over fsdp and tp, against the
one-card step from the same weights; and the flash dispatch's shapes
that the kernels do not take.

Each test needs the GPUs it names and skips without them.  Imports no
JAX, so it runs where only PyTorch is installed (4 GPUs for all of it):

    python -m pytest tests/test_torch_gpu.py -m gpu -q -s
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time

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
# the flagship's losses and grad norms, sharded against one card from
# the same weights, over 5 steps (lr(0) = 0, so steps 3-5 follow 1-3
# real updates).  f32 differs by sum order only.  bf16 rounds each
# rank's partial sums (the tp all-reduce adds bf16 partials of wo and
# w_down, where one card rounds the whole sum once) and cuBLAS picks
# other tiles for the narrower products: over these 5 steps on 4 H100s
# the losses moved by at most 2.0e-5 and the norms by at most 1.5e-4 of
# their value (f32: 9e-8), and each bf16 tolerance is 3 to 5 times its
# reading
RTOL_FLAGSHIP_F32 = dict(losses=1e-5, norms=1e-5)
RTOL_FLAGSHIP_BF16 = dict(losses=1e-4, norms=5e-4)
FLAGSHIP_BATCH, FLAGSHIP_SEQ, FLAGSHIP_STEPS = 8, 2048, 5
# memory after init under 4-way sharding: a quarter of the replicated
# state, plus the norms (replicated on every rank), plus 1% of the
# replicated state for the batch and the allocator's rounding
MEMORY_MARGIN = 0.01


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gpus(n):
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        pytest.skip(f"needs {n} or more CUDA GPUs, found {found}")


def _run(argvs, envs):
    """Start one process per (argv, env) from the repo root and wait for
    all: [(returncode, stdout, stderr)].  Kills them all on timeout."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for argv, env in zip(argvs, envs)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=PROC_TIMEOUT_S)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _base_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORKER_DEVICE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "CUDA_VISIBLE_DEVICES")}
    env.update(PYTHONPATH=REPO)
    env.update({k: str(v) for k, v in extra.items()})
    return env


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
    _gpus(2)
    n = torch.cuda.device_count()
    port = free_port()
    envs = []
    for r in range(n):
        env = _base_env(TPU_WORKER_ID=r, NUM_PROCESSES=n, LOCAL_RANK=r,
                        COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        WORKER_GLOBAL_BATCH=n, WORKER_STEPS=3)
        if slices > 1:
            env.update(TPU_SLICE_ID=str(r * slices // n),
                       TPU_NUM_SLICES=str(slices))
        envs.append(env)
    results = []
    for rc, out, err in _run(
            [[sys.executable, "-m", "volcano_tpu_torch.workloads.worker"]] * n,
            envs):
        assert rc == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["collective_sum"] for r in results] == [float(n)] * n
    assert [r["device_count"] for r in results] == [n] * n
    assert len({r["loss"] for r in results}) == 1
    ref = _one_process_loss(n, 3)
    print(json.dumps({"gpus": n, "slices": slices, "loss": results[0]["loss"],
                      "one_process_loss": ref}))
    assert abs(results[0]["loss"] - ref) <= PRINTED + SHARE * abs(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("pods", [2, 1], ids=["2_pods_x_2", "1_pod_x_4"])
def test_pods_drive_every_visible_gpu(pods):
    """4 GPUs as pods that each see 4 / pods of them
    (CUDA_VISIBLE_DEVICES): each pod's launcher starts a rank a GPU, the
    job trains on all 4, each pod prints one JSON line with
    device_count 4, and the loss equals one process's."""
    _gpus(4)
    local = 4 // pods
    port = free_port()
    envs = [_base_env(TPU_WORKER_ID=i, NUM_PROCESSES=pods, WORKER_STEPS=3,
                      CUDA_VISIBLE_DEVICES=",".join(
                          str(i * local + j) for j in range(local)),
                      **({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}"}
                         if pods > 1 else {}))
            for i in range(pods)]
    results = []
    t0 = time.monotonic()
    outs = _run(
        [[sys.executable, "-m", "volcano_tpu_torch.workloads.worker"]] * pods,
        envs)
    wall_s = time.monotonic() - t0
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
        assert len(lines) == 1 and out.strip().splitlines()[-1] == lines[0]
        results.append(json.loads(lines[0]))
    assert [r["process_id"] for r in results] == list(range(pods))
    assert all(r["device_count"] == 4 and r["collective_sum"] == 4.0 and
               r["num_processes"] == pods for r in results)
    assert len({r["loss"] for r in results}) == 1
    ref = _one_process_loss(4, 3)
    print(json.dumps({"pods": pods, "gpus_per_pod": local, "wall_s": wall_s,
                      "loss": results[0]["loss"], "one_process_loss": ref}))
    assert abs(results[0]["loss"] - ref) <= PRINTED + SHARE * abs(ref)


# -- the flagship at full width, sharded over 4 GPUs --------------------

RANK_FLAGSHIP = r"""
import importlib, json, sys, time
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
fa = importlib.import_module("volcano_tpu_torch.workloads.ops.flash_attention")
axes, layers, dtype, batch, seq, steps = (
    json.loads(sys.argv[1]), int(sys.argv[2]), getattr(torch, sys.argv[3]),
    int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]))
cfg = tm.flagship_config(n_layers=layers, dtype=dtype)
bootstrap.initialize(device="cuda")
gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
opt = tt.make_optimizer()
if axes:
    mesh = mesh_lib.make_mesh(axes, "cuda")
    params, state, _ = tt.init_sharded(gen(5), cfg, mesh, opt)
else:
    mesh = None
    params = tm.init_params(cfg, gen(5), "cuda")
    state = opt.init(params)
torch.cuda.synchronize()
after_init = torch.cuda.memory_allocated()
data = tt.synthetic_batch(gen(6), cfg, batch, seq, mesh)
step = tt.make_train_step(cfg, opt, mesh)
torch.cuda.reset_peak_memory_stats()
fa.flash_fwd.launches = 0
fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
losses, norms, ms = [], [], []
for _ in range(steps):
    t0 = time.monotonic()
    params, state, m = step(params, state, data)
    losses.append(m["loss"].item()); norms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    ms.append((time.monotonic() - t0) * 1e3)
launches = [fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
            fa.flash_bwd.launches_dkv]
# one more step under the profiler, for where its time goes: device ms
# by kernel group (nccl's collectives run on a stream of their own, so
# the groups may sum to more than the wall)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.monotonic()
    step(params, state, data)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
groups = dict(nccl=0.0, flash=0.0, matmul=0.0, other=0.0)
for evt in prof.events():
    if evt.device_type == DeviceType.CUDA:
        low = evt.name.lower()
        group = ("nccl" if "nccl" in low else "flash" if "flash" in low else
                 "matmul" if any(k in low for k in ("gemm", "nvjet", "xmma",
                                                    "cutlass")) else "other")
        groups[group] += evt.time_range.elapsed_us() / 1e3
if dist.get_rank() == 0:
    print(json.dumps({"losses": losses, "norms": norms, "step_ms": ms,
                      "profile": dict(groups, wall_ms=wall),
                      "launches": launches,
                      "memory_after_init": after_init,
                      "peak_memory": torch.cuda.max_memory_allocated()}))
dist.destroy_process_group()
"""


def _flagship(axes, layers, dtype):
    """RANK_FLAGSHIP over one rank a GPU of the mesh `axes` (one card
    with no mesh when empty): rank 0's JSON result, with a sixth step's
    device time by kernel group."""
    world = 1
    for n in axes.values():
        world *= n
    port = free_port()
    outs = _run(
        [[sys.executable, "-c", RANK_FLAGSHIP, json.dumps(axes), str(layers),
          dtype, str(FLAGSHIP_BATCH), str(FLAGSHIP_SEQ),
          str(FLAGSHIP_STEPS)]] * world,
        [_base_env(TPU_WORKER_ID=r, NUM_PROCESSES=world, LOCAL_RANK=r,
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
         for r in range(world)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return json.loads(outs[0][1].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def one_card():
    """The one-card step's results, by (layers, dtype), run once each."""
    cache = {}

    def get(layers, dtype):
        if (layers, dtype) not in cache:
            cache[(layers, dtype)] = _flagship({}, layers, dtype)
        return cache[(layers, dtype)]

    return get


@pytest.mark.gpu
@pytest.mark.parametrize("layers,dtype,rtol", [
    (8, "bfloat16", RTOL_FLAGSHIP_BF16), (2, "float32", RTOL_FLAGSHIP_F32)],
    ids=["L8_bf16", "L2_f32"])
@pytest.mark.parametrize("axes", [{"fsdp": 4}, {"fsdp": 2, "tp": 2}],
                         ids=["fsdp4", "fsdp2_tp2"])
def test_flagship_sharded_matches_one_card(axes, layers, dtype, rtol,
                                           one_card):
    """The flagship d2048 model at global batch 8 x 2048, 5 steps from
    one set of weights, on 4 GPUs: the losses and grad norms equal the
    one-card step's within rtol, each rank launches every flash kernel
    once a layer a step (on its b / data-ranks rows and n_heads / tp
    heads), and each GPU holds a quarter of the params and AdamW state,
    plus the replicated norms."""
    _gpus(4)
    got = _flagship(axes, layers, dtype)
    ref = one_card(layers, dtype)
    cfg = tm.flagship_config(n_layers=layers)
    d, f = cfg.d_model, cfg.d_ff
    params = 2 * cfg.vocab_size * d + d + layers * (4 * d * d + 2 * d +
                                                    3 * d * f)
    replicated = 3 * 4 * params            # f32 params, mu and nu
    norms = 3 * 4 * (2 * layers + 1) * cfg.d_model
    bound = replicated / 4 + norms + MEMORY_MARGIN * replicated
    print(json.dumps({"axes": axes, "layers": layers, "dtype": dtype,
                      "sharded": got, "one_card": ref,
                      "replicated_state": replicated,
                      "memory_bound": bound}))
    for name in ("losses", "norms"):
        torch.testing.assert_close(torch.tensor(got[name]),
                                   torch.tensor(ref[name]),
                                   rtol=rtol[name], atol=0)
    assert got["launches"] == [layers * FLAGSHIP_STEPS] * 3
    assert ref["memory_after_init"] >= replicated
    assert got["memory_after_init"] <= bound


# -- the flash dispatch on the card --------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,block", [
    ((1, 256, 2, 384), torch.bfloat16, None),
    ((1, 192, 2, 128), torch.bfloat16, "64")], ids=["d384", "t192_block64"])
def test_uncovered_shapes_on_cuda_raise(shape, dtype, block, monkeypatch):
    """Shapes supported() admits and the kernels do not take raise on the
    card, naming ROADMAP B.4, before any launch and with no fallback to
    the plain version; a shape the kernels take still launches them."""
    _gpus(1)
    fa = importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")
    if block:
        monkeypatch.setenv("FLASH_BLOCK", block)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    launches = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="ROADMAP B.4"):
        fa.flash_attention(q, k, v)
    assert fa.flash_fwd.launches == launches
    monkeypatch.delenv("FLASH_BLOCK", raising=False)
    q, k, v = (torch.randn((1, 256, 2, 128), generator=g,
                           device="cuda").to(dtype) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    assert fa.flash_fwd.launches == launches + 1
    torch.testing.assert_close(out.float(),
                               fa._reference(q, k, v, True).float(),
                               atol=1e-2, rtol=1e-2)

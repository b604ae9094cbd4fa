"""The port on CUDA GPUs, on nccl: the worker over several GPUs of one
host, as one process a GPU (LOCAL_RANK) and as pods whose launcher
starts a rank a visible GPU, against one process's loss on the whole
global batch computed on the CPU; the flagship d2048-L8 trained at full
width with params and AdamW state sharded over fsdp and tp, and with the
sequence over sp (Ulysses, the ring, the gathered path, and Ulysses at
t 8192), against the one-card step from the same weights; the MoE
flagship with its experts over fsdp (expert parallelism) and tp, and the
flagship pipelined over pp (GPipe, flat and a stage per slice), against
the one-card step from the same weights; the flash kernels at the
shapes beyond d in {128, 256} and t % 128 == 0; and one pod a GPU
scheduled by the port's own control plane and launched on nccl.

Each test needs the GPUs it names and skips without them.  Imports no
JAX, so it runs where only PyTorch is installed (4 GPUs for all of it):

    python -m pytest tests/test_torch_gpu.py -m gpu -q -s
"""

import glob
import importlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
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
# the same under sp, bf16: besides tp's partial sums, the matmuls run on
# t / sp rows a rank and the gradients are summed over sp, and the ring
# and the gathered path run the eager attention on sequence blocks (the
# ring in an online softmax).  Over 5 steps on 4 H100s the six sp runs
# moved the losses by at most 3.2e-5 and the norms by at most 1.8e-4 of
# their value (f32: 1.3e-7); each bound is about 4 times its reading
RTOL_SP_BF16 = dict(losses=1.5e-4, norms=7e-4)
# the MoE flagship (4 experts, top-2, capacity 1.5) sharded against one
# card, bf16, stated before the first 4-GPU run: besides the dense
# paths' rounding, each rank routes its own rows, so a token whose two
# best experts nearly tie in bf16 may take the other one.  The loss bound
# is no looser than the reference's 5e-3 on the loss of its own
# experts-over-slices check (4e-4 of a loss near 10.9 is 4.4e-3); a
# flipped route moves the gradients more than the loss
RTOL_MOE_BF16 = dict(losses=4e-4, norms=5e-3)
# the pipelined flagship against one card, bf16: chip_smoke.py's
# RTOL_PP_BF16 (microbatches of 2 rows; measured at pp 1 on one H100:
# 1.9e-5 and 2.9e-4)
RTOL_PP_BF16 = dict(losses=1.5e-4, norms=7e-4)
# f32 MoE from the first step in which some token took other experts
# than on one card (a near tie broken the other way by sum-order noise,
# which f32 meets too): on 4 H100s one flipped token (of 16384 x 1 MoE
# layer a step) moved the loss by 3.9e-6 and the norm by 2.8e-5 of
# their values, so at most MOE_F32_MAX_FLIPS tokens a step may flip and
# the gaps stay within about 4 times that reading a flip.  A run that
# computes in a lower precision flips hundreds a step from step 1 (bf16:
# 226-2847) and fails the count
RTOL_MOE_F32_FLIP = dict(losses=2e-5, norms=1e-4)
MOE_F32_MAX_FLIPS = 4
MOE_FLAGS = {"n_experts": 4, "expert_top_k": 2, "moe_capacity_factor": 1.5}
PP_MICROBATCHES = 4
FLAGSHIP_BATCH, FLAGSHIP_SEQ, FLAGSHIP_STEPS = 8, 2048, 5
LONG_BATCH, LONG_SEQ = 2, 8192
# the flash kernels' bf16 tolerance, as chip_smoke.py's TOL_BF16
TOL_BF16 = 1e-2
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
def test_port_scheduled_pods_on_visible_gpus():
    """The port's own control plane places one pod a visible GPU on this
    host (a single-host NVLink domain of that many GPUs); each pod,
    launched with the env the torch and svc job plugins injected and
    its GPU as CUDA_VISIBLE_DEVICES (the device plugin's part), is a
    rank of one nccl group, and the loss is one process's."""
    _gpus(1)
    from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
    from volcano_tpu_torch.api.pod import Container, Pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.types import JobPhase
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import domain_nodes
    from volcano_tpu_torch.webhooks.admission import default_admission
    n = torch.cuda.device_count()
    product = torch.cuda.get_device_properties(0).name.replace(" ", "-")
    cluster = FakeCluster(admission=default_admission())
    for node in domain_nodes(DomainTopology("local", product, 1, n)):
        cluster.add_node(node)
    mgr = ControllerManager(cluster, enabled=["job", "queue"])
    sched = Scheduler(cluster, schedule_period=0)
    job = cluster.add_vcjob(VCJob(
        name="gpus", min_available=n, plugins={"torch": [], "svc": []},
        tasks=[TaskSpec(name="worker", replicas=n, template=Pod(
            name="t", containers=[Container(requests={"cpu": 1,
                                                      GPU: 1})]))]))
    for _ in range(3):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    assert cluster.vcjobs[job.key].phase is JobPhase.RUNNING
    pods = sorted((p for p in cluster.pods.values() if p.owner == job.uid),
                  key=lambda p: p.task_index)
    assert [p.node_name for p in pods] == ["local-w0"] * n
    port = free_port()
    envs = []
    for pod in pods:
        env = _base_env(**pod.containers[0].env)
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES=str(pod.task_index))
        envs.append(env)
    results = []
    for rc, out, err in _run(
            [[sys.executable, "-m", "volcano_tpu_torch.workloads.worker"]] * n,
            envs):
        assert rc == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["process_id"] for r in results] == list(range(n))
    assert [r["collective_sum"] for r in results] == [float(n)] * n
    assert [r["device_count"] for r in results] == [n] * n
    assert len({r["loss"] for r in results}) == 1
    ref = _one_process_loss(n, 3)
    print(json.dumps({"scheduled_pods": n, "loss": results[0]["loss"],
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
axes, layers, dtype, batch, seq, steps, flags = (
    json.loads(sys.argv[1]), int(sys.argv[2]), getattr(torch, sys.argv[3]),
    int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]),
    json.loads(sys.argv[7]))
cfg = tm.flagship_config(n_layers=layers, dtype=dtype, max_seq=seq, **flags)
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
# with a routes path (argv 8), every MoE layer's chosen experts of the
# steps, saved a rank with the first of its rows and of its columns
routes = []
from volcano_tpu_torch.workloads import moe
top_k = moe.top_k
if len(sys.argv) > 8:
    def recording(probs, k):
        vals, idx = top_k(probs, k)
        routes.append(idx.cpu())
        return vals, idx
    moe.top_k = recording
losses, norms, ms = [], [], []
for _ in range(steps):
    t0 = time.monotonic()
    params, state, m = step(params, state, data)
    losses.append(m["loss"].item()); norms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    ms.append((time.monotonic() - t0) * 1e3)
moe.top_k = top_k
if len(sys.argv) > 8:
    import numpy as np
    shard = tt.batch_sharding(mesh) if mesh else None
    rows = shard.rows(batch) if mesh else slice(0, batch)
    cols = shard.cols(seq) if mesh else slice(0, seq)
    np.savez(f"{sys.argv[8]}.rank{dist.get_rank()}.npz",
             routes=torch.stack(routes).numpy(), start=rows.start,
             col=cols.start)
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


def _flagship(axes, layers, dtype, flags=None, batch=FLAGSHIP_BATCH,
              seq=FLAGSHIP_SEQ, routes=None):
    """RANK_FLAGSHIP over one rank a GPU of the mesh `axes` (one card
    with no mesh when empty), the flagship config with `flags`: rank 0's
    JSON result, with a sixth step's device time by kernel group.  With
    `routes`, a path prefix, each rank saves its MoE routes there."""
    world = 1
    for n in axes.values():
        world *= n
    port = free_port()
    outs = _run(
        [[sys.executable, "-c", RANK_FLAGSHIP, json.dumps(axes), str(layers),
          dtype, str(batch), str(seq), str(FLAGSHIP_STEPS),
          json.dumps(flags or {})] + ([routes] if routes else [])] * world,
        [_base_env(TPU_WORKER_ID=r, NUM_PROCESSES=world, LOCAL_RANK=r,
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
         for r in range(world)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return json.loads(outs[0][1].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    """The one-card step's results, by (layers, dtype, flash attention
    or eager, batch, seq, flags), run once each; with MoE flags its
    routes are saved under the path prefix `routes` of the result."""
    cache = {}
    folder = tmp_path_factory.mktemp("one_card")

    def get(layers, dtype, flash=True, batch=FLAGSHIP_BATCH,
            seq=FLAGSHIP_SEQ, flags=None):
        key = (layers, dtype, flash, batch, seq, json.dumps(flags or {}))
        if key not in cache:
            routes = str(folder / f"routes{len(cache)}") \
                if (flags or {}).get("n_experts") else None
            cache[key] = _flagship({}, layers, dtype,
                                   dict(flags or {},
                                        use_flash_attention=flash),
                                   batch, seq, routes)
            cache[key]["routes"] = routes
        return cache[key]

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


# -- the flagship with the sequence over sp, on 4 GPUs --------------------

SP_CASES = [
    ({"sp": 4}, {"use_ulysses_attention": True}),
    ({"tp": 2, "sp": 2}, {"use_ulysses_attention": True}),
    ({"sp": 4}, {"use_ring_attention": True}),
    ({"fsdp": 2, "sp": 2}, {"use_ring_attention": True}),
    ({"dp": 2, "sp": 2}, {}),
]
SP_IDS = ["sp4_ulysses", "tp2_sp2_ulysses", "sp4_ring", "fsdp2_sp2_ring",
          "dp2_sp2_gathered"]


def _hold_sp(got, ref, layers, rtol, flash):
    for name in ("losses", "norms"):
        torch.testing.assert_close(torch.tensor(got[name]),
                                   torch.tensor(ref[name]),
                                   rtol=rtol[name], atol=0)
    # Ulysses launches every flash kernel once a layer a step on each
    # rank; the ring and the gathered path run the eager attention
    assert got["launches"] == [layers * FLAGSHIP_STEPS if flash else 0] * 3


@pytest.mark.gpu
@pytest.mark.parametrize("layers,dtype,rtol", [
    (8, "bfloat16", RTOL_SP_BF16), (2, "float32", RTOL_FLAGSHIP_F32)],
    ids=["L8_bf16", "L2_f32"])
@pytest.mark.parametrize("axes,flags", SP_CASES, ids=SP_IDS)
def test_flagship_sp_matches_one_card(axes, flags, layers, dtype, rtol,
                                      one_card):
    """The flagship d2048 model at global batch 8 x 2048, 5 steps from
    one set of weights, with the sequence over sp on 4 GPUs: Ulysses
    (each rank's flash kernels at [8, 2048, 4, 128]) against the
    one-card flash step, the ring and the gathered path against the
    one-card eager step (the reference's ring never runs flash); losses
    and grad norms within rtol (steps 3-5 follow 1-3 real updates, as
    lr(0) = 0)."""
    _gpus(4)
    flash = bool(flags.get("use_ulysses_attention"))
    got = _flagship(axes, layers, dtype, flags)
    ref = one_card(layers, dtype, flash)
    print(json.dumps({"axes": axes, "flags": flags, "layers": layers,
                      "dtype": dtype, "sp": got, "one_card": ref}))
    _hold_sp(got, ref, layers, rtol, flash)


@pytest.mark.gpu
def test_long_context_ulysses_matches_one_card(one_card):
    """Ulysses at t 8192, global batch 2, on 4 GPUs at sp 4 (each rank's
    flash kernels at [2, 8192, 4, 128]) against the one-card flash step
    at the same t."""
    _gpus(4)
    flags = {"use_ulysses_attention": True}
    got = _flagship({"sp": 4}, 8, "bfloat16", flags, LONG_BATCH, LONG_SEQ)
    ref = one_card(8, "bfloat16", True, LONG_BATCH, LONG_SEQ)
    print(json.dumps({"axes": {"sp": 4}, "flags": flags, "layers": 8,
                      "dtype": "bfloat16", "batch": LONG_BATCH,
                      "seq": LONG_SEQ, "sp": got, "one_card": ref}))
    _hold_sp(got, ref, 8, RTOL_SP_BF16, True)


# -- MoE with expert parallelism, and GPipe, on 4 GPUs ---------------------

def _moe_params(layers):
    """The MoE flagship's param count at `layers` (experts in the odd
    layers)."""
    cfg = tm.flagship_moe_config(n_layers=layers)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    attn = 4 * d * d + 2 * d
    moe = (layers // 2) * (attn + d * e + 3 * e * d * f)
    dense = (layers - layers // 2) * (attn + 3 * d * f)
    return 2 * cfg.vocab_size * d + d + moe + dense


def _route_flips(sharded, one):
    """Tokens a step whose chosen experts (any MoE layer) differ between
    the ranks' routes (path prefix `sharded`) and one card's (`one`);
    ranks holding the same block of rows and columns (tp) are counted
    once."""
    ref = np.load(f"{one}.rank0.npz")["routes"]      # [steps x L, b, t, k]
    per = ref.shape[0] // FLAGSHIP_STEPS
    flips, seen = np.zeros(FLAGSHIP_STEPS, dtype=np.int64), set()
    for path in sorted(glob.glob(f"{sharded}.rank*.npz")):
        data = np.load(path)
        start, col, got = int(data["start"]), int(data["col"]), data["routes"]
        if (start, col) in seen:
            continue
        seen.add((start, col))
        b, t = got.shape[1:3]
        diff = (got != ref[:, start:start + b, col:col + t]).any(-1)
        flips += diff.reshape(FLAGSHIP_STEPS, per, -1).sum(axis=(1, 2))
    return flips.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("layers,dtype,rtol,flip_rtol,max_flips", [
    (8, "bfloat16", RTOL_MOE_BF16, RTOL_MOE_BF16, None),
    (2, "float32", RTOL_FLAGSHIP_F32, RTOL_MOE_F32_FLIP, MOE_F32_MAX_FLIPS)],
    ids=["L8_bf16", "L2_f32"])
@pytest.mark.parametrize("axes", [
    {"fsdp": 4}, {"fsdp": 2, "tp": 2}, {"fsdp": 2, "sp": 2}],
    ids=["fsdp4_ep4", "fsdp2_tp2", "fsdp2_sp2_ulysses"])
def test_moe_flagship_sharded_matches_one_card(axes, layers, dtype, rtol,
                                               flip_rtol, max_flips,
                                               one_card, tmp_path):
    """The MoE flagship (4 experts in the odd layers, top-2, capacity
    1.5) at global batch 8 x 2048, 5 steps from one set of weights, on 4
    GPUs: at fsdp 4 each rank holds one expert and the tokens move to it
    by all-to-all (ep 4); at fsdp 2 x tp 2 two experts a rank, each
    split over tp; at fsdp 2 x sp 2 (Ulysses) two experts a rank, the
    sp ranks' capacity buffers summed and split between them.  Losses and grad norms within rtol of the one-card
    step's while every token takes the experts it takes on one card, and
    within flip_rtol from the first step in which one does not (both
    sides' routes are recorded and compared), with at most max_flips
    such tokens a step (f32); each rank launches every flash kernel once
    a layer a step, and each GPU holds its fsdp x tp share of the state
    plus the norms."""
    _gpus(4)
    ref = one_card(layers, dtype, flags=MOE_FLAGS)
    routes = str(tmp_path / "routes")
    flags = dict(MOE_FLAGS, use_ulysses_attention=True) if "sp" in axes \
        else MOE_FLAGS
    got = _flagship(axes, layers, dtype, flags, routes=routes)
    flips = _route_flips(routes, ref["routes"])
    replicated = 3 * 4 * _moe_params(layers)
    norms = 3 * 4 * (2 * layers + 1) * 2048
    shards = axes.get("fsdp", 1) * axes.get("tp", 1)
    bound = replicated / shards + norms + MEMORY_MARGIN * replicated
    print(json.dumps({"axes": axes, "layers": layers, "dtype": dtype,
                      "moe": got, "one_card": ref, "route_flips": flips,
                      "replicated_state": replicated,
                      "memory_bound": bound}))
    if max_flips is not None:
        assert max(flips) <= max_flips, flips
    first = next((i for i, n in enumerate(flips) if n), len(flips))
    for name in ("losses", "norms"):
        for i, (a, b) in enumerate(zip(got[name], ref[name])):
            tol = (rtol if i < first else flip_rtol)[name]
            assert abs(a - b) <= tol * abs(b), (name, i, a, b, flips)
    assert got["launches"] == [layers * FLAGSHIP_STEPS] * 3
    assert got["memory_after_init"] <= bound


RANK_PP = r"""
import importlib, json, sys, time
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, pipeline
from volcano_tpu_torch.workloads import model as tm, train as tt
fa = importlib.import_module("volcano_tpu_torch.workloads.ops.flash_attention")
stages, slices, layers, dtype, batch, seq, steps, micro = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
    getattr(torch, sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]),
    int(sys.argv[7]), int(sys.argv[8]))
bootstrap.initialize(device="cuda")
n = dist.get_world_size()
if slices:
    mesh = pipeline.make_pp_mesh_over_slices(
        stages, device_type="cuda",
        slice_ids=[r * slices // n for r in range(n)])
else:
    mesh = pipeline.make_pp_mesh(stages, device_type="cuda")
cfg = tm.flagship_config(n_layers=layers, dtype=dtype)
gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
outer, blocks = pipeline.distribute_stages(
    *pipeline.stack_stage_params(tm.init_params(cfg, gen(5), "cuda"), stages),
    mesh)
opt = tt.make_optimizer()
state = opt.init(pipeline.joined(outer, blocks))
torch.cuda.synchronize()
torch.cuda.empty_cache()
after_init = torch.cuda.memory_allocated()
data = tt.synthetic_batch(gen(6), cfg, batch, seq)
step = pipeline.make_pipelined_train_step(cfg, mesh, opt, micro)
torch.cuda.reset_peak_memory_stats()
fa.flash_fwd.launches = 0
fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
losses, norms, ms = [], [], []
for _ in range(steps):
    t0 = time.monotonic()
    outer, blocks, state, m = step(outer, blocks, state, data)
    losses.append(m["loss"].item()); norms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    ms.append((time.monotonic() - t0) * 1e3)
out = {"rank": dist.get_rank(), "coord": mesh.get_coordinate(),
       "losses": losses, "norms": norms, "step_ms": ms,
       "launches": [fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
                    fa.flash_bwd.launches_dkv],
       "memory_after_init": after_init,
       "peak_memory": torch.cuda.max_memory_allocated()}
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.mark.gpu
@pytest.mark.parametrize("layers,dtype,rtol", [
    (8, "bfloat16", RTOL_PP_BF16), (4, "float32", RTOL_FLAGSHIP_F32)],
    ids=["L8_bf16", "L4_f32"])
@pytest.mark.parametrize("stages,slices", [(4, 0), (2, 2)],
                         ids=["pp4", "pp2_over_slices"])
def test_flagship_pp_matches_one_card(stages, slices, layers, dtype, rtol,
                                      one_card):
    """The flagship pipelined over 4 GPUs, global batch 8 x 2048 in 4
    microbatches, 5 steps from the one-card step's weights and batch: a
    stage a GPU (pp 4), or a stage per slice of 2 GPUs (pp 2, the ranks
    of a stage agreeing bit for bit).  f32 at 4 layers, since pp 4 needs
    a layer count that divides over the stages.  Losses and grad norms
    within rtol of the one-card step's; each rank launches every kernel
    once a layer of its stage a microbatch a step."""
    _gpus(4)
    port = free_port()
    outs = _run(
        [[sys.executable, "-c", RANK_PP, str(stages), str(slices),
          str(layers), dtype, str(FLAGSHIP_BATCH), str(FLAGSHIP_SEQ),
          str(FLAGSHIP_STEPS), str(PP_MICROBATCHES)]] * 4,
        [_base_env(TPU_WORKER_ID=r, NUM_PROCESSES=4, LOCAL_RANK=r,
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
         for r in range(4)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    ranks = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]
    ref = one_card(layers, dtype)
    print(json.dumps({"stages": stages, "slices": slices, "layers": layers,
                      "dtype": dtype, "pp": ranks, "one_card": ref}))
    for res in ranks:
        for name in ("losses", "norms"):
            torch.testing.assert_close(torch.tensor(res[name]),
                                       torch.tensor(ref[name]),
                                       rtol=rtol[name], atol=0)
        assert res["losses"] == ranks[0]["losses"]
        assert res["launches"] == [layers // stages * PP_MICROBATCHES
                                   * FLAGSHIP_STEPS] * 3


@pytest.mark.gpu
def test_dryrun_multichip_on_nccl():
    """The one-step matrix (`entry.dryrun_multichip`) on 4 GPUs over
    nccl: every family of a 4-device run steps once, with finite
    losses."""
    _gpus(4)
    from volcano_tpu_torch import entry
    t0 = time.monotonic()
    results = entry.dryrun_multichip(4, "cuda")
    print(json.dumps({"dryrun_multichip": results,
                      "wall_s": time.monotonic() - t0}))
    assert list(results) == ["dp1-fsdp1-tp4", "ring-sp4-long", "ulysses-sp4",
                             "moe-ep2", "gpipe-pp4", "gpipe-pp2-slices"]
    assert all(v == v and v > 0 for v in results.values())


# -- the flash kernels at the shapes they gained ---------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,block", [
    ((1, 256, 2, 384), torch.bfloat16, None),
    ((1, 192, 2, 128), torch.bfloat16, "64"),
    ((1, 256, 2, 512), torch.bfloat16, None),
    ((1, 197, 2, 128), torch.bfloat16, "197"),
    ((1, 96, 2, 384), torch.float32, "32")],
    ids=["d384", "t192_block64", "d512", "t197", "d384_t96_f32"])
def test_uncovered_shapes_on_cuda_raise(shape, dtype, block, monkeypatch):
    """Shapes that supported() admits beyond d in {128, 256} and
    t % 128 == 0 no longer raise on the card: `flash_attention` launches
    the forward, dQ and dK/dV kernels once each (the launch counts), and
    its output and gradients equal the plain versions' on the same
    inputs (bf16 within TOL_BF16, f32 within 1e-4)."""
    _gpus(1)
    fa = importlib.import_module(
        "volcano_tpu_torch.workloads.ops.flash_attention")
    if block:
        monkeypatch.setenv("FLASH_BLOCK", block)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
              fa.flash_bwd.launches_dkv)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches_dq,
            fa.flash_bwd.launches_dkv) == tuple(n + 1 for n in before)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True)
    ref_grads = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, True)
    tol = TOL_BF16 if dtype == torch.bfloat16 else 1e-4
    rtol = TOL_BF16 if dtype == torch.bfloat16 else 0.0
    for got, want in zip((out, *grads), (ref_out, *ref_grads)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=rtol)

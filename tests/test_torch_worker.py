"""The port's scheduled-worker path (volcano_tpu_torch.workloads:
bootstrap, progress, mesh, the data-parallel train step and the worker)
against the JAX package's, on the CPU.

The JAX side runs on the conftest's virtual CPU devices; the port side
as 2-process gloo groups (WORKER_DEVICE=cpu, one rank a process).
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from volcano_tpu.api.pod import Container, Pod
from volcano_tpu.api.resource import TPU
from volcano_tpu.api.types import JobPhase
from volcano_tpu.api.vcjob import TaskSpec, VCJob
from volcano_tpu.controllers import ControllerManager
from volcano_tpu.scheduler import Scheduler
from volcano_tpu.simulator import make_tpu_cluster
from volcano_tpu.webhooks import default_admission
from volcano_tpu.workloads import bootstrap as jboot
from volcano_tpu.workloads import mesh as jmesh
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import progress as jprogress
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch.workloads import bootstrap as tboot
from volcano_tpu_torch.workloads import convert
from volcano_tpu_torch.workloads import mesh as tmesh
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import progress as tprogress
from volcano_tpu_torch.workloads import train as tt
from volcano_tpu_torch.workloads import worker as tworker
from torch_procs import AGENT_STORE_ENV, rendezvous

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every subprocess gets this long to finish; its process group's own
# timeout (RANK_TIMEOUT_S) is shorter, so a lost peer raises first
PROC_TIMEOUT_S = 150
RANK_TIMEOUT_S = 60
# loss, grad norm and the all-reduced gradients of the 2-rank port step
# against JAX's: f32 through 2 layers on two libraries, sum order only;
# each gradient leaf and each param leaf of a state carried over from
# JAX is held to 1e-5 of its largest value
SHARE = 1e-5
# params after steps from the same start: Adam divides each gradient by
# its own size, so an element whose gradient is near 0 turns the sum-order
# difference into a visible share of its step (seen: 10 of 16384 embed
# elements off by 0.7% of a step).  As tests/test_torch_train.py holds
# them: every element within a quarter of a step, 99.9% of each leaf
# within 1e-2 of a step and its mean within 2e-4, beside f32 rounding
PARAM_STEP_MAX = 0.25
PARAM_STEP_Q999 = 1e-2
PARAM_STEP_MEAN = 2e-4
RTOL_PARAM = 1e-6
# the worker prints its loss rounded to 4 digits
PRINTED = 5e-5


def rank_env(rank, world, port, **extra):
    """A rank process's env, meeting its group at the store `port` of a
    `rendezvous()` block."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               TPU_WORKER_ID=str(rank), NUM_PROCESSES=str(world),
               COORDINATOR_ADDRESS=f"127.0.0.1:{port}", **AGENT_STORE_ENV)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def pod_env(pod, port):
    """A worker process's env: the pod's injected contract, with the
    coordinator's host rewritten to this machine (a stand-in for the
    cluster DNS of the svc plugin's hostnames)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.update(pod.containers[0].env)
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", WORKER_STEPS="2",
               WORKER_DEVICE="cpu", **AGENT_STORE_ENV)
    return env


def run_procs(argvs, envs):
    """Start one process per (argv, env), wait for all; returns
    [(returncode, stdout, stderr)].  Kills them all on timeout."""
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


def _flat(tree):
    out = [(k, tree[k]) for k in tree if k != "blocks"]
    for i, blk in enumerate(tree.get("blocks", ())):
        out += [(f"blocks.{i}.{k}", blk[k]) for k in blk]
    return out


def _assert_stepped_params(got, want, lr):
    """got[name] against want[name] (numpy), by the Adam-step rule."""
    for name, y in want.items():
        diff = np.abs(np.asarray(got[name], np.float32) - y)
        slack = RTOL_PARAM * np.abs(y)
        assert np.all(diff <= PARAM_STEP_MAX * lr + slack), \
            (name, float(diff.max()))
        over = diff - slack
        assert np.quantile(over, 0.999) <= PARAM_STEP_Q999 * lr, name
        assert over.mean() <= PARAM_STEP_MEAN * lr, name


# -- bootstrap ---------------------------------------------------------

ENVS = [
    {},
    {"TPU_WORKER_ID": "3", "NUM_PROCESSES": "4",
     "COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"TPU_WORKER_ID": "1",
     "TPU_WORKER_HOSTNAMES": "w0.job.ns.svc,w1.job.ns.svc,,w2.job.ns.svc"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "NUM_PROCESSES": "8"},
    {"VTP_CHECKPOINT_DIR": "/ckpt/j", "VTP_RESUME_STEP": "42"},
    {"VTP_RESUME_STEP": "junk"},
    {"VTP_RESUME_STEP": ""},
    {"VTP_EPOCH": "7", "VTP_PROGRESS_FILE": "/p/vtp-uid.json"},
    {"VTP_EPOCH": "junk"},
    {"VTP_EPOCH": ""},
    {"TPU_WORKER_ID": "2", "TPU_SLICE_ID": "1", "TPU_NUM_SLICES": "2",
     "NUM_PROCESSES": "4", "TPU_WORKER_HOSTNAMES": "a,b,c,d"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_from_env_matches_reference(env):
    assert tboot.from_env(env).__dict__ == jboot.from_env(env).__dict__
    got, ref = tboot.from_env(env), jboot.from_env(env)
    assert (got.is_distributed, got.is_multislice) == \
        (ref.is_distributed, ref.is_multislice)


def test_bootstrap_constants_match_reference():
    names = [n for n in dir(jboot) if n.startswith(("ENV_", "DEFAULT_"))]
    for name in names:
        assert getattr(tboot, name) == getattr(jboot, name), name


def test_initialize_raises_when_a_group_exists_or_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tboot.initialize({})
    assert not dist.is_initialized()
    tboot.initialize({}, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="already exists"):
            tboot.initialize({}, device="cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_needs_a_coordinator_for_several_processes():
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        tboot.initialize({"NUM_PROCESSES": "2"}, device="cpu")
    assert not dist.is_initialized()


# -- progress ----------------------------------------------------------

@pytest.mark.parametrize("env", [
    {"VTP_PROGRESS_FILE": "sub/vtp-a.json", "VTP_EPOCH": "3"},
    {"VTP_PROGRESS_FILE": "vtp-b.json", "VTP_EPOCH": "junk"},
    {"VTP_PROGRESS_FILE": "vtp-c.json"}])
def test_progress_records_match_reference(env, tmp_path):
    env = dict(env, VTP_PROGRESS_FILE=str(tmp_path / env["VTP_PROGRESS_FILE"]))
    records = []
    for mod, name in ((jprogress, "ref"), (tprogress, "port")):
        env_i = dict(env, VTP_PROGRESS_FILE=env["VTP_PROGRESS_FILE"] + name)
        rep = mod.ProgressReporter.from_env(env_i)
        rep._now = lambda: 1754300000.1234567
        assert rep.report(step=1042, examples=266752) is True
        with open(env_i["VTP_PROGRESS_FILE"]) as f:
            records.append(json.load(f))
        # the atomic write leaves no tmp file behind
        folder = os.path.dirname(env_i["VTP_PROGRESS_FILE"])
        assert not any(".tmp." in p for p in os.listdir(folder))
    assert records[0] == records[1]
    assert set(records[1]) == {"step", "examples", "ts", "epoch"}


def test_progress_unwritable_path_returns_false(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    path = str(blocker / "vtp-x.json")       # a directory under a file
    for mod in (jprogress, tprogress):
        assert mod.ProgressReporter(path).report(step=1) is False
    assert tprogress.ProgressReporter.from_env({}) is None


# -- mesh --------------------------------------------------------------

def test_choose_axis_sizes_matches_reference():
    for n in range(1, 65):
        assert tmesh.choose_axis_sizes(n) == jmesh.choose_axis_sizes(n), n
        for forced in (dict(tp=1), dict(tp=2, sp=1), dict(fsdp=n),
                       dict(tp=1, sp=1, fsdp=1), dict(sp=3), dict(tp=8)):
            assert tmesh.choose_axis_sizes(n, **forced) == \
                jmesh.choose_axis_sizes(n, **forced), (n, forced)
    assert tmesh.AXES == jmesh.AXES and tmesh.HYBRID_AXES == jmesh.HYBRID_AXES


def _ref_groups(n, num_slices, slice_ids=None):
    """The reference's group_by_slice on stand-in devices, one a
    process, as ids."""
    devs = [types.SimpleNamespace(
        id=i, slice_index=None if slice_ids is None else slice_ids[i],
        process_index=i) for i in range(n)]
    return [[d.id for d in g] for g in jmesh.group_by_slice(devs, num_slices)]


@pytest.mark.parametrize("n,num_slices,slice_ids", [
    (4, 2, [1, 0, 1, 0]),          # by slice id
    (4, 2, [0, 0, 0, 1]),          # unequal slices: sequential chunks
    (4, 2, [0, 1, 2, 3]),          # too many ids: sequential chunks
    (2, 2, [0, 0]),                # one id: one rank a process wins
    (6, 3, None),                  # no ids: sequential chunks
    (3, 3, None),                  # one rank a process
])
def test_group_by_slice_matches_reference(n, num_slices, slice_ids):
    assert tmesh.group_by_slice(range(n), num_slices, slice_ids) == \
        _ref_groups(n, num_slices, slice_ids)


def test_group_by_slice_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.group_by_slice(range(5), 2)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.group_by_slice(range(5), 2, [0, 0, 1, 1, 1])


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="bootstrap.initialize"):
        tmesh.make_mesh({"dp": 1}, "cpu")


def test_one_rank_mesh_paths():
    """A one-rank gloo group: mesh sizes are checked, the batch spec is
    all rows, and the data group is the flattened (dp, fsdp) sub-mesh."""
    tboot.initialize({}, device="cpu", timeout=RANK_TIMEOUT_S)
    try:
        with pytest.raises(ValueError, match="!= 1 devices"):
            tmesh.make_mesh({"dp": 2}, "cpu")
        mesh = tmesh.make_mesh({"dp": 1}, "cpu")
        assert mesh.mesh_dim_names == tmesh.AXES
        assert tt.data_axes(mesh) == ("dp", "fsdp")
        assert tt.batch_sharding(mesh) == tt.BatchShard(0, 1)
        assert tt.data_mesh(mesh).mesh_dim_names == (tt.DATA_MESH,)
        assert tt.data_mesh(mesh) is tt.data_mesh(mesh)
        hybrid = tmesh.make_hybrid_mesh({"dcn": 1}, "cpu", slice_id=0)
        assert hybrid.mesh_dim_names == tmesh.HYBRID_AXES
        assert tt.data_axes(hybrid) == ("dcn", "dp", "fsdp")
        cfg = tm.tiny_config()
        opt = tt.make_optimizer()
        params, state, placements = tt.init_sharded(
            torch.Generator().manual_seed(0), cfg, mesh, opt)
        ref = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert all(torch.equal(tt.local(a), b) for a, b in zip(
            tt.leaves(params), tt.leaves(ref)))
        assert state["count"] == 0
        # the reference's layout on a one-rank mesh: every dim whole
        assert placements == tm.param_shardings(ref, mesh)
        assert all(len(p) == 4 for p in tt.leaves(placements))
        assert [p.placements for p in tt.leaves(params)] == \
            list(tt.leaves(placements))
        batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg,
                                   3, 16, mesh)
        whole = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg,
                                   3, 16)
        assert torch.equal(batch["tokens"], whole["tokens"])
    finally:
        dist.destroy_process_group()


class _StubMesh:
    """What the train step reads of a mesh: its axis names and sizes."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tmesh.AXES
        self.shape = tuple(sizes.get(a, 1) for a in tmesh.AXES)
        self.ndim = len(self.shape)


@pytest.mark.parametrize("sizes", [dict(fsdp=2, sp=2), dict(sp=2),
                                   dict(dp=2, tp=2, sp=2)])
def test_tp_and_sp_raise_not_implemented(sizes):
    """sp > 1 no longer raises (tp and sp are ported:
    tests/test_torch_sharded.py, tests/test_torch_sp.py): the last rank's
    batch spec holds the last rows over the data axes and the last block
    of the sequence over sp, as the reference's P(data_axes, "sp")."""
    mesh = _StubMesh(**sizes)
    mesh.get_coordinate = lambda: [n - 1 for n in mesh.shape]
    data = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    shard = tt.batch_sharding(mesh)
    assert shard == tt.BatchShard(data - 1, data, sizes["sp"] - 1,
                                  sizes["sp"])
    assert shard.rows(4 * data) == slice(4 * data - 4, 4 * data)
    assert shard.cols(32) == slice(32 - 32 // sizes["sp"], 32)
    with pytest.raises(ValueError, match="does not divide"):
        shard.cols(3)


def test_batch_shard_rows():
    assert [tt.BatchShard(i, 4).rows(8) for i in range(4)] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not divide"):
        tt.BatchShard(0, 2).rows(3)


# -- the data-parallel train step over 2 ranks -------------------------

RANK_TRAIN = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, convert, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
src, dst, axes, timeout = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), float(sys.argv[4])
info = bootstrap.initialize(device="cpu", timeout=timeout)
mesh = (mesh_lib.make_hybrid_mesh(axes, "cpu", slice_id=info.slice_id)
        if "dcn" in axes else mesh_lib.make_mesh(axes, "cpu"))
data = dict(np.load(src))
tree = {k: data[k] for k in ("embed", "final_norm", "head")}
n_layers = 1 + max(int(k.split(".")[1]) for k in data if k.startswith("blocks."))
tree["blocks"] = [{k.split(".")[2]: v for k, v in data.items()
                   if k.startswith(f"blocks.{i}.")} for i in range(n_layers)]
params = convert.params_from_jax(tree, device="cpu", mesh=mesh)
tokens = torch.from_numpy(data["tokens"]).long()
tokens = tokens[tt.batch_sharding(mesh).rows(len(tokens))]
cfg = tm.tiny_config()
opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
state = opt.init(params)
step = tt.make_train_step(cfg, opt, mesh)
_, grads = tt.value_and_grad(params, {"tokens": tokens}, cfg, mesh)
losses, norms = [], []
for _ in range(3):
    params, state, m = step(params, state, {"tokens": tokens})
    losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
out = {"losses": np.array(losses), "norms": np.array(norms),
       "rows": np.array([tokens.shape[0]])}
out.update((k, x.full_tensor().numpy()) for k, x in tt.named_leaves(params))
out.update((k, x.full_tensor().numpy())
           for k, x in tt.named_leaves(grads, "grad."))
np.savez(dst, **out)
dist.destroy_process_group()
"""


def _jax_three_steps(axes):
    devices = jax.devices()[:2]
    if "dcn" in axes:
        mesh = jmesh.make_hybrid_mesh(axes, devices=devices)
    else:
        mesh = jmesh.make_mesh(axes, devices=devices)
    cfg = jm.tiny_config()
    opt = jt.make_optimizer(lr=1e-2, warmup_steps=1)
    params, state, _ = jt.init_sharded(jax.random.key(0), cfg, mesh, opt)
    init = jax.tree.map(np.asarray, params)
    batch = jt.synthetic_batch(jax.random.key(1), cfg, 4, 32, mesh)
    step = jt.make_train_step(cfg, mesh, opt)
    losses, norms = [], []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    # the reference's gradient: of the mean loss over the global batch
    grads = jax.grad(jm.loss_fn)(jax.tree.map(jnp.asarray, init),
                                 {"tokens": batch["tokens"]}, cfg)
    return (init, np.asarray(batch["tokens"]), losses, norms,
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 2}, {"dcn": 2}],
                         ids=["dp2", "fsdp2", "dcn2"])
def test_two_rank_train_step_matches_jax_mesh(axes, tmp_path):
    """3 steps of the tiny f32 config, lr 1e-2, warmup 1, global batch
    4 x 32: JAX's make_train_step on a 2-device mesh against the port's
    on 2 gloo ranks, each holding 2 rows.  Both ranks report the global
    loss, reduce their gradients to the global batch's and end with the
    same params."""
    init, tokens, losses, norms, final, grads = _jax_three_steps(axes)
    src = tmp_path / "init.npz"
    np.savez(src, tokens=tokens, **dict(_flat(init)))
    extra = [dict(TPU_SLICE_ID=r) for r in range(2)] if "dcn" in axes \
        else [{}, {}]
    with rendezvous() as port:
        outs = run_procs(
            [[sys.executable, "-c", RANK_TRAIN, str(src),
              str(tmp_path / f"rank{r}.npz"), json.dumps(axes),
              str(RANK_TIMEOUT_S)] for r in range(2)],
            [rank_env(r, 2, port, **extra[r]) for r in range(2)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    want = dict(_flat(final))
    for res in ranks:
        assert int(res["rows"][0]) == 2
        np.testing.assert_allclose(res["losses"], losses, rtol=SHARE)
        np.testing.assert_allclose(res["norms"], norms, rtol=SHARE)
        for name, ref in _flat(grads):
            np.testing.assert_allclose(
                res[f"grad.{name}"], ref, rtol=0,
                atol=SHARE * np.abs(ref).max(), err_msg=name)
        _assert_stepped_params(res, want, lr=1e-2)
    # the ranks apply one update to one state: bit-identical
    for name in want:
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
    assert np.array_equal(ranks[0]["losses"], ranks[1]["losses"])


def test_opt_state_from_jax_continues_the_reference():
    """JAX's state after 2 steps, carried into the port and continued one
    step, equals JAX's step 3 within SHARE of each leaf's largest."""
    jcfg = jm.tiny_config()
    jopt = jt.make_optimizer(lr=1e-2, warmup_steps=1)
    params = jm.init_params(jax.random.key(0), jcfg)
    state = jopt.init(params)
    toks = np.random.default_rng(1).integers(0, 256, (4, 32)) \
        .astype(np.int32)
    jstep = jax.jit(lambda p, s, b: jt.train_step(p, s, b, jcfg, jopt))
    batch = {"tokens": jnp.asarray(toks)}
    for _ in range(2):
        params, state, _ = jstep(params, state, batch)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, state),
                                        device="cpu")
    assert tstate["count"] == 2
    assert all(x.dtype == torch.float32 for x in tt.leaves(tstate["mu"]))
    params, state, m = jstep(params, state, batch)
    topt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
    tparams, tstate, tm_ = tt.train_step(
        tparams, tstate, {"tokens": torch.from_numpy(toks).long()},
        tm.tiny_config(), topt)
    np.testing.assert_allclose(float(tm_["loss"]), float(m["loss"]),
                               rtol=SHARE)
    for (name, x), (_, y) in zip(_flat(tparams),
                                 _flat(jax.tree.map(np.asarray, params))):
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=SHARE * np.abs(y).max(),
                                   err_msg=name)
    assert tstate["count"] == 3


def test_opt_state_from_jax_keeps_bf16_mu():
    jopt = jt.make_optimizer(mu_dtype=jnp.bfloat16)
    params = jm.init_params(jax.random.key(0), jm.tiny_config())
    state = jax.tree.map(np.asarray, jopt.init(params))
    tstate = convert.opt_state_from_jax(state, device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in tt.leaves(tstate["mu"]))
    assert all(x.dtype == torch.float32 for x in tt.leaves(tstate["nu"]))
    assert tstate["count"] == 0


# -- the worker, as the scheduler launches it --------------------------

def test_worker_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tworker.run({"TPU_WORKER_ID": "0", "NUM_PROCESSES": "1"})
    assert not dist.is_initialized()


def _one_process_loss(global_batch, steps):
    """The worker's loss computed in this process, on the whole global
    batch, without a mesh."""
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


def _launch_workers(pods):
    with rendezvous() as port:
        outs = run_procs([[sys.executable, "-m",
                           "volcano_tpu_torch.workloads.worker"]] * len(pods),
                         [pod_env(pod, port) for pod in pods])
    results = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-2000:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def _schedule(cluster, job):
    cluster.admission = default_admission()
    mgr = ControllerManager(cluster, enabled=["job", "queue"])
    sched = Scheduler(cluster, schedule_period=0)
    job = cluster.add_vcjob(job)
    for _ in range(3):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    job = cluster.vcjobs[job.key]
    assert job.phase is JobPhase.RUNNING
    return job


def test_scheduled_pods_launch_port_workers():
    """The counterpart of test_workload_e2e's flat case: a vcjob is bound
    by the scheduler and each pod's injected env launches the port's
    worker; the ranks' loss is global and equals one process's step on
    the whole global batch."""
    cluster = make_tpu_cluster([("sa", "v5e-16")])
    job = _schedule(cluster, VCJob(
        name="mesh", min_available=2,
        tasks=[TaskSpec(name="worker", replicas=2,
                        template=Pod(name="t", containers=[
                            Container(requests={"cpu": 4, TPU: 4})]))],
        plugins={"jax": [], "svc": []},
    ))
    workers = sorted((p for p in cluster.pods.values()
                      if p.owner == job.uid),
                     key=lambda p: p.task_index)
    assert len(workers) == 2 and all(p.node_name for p in workers)
    results = _launch_workers(workers)
    for rank, res in enumerate(results):
        assert set(res) == {"process_id", "num_processes", "device_count",
                            "collective_sum", "loss", "start_step",
                            "slice_id", "num_slices"}
        assert res["process_id"] == rank
        assert res["num_processes"] == 2
        assert res["device_count"] == 2
        assert res["collective_sum"] == 2.0
        assert res["loss"] == res["loss"] and res["loss"] > 0
        assert res["start_step"] == 0
    assert results[0]["loss"] == results[1]["loss"], \
        "ranks disagree on the globally-reduced loss"
    assert abs(results[0]["loss"] - _one_process_loss(2, 2)) <= \
        PRINTED + SHARE


def test_multislice_job_trains_port_workers_across_dcn():
    """The counterpart of test_workload_e2e's multislice case: two
    subgrouped tasks on two DCN-separated slices; each worker builds the
    hybrid mesh from TPU_SLICE_ID/TPU_NUM_SLICES and reduces its
    gradients across the dcn axis."""
    cluster = make_tpu_cluster([("sa", "v5e-4"), ("sb", "v5e-4")],
                               dcn_pods={"sa": "pod-a", "sb": "pod-b"})
    job = _schedule(cluster, VCJob(
        name="multislice", min_available=2,
        tasks=[TaskSpec(name="slice-a", replicas=1, subgroup="slice-a",
                        template=Pod(name="t", containers=[
                            Container(requests={"cpu": 4, TPU: 4})])),
               TaskSpec(name="slice-b", replicas=1, subgroup="slice-b",
                        template=Pod(name="t", containers=[
                            Container(requests={"cpu": 4, TPU: 4})]))],
        plugins={"jax": [], "svc": []},
    ))
    workers = sorted((p for p in cluster.pods.values()
                      if p.owner == job.uid),
                     key=lambda p: p.task_spec)
    assert len(workers) == 2 and all(p.node_name for p in workers)
    assert {p.node_name.split("-w")[0] for p in workers} == {"sa", "sb"}
    results = _launch_workers(workers)
    for rank, res in enumerate(results):
        assert res["process_id"] == rank
        assert res["num_processes"] == 2
        assert res["num_slices"] == 2
        assert res["slice_id"] == rank
        assert res["collective_sum"] == 2.0
        assert res["loss"] == res["loss"] and res["loss"] > 0
    assert results[0]["loss"] == results[1]["loss"], \
        "slices disagree on the dcn-reduced loss"
    assert abs(results[0]["loss"] - _one_process_loss(2, 2)) <= \
        PRINTED + SHARE


@pytest.mark.parametrize("slices", [1, 2], ids=["flat_dp4", "dcn2_fsdp2"])
def test_four_rank_workers_match_one_process(slices):
    """Four gloo ranks with a global batch of 4: the flat mesh (dp 4) and
    the hybrid one (2 slices of fsdp 2, ranks grouped by TPU_SLICE_ID)
    both report the loss of one process on the whole batch."""
    extra = dict(WORKER_DEVICE="cpu", WORKER_GLOBAL_BATCH=4, WORKER_STEPS=2)
    if slices > 1:
        extra.update(TPU_NUM_SLICES=slices)
    with rendezvous() as port:
        outs = run_procs(
            [[sys.executable, "-m", "volcano_tpu_torch.workloads.worker"]] * 4,
            [rank_env(r, 4, port, **extra, **(
                {"TPU_SLICE_ID": r * slices // 4} if slices > 1 else {}))
             for r in range(4)])
    results = []
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["collective_sum"] for r in results] == [4.0] * 4
    assert [r["slice_id"] for r in results] == \
        [r * slices // 4 if slices > 1 else 0 for r in range(4)]
    assert len({r["loss"] for r in results}) == 1
    assert abs(results[0]["loss"] - _one_process_loss(4, 2)) <= \
        PRINTED + SHARE

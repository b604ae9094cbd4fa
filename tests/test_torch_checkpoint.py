"""The port's checkpoint/resume (volcano_tpu_torch.workloads.checkpoint,
on torch.distributed.checkpoint) and the worker's resume, on the CPU:
the counterparts of tests/test_checkpoint.py and of the resume cases in
tests/test_failover.py, with the reference's resume contract run on
both sides."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from volcano_tpu.workloads import checkpoint as jckpt
from volcano_tpu_torch.workloads import checkpoint
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt
from volcano_tpu_torch.workloads import worker as tworker
from torch_procs import AGENT_STORE_ENV, rendezvous

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 150    # a subprocess's limit; its group's is shorter
RANK_TIMEOUT_S = 60


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


def base_env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _state(seed=0, mu_dtype=None, steps=1):
    """Tiny f32 params and AdamW state after `steps` steps."""
    cfg = tm.tiny_config()
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1, mu_dtype=mu_dtype)
    params = tm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    state = opt.init(params)
    batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4, 32)
    step = tt.make_train_step(cfg, opt)
    for _ in range(steps):
        params, state, _ = step(params, state, batch)
    return params, state, step, batch


def _assert_equal_state(a_params, a_state, b_params, b_state):
    for (name, x), (_, y) in zip(tt.named_leaves(a_params),
                                 tt.named_leaves(b_params)):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    for key in ("mu", "nu"):
        for (name, x), (_, y) in zip(tt.named_leaves(a_state[key]),
                                     tt.named_leaves(b_state[key])):
            assert x.dtype == y.dtype and torch.equal(x, y), (key, name)
    assert a_state["count"] == b_state["count"]
    assert isinstance(b_state["count"], int)


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16],
                         ids=["f32_mu", "bf16_mu"])
def test_checkpoint_roundtrip(tmp_path, mu_dtype):
    params, state, step, batch = _state(mu_dtype=mu_dtype)
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, step=1, params=params, opt_state=state)
    assert checkpoint.latest_step(ckpt) == 1
    assert sorted(os.listdir(ckpt)) == ["1"]     # no tmp dir left over

    # a "restarted worker": fresh init, then restore into it
    p2, s2, _, _ = _state(seed=42, mu_dtype=mu_dtype, steps=0)
    like = [id(x) for x in tt.leaves(p2)]
    p2, s2, got = checkpoint.restore(ckpt, p2, s2)
    assert got == 1
    assert [id(x) for x in tt.leaves(p2)] == like      # loaded in place
    _assert_equal_state(params, state, p2, s2)

    # training continues bit-identically from the restore
    _, _, m1 = step(params, state, batch)
    _, _, m2 = step(p2, s2, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_latest_step_missing_dir_is_none_and_not_created(tmp_path):
    missing = tmp_path / "missing"
    assert checkpoint.latest_step(str(missing)) is None
    assert jckpt.latest_step(str(missing)) is None
    assert not missing.exists()
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(missing), {}, {})
    assert not missing.exists()


def test_latest_step_ignores_tmp_dirs(tmp_path):
    params, state, _, _ = _state()
    ckpt = tmp_path / "ckpt"
    checkpoint.save(str(ckpt), step=2, params=params, opt_state=state)
    (ckpt / "9.tmp").mkdir()           # a save that died mid-write
    (ckpt / "7").write_text("")        # not a checkpoint directory
    assert checkpoint.latest_step(str(ckpt)) == 2
    with pytest.raises(FileExistsError):
        checkpoint.save(str(ckpt), step=2, params=params, opt_state=state)


@pytest.mark.parametrize("case", ["fresh", "stamped_missing", "lost_data"])
def test_resume_state_contract_matches_reference(tmp_path, case):
    """The three outcomes of the reference's resume_state, on both
    sides: no stamp and no checkpoint is a fresh start at step 0; a
    stamped step with no checkpoint is FileNotFoundError; a latest
    checkpoint older than the stamp is RuntimeError (lost data)."""
    params, state, _, _ = _state()
    ckpt = str(tmp_path / "ckpt")
    if case == "fresh":
        for mod in (jckpt, checkpoint):
            assert mod.resume_state("params", "opt", environ={}) == \
                ("params", "opt", 0)
        assert checkpoint.resume_state(
            params, state, directory=ckpt, environ={})[2] == 0
        return
    env = {"VTP_CHECKPOINT_DIR": ckpt, "VTP_RESUME_STEP": "5"}
    if case == "stamped_missing":
        for mod in (jckpt, checkpoint):
            with pytest.raises(FileNotFoundError, match="stamped"):
                mod.resume_state("params", "opt", environ=env)
        return
    checkpoint.save(ckpt, step=3, params=params, opt_state=state)
    with pytest.raises(RuntimeError, match="lost data"):
        checkpoint.resume_state(params, state, environ=env)


def test_resume_state_prefers_a_newer_checkpoint(tmp_path):
    """The stamp is a floor: a checkpoint newer than it is restored."""
    params, state, _, _ = _state()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, step=7, params=params, opt_state=state)
    p2, s2, _, _ = _state(seed=9, steps=0)
    _, _, start = checkpoint.resume_state(
        p2, s2, environ={"VTP_CHECKPOINT_DIR": ckpt, "VTP_RESUME_STEP": "5"})
    assert start == 7
    _assert_equal_state(params, state, p2, s2)


def test_close_all_idempotent_under_double_shutdown(tmp_path):
    params, state, _, _ = _state()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, step=1, params=params, opt_state=state)
    checkpoint.close_all()
    checkpoint.close_all()             # double shutdown: no raise
    assert checkpoint.latest_step(ckpt) == 1
    checkpoint.save(ckpt, step=2, params=params, opt_state=state)
    assert checkpoint.latest_step(ckpt) == 2
    checkpoint.close_all()


def test_max_to_keep(tmp_path):
    params, state, _, _ = _state()
    ckpt = str(tmp_path / "ckpt")
    for step in range(1, 6):
        checkpoint.save(ckpt, step=step, params=params, opt_state=state,
                        max_to_keep=2)
    assert sorted(os.listdir(ckpt)) == ["4", "5"]
    assert checkpoint.latest_step(ckpt) == 5


def test_kill_and_resume_loss_continuity(tmp_path):
    """Train to step 3 (checkpointing), kill the 'gang', resume fresh
    state from the stamped env: losses 4 and 5 are IDENTICAL to the
    uninterrupted run's, and not the from-scratch ones."""
    cfg = tm.tiny_config()
    opt = tt.make_optimizer(lr=1e-2, warmup_steps=1)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    step_fn = tt.make_train_step(cfg, opt)
    batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4, 64)
    ckpt = str(tmp_path / "ckpt")
    losses = {}
    for step in range(1, 6):
        params, state, m = step_fn(params, state, batch)
        losses[step] = float(m["loss"])
        if step == 3:
            checkpoint.save(ckpt, step=step, params=params,
                            opt_state=state)

    env = {"VTP_CHECKPOINT_DIR": ckpt, "VTP_RESUME_STEP": "3"}
    p2 = tm.init_params(cfg, torch.Generator().manual_seed(99), "cpu")
    s2 = opt.init(p2)
    p2, s2, start = checkpoint.resume_state(p2, s2, environ=env)
    assert start == 3
    resumed = {}
    for step in range(start + 1, 6):
        p2, s2, m = step_fn(p2, s2, batch)
        resumed[step] = float(m["loss"])
    assert resumed[4] == losses[4] and resumed[5] == losses[5]
    assert resumed[4] != losses[1]


# -- across world sizes ------------------------------------------------

RANK_CKPT = r"""
import sys
import torch, torch.distributed as dist
from volcano_tpu_torch.workloads import bootstrap, checkpoint, mesh as mesh_lib
from volcano_tpu_torch.workloads import model as tm, train as tt
mode, ckpt, timeout = sys.argv[1], sys.argv[2], float(sys.argv[3])
bootstrap.initialize(device="cpu", timeout=timeout)
mesh = mesh_lib.make_mesh({"dp": dist.get_world_size()}, "cpu")
cfg = tm.tiny_config()
opt = tt.make_optimizer(lr=1e-2, warmup_steps=1, mu_dtype=torch.bfloat16)
seed = 0 if mode == "save" else 42
params, state, _ = tt.init_sharded(torch.Generator().manual_seed(seed), cfg,
                                   mesh, opt)
step = tt.make_train_step(cfg, opt, mesh)
batch = tt.synthetic_batch(torch.Generator().manual_seed(1), cfg, 4, 32, mesh)
if mode == "save":
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    checkpoint.save(ckpt, 2, params, state)
    if dist.get_rank() == 0:     # what was saved, for the test to compare
        whole = lambda tree: tt.tree_map(lambda x: x.full_tensor(), tree)
        torch.save({"params": whole(params),
                    "state": dict(state, mu=whole(state["mu"]),
                                  nu=whole(state["nu"]))}, ckpt + ".pt")
    print("saved")
else:
    params, state, got = checkpoint.restore(ckpt, params, state)
    assert got == 2 and state["count"] == 2
    assert all(x.dtype == torch.bfloat16 for x in tt.leaves(state["mu"]))
    _, _, m = step(params, state, batch)
    print(repr(float(m["loss"])))
dist.destroy_process_group()
"""


def _rank_ckpt(mode, ckpt, world):
    with rendezvous() as port:
        outs = run_procs(
            [[sys.executable, "-c", RANK_CKPT, mode, ckpt,
              str(RANK_TIMEOUT_S)] for _ in range(world)],
            [base_env(TPU_WORKER_ID=r, NUM_PROCESSES=world,
                      COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      **AGENT_STORE_ENV) for r in range(world)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [o.strip().splitlines()[-1] for _, o, _ in outs]


def test_save_on_two_ranks_restore_on_one(tmp_path):
    """Saved by a 2-rank gloo group (each rank replicated), restored in
    a process with no group: bit-identical to rank 0's state."""
    ckpt = str(tmp_path / "ckpt")
    assert _rank_ckpt("save", ckpt, 2) == ["saved", "saved"]
    assert sorted(os.listdir(ckpt)) == ["2"]
    saved = torch.load(ckpt + ".pt")
    p2, s2, _, _ = _state(seed=42, mu_dtype=torch.bfloat16, steps=0)
    p2, s2, got = checkpoint.restore(ckpt, p2, s2)
    assert got == 2
    _assert_equal_state(saved["params"], saved["state"], p2, s2)


def test_save_on_one_restore_on_two_ranks(tmp_path):
    """Saved by one process, restored by each rank of a 2-rank group;
    both continue to the same global loss, equal to one process's."""
    ckpt = str(tmp_path / "ckpt")
    params, state, step, batch = _state(mu_dtype=torch.bfloat16, steps=2)
    checkpoint.save(ckpt, step=2, params=params, opt_state=state)
    losses = [float(x) for x in _rank_ckpt("restore", ckpt, 2)]
    _, _, m = step(params, state, batch)
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-6)


# -- the worker's resume, as the scheduler relaunches it ---------------

def _worker(env):
    (rc, out, err), = run_procs(
        [[sys.executable, "-m", "volcano_tpu_torch.workloads.worker"]],
        [base_env(WORKER_DEVICE="cpu", TPU_WORKER_ID=0, NUM_PROCESSES=1,
                  WORKER_STEPS=3, **env)])
    return rc, out, err


def test_worker_resumes_from_the_stamped_checkpoint(tmp_path):
    """A fresh run, a resume from a step-5 checkpoint of the worker's
    state (start_step 5, progress step 8), and the refusal to rewind
    when the stamp (7) is newer than every checkpoint."""
    progress = tmp_path / "progress" / "vtp-w0.json"
    rc, out, err = _worker({"VTP_PROGRESS_FILE": progress})
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["start_step"] == 0 and res["collective_sum"] == 1.0
    record = json.loads(progress.read_text())
    assert (record["step"], record["examples"]) == (3, 3.0)

    cfg = tworker.worker_config()
    opt = tt.make_optimizer()
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, step=5, params=params, opt_state=opt.init(params))
    rc, out, err = _worker({"VTP_PROGRESS_FILE": progress,
                            "VTP_CHECKPOINT_DIR": ckpt,
                            "VTP_RESUME_STEP": 5})
    assert rc == 0, err[-2000:]
    resumed = json.loads(out.strip().splitlines()[-1])
    assert resumed["start_step"] == 5
    # the saved state is the fresh one, so the losses agree
    assert resumed["loss"] == res["loss"]
    assert json.loads(progress.read_text())["step"] == 8

    rc, out, err = _worker({"VTP_CHECKPOINT_DIR": ckpt,
                            "VTP_RESUME_STEP": 7})
    assert rc != 0 and "lost data" in err
    assert not out.strip()

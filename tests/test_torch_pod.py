"""A pod that holds several devices runs one rank a device
(volcano_tpu_torch.workloads.worker's launcher), on the CPU: the rank
and world arithmetic, one JSON line and one progress stream a pod,
pods scheduled by the control plane, and a lost rank failing its pod.

The ranks are gloo processes (WORKER_DEVICE=cpu with
WORKER_LOCAL_DEVICES ranks a pod).
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

from test_torch_worker import (PRINTED, SHARE, _one_process_loss, _schedule,
                               pod_env)
from torch_procs import rendezvous
from volcano_tpu.api.goodput import PROGRESS_DIR_ANNOTATION
from volcano_tpu.api.pod import Container, Pod
from volcano_tpu.api.resource import TPU
from volcano_tpu.api.vcjob import TaskSpec, VCJob
from volcano_tpu.simulator import make_tpu_cluster
from volcano_tpu.workloads import mesh as jmesh
from volcano_tpu_torch.workloads import bootstrap as tboot
from volcano_tpu_torch.workloads import mesh as tmesh
from volcano_tpu_torch.workloads import progress as tprogress
from volcano_tpu_torch.workloads import worker as tworker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 150
# a killed rank must fail its pod well inside the group's own timeout
# (600 s): the launcher sees the exit at its next poll and ends the rest
KILL_TO_EXIT_S = 30
LOCAL = 2


@pytest.mark.parametrize("env,want", [
    ({"TPU_WORKER_ID": "1", "NUM_PROCESSES": "2", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2"}, ((1, 2), (3, 4))),
    ({"TPU_WORKER_ID": "0", "NUM_PROCESSES": "3", "LOCAL_RANK": "0",
      "LOCAL_WORLD_SIZE": "4"}, ((0, 4), (0, 12))),
    # LOCAL_RANK alone names a GPU; the process is its pod's one rank
    ({"TPU_WORKER_ID": "3", "NUM_PROCESSES": "4", "LOCAL_RANK": "3"},
     ((0, 1), (3, 4))),
    ({}, ((0, 1), (0, 1))),
])
def test_rank_and_world(env, want):
    info = tboot.from_env(env)
    assert (tboot.local_layout(env), tboot.rank_and_world(info, env)) == want
    with pytest.raises(ValueError, match="outside a pod"):
        tboot.local_layout({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "2"})


def test_local_device_count(monkeypatch):
    cpu = {"WORKER_DEVICE": "cpu"}
    assert tworker.local_device_count(cpu) == 1
    assert tworker.local_device_count(dict(cpu, WORKER_LOCAL_DEVICES="3")) \
        == 3
    # a process started as one rank starts nothing
    assert tworker.local_device_count(
        dict(cpu, WORKER_LOCAL_DEVICES="3", LOCAL_RANK="0")) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tworker.local_device_count({"WORKER_LOCAL_DEVICES": "3"}) == 8
    assert tworker.local_device_count({"LOCAL_RANK": "5"}) == 1


def test_one_progress_writer_a_pod(tmp_path):
    env = {"VTP_PROGRESS_FILE": str(tmp_path / "p.json")}
    assert tprogress.ProgressReporter.from_env(env) is not None
    assert tprogress.ProgressReporter.from_env(
        dict(env, LOCAL_RANK="0", LOCAL_WORLD_SIZE="2")) is not None
    assert tprogress.ProgressReporter.from_env(
        dict(env, LOCAL_RANK="1", LOCAL_WORLD_SIZE="2")) is None
    # a process that is its pod's one rank publishes whatever its GPU
    assert tprogress.ProgressReporter.from_env(
        dict(env, LOCAL_RANK="1")) is not None


@pytest.mark.parametrize("slice_ids", [[0, 0, 1, 1], [1, 1, 0, 0], None])
def test_group_by_slice_keeps_a_pods_ranks(slice_ids):
    """2 pods x 2 ranks: the ranks of a pod share its slice id and land
    in one slice, as the reference's process tier groups a pod's
    devices."""
    devs = [types.SimpleNamespace(id=r, slice_index=None, process_index=r // 2)
            for r in range(4)]
    want = [[d.id for d in g] for g in jmesh.group_by_slice(devs, 2)]
    got = tmesh.group_by_slice(range(4), 2, slice_ids)
    assert sorted(got) == sorted(want) == [[0, 1], [2, 3]]
    if slice_ids:
        assert got[0] == [r for r in range(4) if slice_ids[r] == 0]


def _run_pods(pods):
    """Launch one worker process a pod, each seeing LOCAL devices; waits
    for all.  Returns [(returncode, stdout, stderr)]."""
    procs = []
    with rendezvous() as port:
        try:
            for pod in pods:
                env = pod_env(pod, port)
                env["WORKER_LOCAL_DEVICES"] = str(LOCAL)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "volcano_tpu_torch.workloads.worker"],
                    env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, start_new_session=True))
            return [_finish(p) for p in procs]
        finally:
            for p in procs:
                _kill_group(p)


def _finish(p):
    out, err = p.communicate(timeout=PROC_TIMEOUT_S)
    return p.returncode, out, err


def _kill_group(p):
    """Kill a pod's process and its children (its own session)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait()


@pytest.mark.parametrize("slices", [1, 2], ids=["flat", "two_slices"])
def test_scheduled_pods_run_a_rank_a_device(slices, tmp_path):
    """The control plane binds 2 pods; each pod's worker sees 2 devices
    and runs 2 ranks, so the job trains on 4 (flat: dp 4; two slices:
    dcn 2 x fsdp 2, params sharded over fsdp).  Each pod prints one JSON
    line (process_id its pod index, device_count 4) and publishes one
    progress stream counting the global batch; the loss equals one
    process's on the whole global batch."""
    if slices == 1:
        cluster = make_tpu_cluster([("sa", "v5e-16")])
        tasks = [TaskSpec(name="worker", replicas=2, template=Pod(
            name="t", containers=[Container(requests={"cpu": 4, TPU: 4})]))]
    else:
        cluster = make_tpu_cluster([("sa", "v5e-4"), ("sb", "v5e-4")],
                                   dcn_pods={"sa": "pod-a", "sb": "pod-b"})
        tasks = [TaskSpec(name=f"slice-{s}", replicas=1, subgroup=f"slice-{s}",
                          template=Pod(name="t", containers=[
                              Container(requests={"cpu": 4, TPU: 4})]))
                 for s in ("a", "b")]
    job = _schedule(cluster, VCJob(
        name="pods", min_available=2, tasks=tasks,
        plugins={"jax": [], "svc": []},
        annotations={PROGRESS_DIR_ANNOTATION: str(tmp_path / "progress")}))
    pods = sorted((p for p in cluster.pods.values() if p.owner == job.uid),
                  key=lambda p: int(p.containers[0].env["TPU_WORKER_ID"]))
    assert len(pods) == 2 and all(p.node_name for p in pods)
    results = []
    for rc, out, err in _run_pods(pods):
        assert rc == 0, err[-3000:]
        lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
        assert len(lines) == 1 and out.strip().splitlines()[-1] == lines[0], \
            out
        results.append(json.loads(lines[0]))
    for index, res in enumerate(results):
        assert res["process_id"] == index
        assert res["num_processes"] == 2
        assert res["device_count"] == 2 * LOCAL
        assert res["collective_sum"] == 2.0 * LOCAL
        assert (res["slice_id"], res["num_slices"]) == \
            ((index, 2) if slices == 2 else (0, 1))
    assert results[0]["loss"] == results[1]["loss"]
    assert abs(results[0]["loss"] - _one_process_loss(2 * LOCAL, 2)) <= \
        PRINTED + SHARE
    records = sorted((tmp_path / "progress").iterdir())
    assert len(records) == 2, records
    for path in records:
        record = json.loads(path.read_text())
        assert (record["step"], record["examples"]) == (2, 2.0 * 2 * LOCAL)


def _children(pid):
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(entry))
    return kids


def test_a_killed_rank_fails_its_pod(tmp_path):
    """Kill one of a running pod's two ranks: the launcher ends the
    other and the pod exits non-zero within KILL_TO_EXIT_S."""
    progress = tmp_path / "p.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               WORKER_DEVICE="cpu", WORKER_LOCAL_DEVICES=str(LOCAL),
               TPU_WORKER_ID="0", NUM_PROCESSES="1",
               WORKER_STEPS="1000000", VTP_PROGRESS_FILE=str(progress))
    pod = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.workloads.worker"],
        env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        deadline = time.monotonic() + PROC_TIMEOUT_S
        while not (progress.exists() and
                   json.loads(progress.read_text())["step"] >= 1):
            assert pod.poll() is None, pod.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "the pod never stepped"
            time.sleep(0.2)
        ranks = _children(pod.pid)
        assert len(ranks) == LOCAL
        os.kill(ranks[-1], signal.SIGKILL)
        killed = time.monotonic()
        _, err = pod.communicate(timeout=KILL_TO_EXIT_S)
        assert time.monotonic() - killed < KILL_TO_EXIT_S
        assert pod.returncode != 0
        assert "ending the others" in err
        # the launcher waited for both ranks: neither is left running
        assert not any(os.path.exists(f"/proc/{rank}") for rank in ranks)
    finally:
        _kill_group(pod)

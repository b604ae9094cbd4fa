"""The port's CLI (`volcano_tpu_torch.cli`) against the reference's.

Manifests: the same YAML, with the device's resource and the job
plugin mapped (google.com/tpu -> nvidia.com/gpu, jax -> torch), gives
the same `VCJob` fields.

vtpctl: the same subcommands run through each side's `main` on
mirrored clusters.  The port's `init` is given the mirrors of the
reference's TPU kinds (a v5e-16 is a 4 x 4 NVLink domain, a v5e-4 a
1 x 4 host, node names equal), `--tpu N` becomes `--gpu N`, `--dcn-pod`
becomes `--ib-fabric`.  Every table a subcommand prints must equal the
reference's cell for cell once the GPU layer's words are mapped
(column widths follow the words), and the cluster each side saves must
hold the same jobs, pods, placements and queues.  The same again over
`--server` against each side's in-process state server, and the
slurm-style shortcuts as the functions the console scripts call.
Tolerance: exact.
"""

import dataclasses
import importlib
import itertools
import json
import os
import pickle
import re
import subprocess
import sys
import time
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA-H100-80GB-HBM3"
WALL = 1.7e9

# the reference's words -> the port's, in a subcommand's output
WORDS = (("google.com/tpu", "nvidia.com/gpu"), ("TPU-OK", "GPU-OK"),
         ("CHIPS", "GPUS"), ("TPUUnhealthy", "GPUUnhealthy"),
         ("TPURecovered", "GPURecovered"), ('"jax"', '"torch"'),
         ("'jax'", "'torch'"), ("v5e", "h100"),
         # a v5e-4's 2 x 2 chips are its mirror's 1 host x 4 GPUs
         ("2x2", "1x4"),
         # the fit errors' texts
         ("TPU slice", "NVLink domain"), ("free TPU chips", "free GPUs"),
         ("TPU chips", "GPUs"), ("TPU", "GPU"),
         # the pending-reason slugs (trace.py)
         ("tpu-shape-mismatch", "gpu-shape-mismatch"),
         ("ici-shape-mismatch", "nvlink-shape-mismatch"))


def _side(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        pkg=pkg, pod=m("api.pod"), vtpctl=m("cli.vtpctl"),
        manifest=m("cli.manifest"), serve=m("server.state_server").serve)


REF, PORT = _side("volcano_tpu"), _side("volcano_tpu_torch")


@pytest.fixture(autouse=True)
def _mirror_kinds(monkeypatch):
    """The port's `init` takes the reference's kind names for their
    NVLink mirrors, both sides count uids from 1, and wall time
    stands still."""
    from volcano_tpu_torch.api.devices.gpu import topology
    monkeypatch.setitem(topology.WELL_KNOWN, "v5e-16",
                        topology.DomainTopology("", H100, 4, 4))
    monkeypatch.setitem(topology.WELL_KNOWN, "v5e-4",
                        topology.DomainTopology("", H100, 1, 4))
    for side in (REF, PORT):
        monkeypatch.setattr(side.pod, "_uid_counter", itertools.count(1))
    # one stopped wall clock: the trace stamps and timestamps the
    # subcommands print are equal on both sides
    monkeypatch.setattr(time, "time", lambda: WALL)


def _port_argv(argv):
    out, flags = [], {"--tpu": "--gpu", "--dcn-pod": "--ib-fabric"}
    for a in argv:
        a = flags.get(a, a)
        out.append(a.replace("jax", "torch") if "jax" in a else a)
    return out


UID = re.compile(r"\b(uid-\d+)-[0-9a-f]{8}\b")


def _to_port(text):
    """The reference's output in the port's words; each uid's random
    suffix dropped, its count kept."""
    for tpu, gpu in WORDS:
        text = text.replace(tpu, gpu)
    return text


def _cells(text):
    """A printed table (or JSON) as rows of cells, widths aside."""
    return [re.split(r"\s{2,}", line.strip())
            for line in text.splitlines() if line.strip()]


def _run(side, capsys, state, argv, server=""):
    head = ["--server", server] if server else ["--state", state]
    capsys.readouterr()
    rc = side.vtpctl.main(head + list(argv))
    return rc, capsys.readouterr().out


def _both(capsys, states, argv, server=("", "")):
    rc_r, out_r = _run(REF, capsys, states[0], argv, server[0])
    rc_p, out_p = _run(PORT, capsys, states[1], _port_argv(argv), server[1])
    assert rc_r == rc_p == 0, (argv, rc_r, rc_p)
    assert _cells(UID.sub(r"\1", out_p)) == \
        _cells(UID.sub(r"\1", _to_port(out_r))), argv
    return out_p


def _cluster_view(cluster):
    return dict(
        jobs=sorted((k, j.phase.value, j.running, j.retry_count)
                    for k, j in cluster.vcjobs.items()),
        pods=sorted((p.key, p.node_name, p.phase.value)
                    for p in cluster.pods.values()),
        queues=sorted((q.name, q.weight, q.state.value)
                      for q in cluster.queues.values()),
        nodes=sorted((n.name, n.unschedulable)
                     for n in cluster.nodes.values()),
        hypernodes=sorted(cluster.hypernodes))


def _saved(state):
    with open(state, "rb") as f:
        return _cluster_view(pickle.load(f))


MANIFEST = """
kind: Job
metadata: {name: step}
spec:
  minAvailable: 1
  tasks:
    - name: w
      replicas: 2
      template:
        spec:
          containers:
            - resources:
                requests: {cpu: 1}
"""


# -- manifests ------------------------------------------------------------

def _job_fields(job):
    """The job's fields, its wall-clock stamps aside."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("creation_time", "last_transition_time")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return UID.sub(r"\1", json.dumps(strip(dataclasses.asdict(job)),
                                      default=str, sort_keys=True))


@pytest.mark.parametrize("example", ["job.yaml", "tpu-multislice-job.yaml",
                                     "mpi-job.yaml"])
def test_manifest_parity(example, tmp_path):
    src = open(os.path.join(REPO, "examples", example)).read()
    mirrored = tmp_path / example
    mirrored.write_text(src.replace("google.com/tpu", "nvidia.com/gpu")
                        .replace("jax", "torch"))
    ref = REF.manifest.load_jobs(os.path.join(REPO, "examples", example))
    port = PORT.manifest.load_jobs(str(mirrored))
    assert ref and len(ref) == len(port)
    for r, p in zip(ref, port):
        want = json.loads(_job_fields(r).replace(
            "google.com/tpu", "nvidia.com/gpu").replace("jax", "torch"))
        assert json.loads(_job_fields(p)) == want


def test_manifest_errors_match():
    bad = [{"kind": "Deployment"}, {"kind": "Job", "spec": {}},
           {"kind": "Job", "metadata": {"name": "x"},
            "spec": {"tasks": [{"name": "w"}],
                     "networkTopology": {"mode": "quantum"}}},
           {"kind": "Job", "metadata": {"name": "x"},
            "spec": {"tasks": [{"name": "w", "template": {"spec": {
                "containers": [{"env": [
                    {"name": "IP", "valueFrom": {}}]}]}}}]}}]
    for doc in bad:
        msgs = []
        for side in (REF, PORT):
            with pytest.raises(side.manifest.ManifestError) as e:
                side.manifest.job_from_manifest(doc)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_manifest_default_scheduler_name():
    doc = {"kind": "Job", "metadata": {"name": "g"},
           "spec": {"tasks": [{"name": "w", "replicas": 3}]}}
    job = PORT.manifest.job_from_manifest(doc)
    assert job.scheduler_name == "volcano-tpu" and job.min_available == 3


# -- vtpctl on state files ------------------------------------------------

@pytest.fixture
def states(tmp_path):
    return str(tmp_path / "ref.pkl"), str(tmp_path / "port.pkl")


def test_init_job_tick_and_views(capsys, states, tmp_path):
    manifest = tmp_path / "steps.yaml"
    manifest.write_text(MANIFEST)
    for argv in (
            ["init", "--slices", "sa=v5e-16", "sb=v5e-4",
             "--dcn-pod", "pod-a"],
            ["queue", "create", "-N", "research", "--weight", "3"],
            ["job", "run", "-N", "train", "--replicas", "4", "--tpu", "4",
             "--cpu", "4", "--queue", "research", "--plugins", "jax,svc"],
            ["job", "run", "-N", "big", "--replicas", "6",
             "--min-available", "6", "--cpu", "8", "--tpu", "4",
             "--queue", "research"],
            ["job", "create", "-f", str(manifest)],
            ["tick", "--cycles", "3"],
            ["job", "list"], ["job", "view", "-N", "train"],
            ["job", "view", "-N", "big"], ["pod", "list"],
            ["pod", "describe", "-N", "big-worker-5"],
            ["node", "list"], ["slices"], ["queue", "list"],
            ["queue", "get", "-N", "research"], ["vjobs"], ["vqueues"],
            ["explain", "big"], ["trace", "big"],
            ["goodput", "train"], ["fleet"], ["elastic"],
            ["failover"], ["bandwidth"], ["shards"]):
        _both(capsys, states, argv)
    assert _saved(states[1]) == _saved(states[0])
    view = _saved(states[1])
    assert ("default/train", "Running", 4, 0) in view["jobs"]
    assert sum(1 for p in view["pods"] if p[1]) == 4 + 2


def test_node_list_reads_the_gpu_layer(capsys, states):
    """The GPU column and the health label of the port's agent."""
    from volcano_tpu_torch.agent import FakeUsageProvider, NodeAgent
    _run(PORT, capsys, states[1], ["init", "--slices", "nvl=hgx-h100-8"])
    with open(states[1], "rb") as f:
        c = pickle.load(f)
    prov = FakeUsageProvider()
    prov.set("nvl-w0", cpu_fraction=0.5, gpu_chips_detected=8,
             gpu_chips_healthy=8)
    NodeAgent(c, "nvl-w0", prov).sync()
    with open(states[1], "wb") as f:
        pickle.dump(c, f)
    _run(PORT, capsys, states[1], ["job", "run", "-N", "one", "--gpu", "4"])
    _run(PORT, capsys, states[1], ["tick", "--cycles", "2"])
    rc, out = _run(PORT, capsys, states[1], ["node", "list"])
    rows = _cells(out)
    assert rows[0] == ["NAME", "STATUS", "CPU", "GPUS", "PODS", "USAGE",
                       "GPU-OK"]
    assert rows[1][0] == "nvl-w0" and rows[1][3] == "4/8" and \
        rows[1][6] == "true"
    rc, out = _run(PORT, capsys, states[1], ["slices"])
    assert _cells(out)[1][:3] == ["nvl", "1x8", "1"]
    rc, out = _run(PORT, capsys, states[1], ["node", "view", "-N", "nvl-w0"])
    assert "nvidia.com/gpu.clique=nvl" in out
    # a TPU kind is no NVLink domain (the reference's init raises the
    # same KeyError on a kind it does not know)
    with pytest.raises(KeyError):
        PORT.vtpctl.main(["--state", states[1], "init", "--slices",
                          "x=v5e-256"])


def test_suspend_resume_cancel_and_flows(capsys, states, tmp_path):
    manifest = tmp_path / "steps.yaml"
    manifest.write_text(MANIFEST.replace("step", "prep") + "---\n"
                        + MANIFEST.replace("step", "train"))
    for argv in (
            ["init", "--slices", "sa=v5e-16", "--dcn-pod", "pod-a"],
            ["queue", "create", "-N", "research", "--weight", "3"],
            ["vsub", "-N", "train", "--replicas", "2", "--tpu", "4"],
            ["tick", "--cycles", "3"], ["vjobs"],
            ["vsuspend", "-N", "train"], ["tick", "--cycles", "2"],
            ["vjobs"], ["vresume", "-N", "train"],
            ["tick", "--cycles", "2"], ["vjobs"],
            ["jobtemplate", "create", "-f", str(manifest)],
            ["jobtemplate", "list"],
            ["jobflow", "create", "-N", "pipe", "--flows", "prep",
             "train:prep"],
            ["tick", "--cycles", "2"], ["jobflow", "list"],
            ["jobflow", "describe", "-N", "pipe"], ["job", "list"],
            ["queue", "operate", "-N", "research", "--action", "close"],
            ["queue", "list"],
            ["queue", "operate", "-N", "research", "--action", "open"],
            ["vcancel", "-N", "train"], ["tick"], ["vjobs"],
            ["jobflow", "delete", "-N", "pipe"],
            ["jobtemplate", "delete", "-N", "prep"],
            ["queue", "delete", "-N", "research", "--force"],
            ["vqueues"]):
        _both(capsys, states, argv)
    assert _saved(states[1]) == _saved(states[0])


def test_slurm_shortcuts_as_console_scripts(capsys, states, monkeypatch):
    """vsub_main ... vqueues_main: the verb with argv passed through,
    the connection flags hoisted in front of it."""
    for side, state in zip((REF, PORT), states):
        side.vtpctl.main(["--state", state, "init", "--slices",
                          "sa=v5e-16", "--dcn-pod" if side is REF
                          else "--ib-fabric", "pod-a"])
    outs = []
    for side, state in zip((REF, PORT), states):
        dev = "--tpu" if side is REF else "--gpu"
        seq = []
        for fn, argv in (
                ("vsub_main", ["-N", "t", "--replicas", "2", dev, "4",
                               "--state", state]),
                ("vjobs_main", [f"--state={state}"]),
                ("vsuspend_main", ["--state", state, "-N", "t"]),
                ("vresume_main", ["-N", "t", "--state", state]),
                ("vcancel_main", ["--state", state, "-N", "t"]),
                ("vjobs_main", ["--state", state]),
                ("vqueues_main", ["--state", state])):
            monkeypatch.setattr(sys, "argv", [fn, *argv])
            capsys.readouterr()
            assert getattr(side.vtpctl, fn)() == 0
            assert getattr(side.vtpctl, fn).__name__ == fn[:-5]
            seq.append(capsys.readouterr().out)
        outs.append(seq)
    assert [_cells(o) for o in outs[1]] == \
        [_cells(_to_port(o)) for o in outs[0]]
    assert _saved(states[1]) == _saved(states[0])


def test_cli_subprocess_end_to_end(tmp_path):
    """`python -m volcano_tpu_torch.cli.vtpctl` as an operator runs it."""
    state = str(tmp_path / "c.pkl")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.cli.vtpctl",
             "--state", state, *args], cwd=REPO, capture_output=True,
            text=True, check=True, timeout=120).stdout

    assert "1 nodes" in run("init", "--slices", "nvl=hgx-h100-8",
                            "--ib-fabric", "ib-7")
    run("job", "run", "-N", "train", "--replicas", "1", "--gpu", "8",
        "--plugins", "torch,svc")
    run("tick", "--cycles", "3")
    view = json.loads(run("job", "view", "-N", "train"))
    assert view["status"]["running"] == 1
    assert view["pods"][0]["node"] == "nvl-w0"


# -- vtpctl over --server -------------------------------------------------

class _Servers:
    def __init__(self):
        self.httpd, self.url, self.state = [], [], []
        for side in (REF, PORT):
            httpd, state = side.serve(port=0)
            self.httpd.append(httpd)
            self.state.append(state)
            self.url.append(f"http://127.0.0.1:{httpd.server_address[1]}")

    def close(self):
        for h in self.httpd:
            h.shutdown()
            h.server_close()


def test_vtpctl_over_server(capsys, states, tmp_path):
    """Writes through the live server and reads from its mirror; the
    control plane is each side's controllers and scheduler driving the
    server state in process between the calls."""
    manifest = tmp_path / "j.yaml"
    manifest.write_text(MANIFEST)
    srv = _Servers()
    try:
        urls = tuple(srv.url)
        for argv in (["init", "--slices", "sa=v5e-16", "sb=v5e-4",
                      "--dcn-pod", "pod-a"],
                     ["queue", "create", "-N", "research", "--weight", "2"],
                     ["job", "run", "-N", "train", "--replicas", "4",
                      "--tpu", "4", "--queue", "research",
                      "--plugins", "jax,svc"],
                     ["job", "create", "-f", str(manifest)]):
            _both(capsys, states, argv, server=urls)
        for side, state in zip((REF, PORT), srv.state):
            mgr = importlib.import_module(
                f"{side.pkg}.controllers").ControllerManager(
                    state.cluster, enabled=["job", "queue"])
            sched = importlib.import_module(
                f"{side.pkg}.scheduler").Scheduler(state.cluster,
                                                   schedule_period=0)
            for _ in range(3):
                mgr.sync_all()
                sched.run_once()
                state.cluster.tick()
            mgr.stop()
        for argv in (["tick", "--cycles", "2"], ["job", "list"],
                     ["job", "view", "-N", "train"], ["pod", "list"],
                     ["node", "list"], ["slices"], ["queue", "list"],
                     ["vsuspend", "-N", "train"], ["vjobs"],
                     ["fleet"], ["vcancel", "-N", "step"], ["vjobs"]):
            out = _both(capsys, states, argv, server=urls)
            if argv == ["job", "list"]:
                rows = {r[1]: r for r in _cells(out)[1:]}
                assert rows["train"][2:4] == ["Running", "4/4"], rows
        views = [_cluster_view(s.cluster) for s in srv.state]
        assert views[1] == views[0]
        assert [j[0] for j in views[1]["jobs"]] == ["default/train"]
    finally:
        srv.close()

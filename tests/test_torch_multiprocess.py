"""The port's control plane as separate OS processes that meet only at
the state server, on the CPU: `python -m volcano_tpu_torch.server`,
`python -m volcano_tpu_torch --components controllers` and one or two
`--components scheduler --leader-elect` processes, with this test as
kubectl over the wire.

- A GPU gang is scheduled over the wire into one NVLink domain; the
  leading scheduler is killed (SIGKILL) and its leader-elected standby
  takes the lease and places the next gang in the other domain.
- One pod bound over the wire launches the port's worker with the env
  it carries (`WORKER_DEVICE=cpu`, a gloo group of one).
- The secured plane: TLS and a bearer token, where `cryptography` (for
  the self-signed certificate) imports.

Teardown: the processes are stopped in the reverse of their start,
clients before the server, with SIGTERM and then SIGKILL after a short
grace.  A reference client process whose server is already gone
outlives SIGTERM by its wire retry budget (its retry loop sleeps in the
main thread and does not see the stop event); the port's SIGTERM
closes the client, whose back-off waits on that stop, and the last
test pins both.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
from volcano_tpu_torch.api.pod import Container, Pod
from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (JobPhase, NetworkTopologyMode,
                                         RUN_TICKS_ANNOTATION, TaskStatus)
from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
from volcano_tpu_torch.simulator import domain_nodes
from volcano_tpu_torch.workloads import bootstrap as tboot
from torch_procs import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT = "NVIDIA-H100-80GB-HBM3"
GRACE_S = 2.0
CONTRACT = {tboot.ENV_WORKER_ID, tboot.ENV_HOSTNAMES, tboot.ENV_COORDINATOR,
            tboot.ENV_NUM_PROCESSES}


def wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class Plane:
    """Starts the port's control-plane processes and reaps them."""

    def __init__(self, tmp_path, scheme="http", ctx=None):
        self.tmp_path = tmp_path
        self.procs = {}
        self.port = free_port()
        self.url = f"{scheme}://127.0.0.1:{self.port}"
        self.ctx = ctx

    def spawn(self, name, *argv):
        logf = open(self.tmp_path / f"{name}.log", "w")
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs[name] = subprocess.Popen(
            [sys.executable, *argv], stdout=logf, stderr=logf, env=env,
            cwd=REPO)

    def start_server(self, *extra):
        self.spawn("server", "-m", "volcano_tpu_torch.server",
                   "--port", str(self.port), "--tick-period", "0.1", *extra)
        wait_for(self._up, 20, "server /healthz")

    def _up(self):
        try:
            with urllib.request.urlopen(self.url + "/healthz", timeout=1,
                                        context=self.ctx):
                return True
        except OSError:
            return False

    def start(self, name, components, *extra):
        self.spawn(name, "-m", "volcano_tpu_torch", "--cluster-url",
                   self.url, "--components", components, "--period", "0.1",
                   *extra)

    def start_scheduler(self, name):
        self.start(name, "scheduler", "--leader-elect", "--holder", name,
                   "--lease-ttl", "1.0")

    def leases(self):
        with urllib.request.urlopen(self.url + "/leases", timeout=2) as r:
            return json.loads(r.read())

    def kill(self, name, sig=signal.SIGKILL):
        proc = self.procs.pop(name, None)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(sig)
        try:
            proc.wait(timeout=GRACE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)

    def shutdown(self):
        for name in reversed(list(self.procs)):
            self.kill(name, signal.SIGTERM)

    def logs(self):
        return "\n".join(f"==== {f.name} ====\n{f.read_text()[-3000:]}"
                         for f in sorted(self.tmp_path.glob("*.log")))


@pytest.fixture()
def plane(tmp_path):
    p = Plane(tmp_path)
    try:
        yield p
    finally:
        p.shutdown()


def gpu_job(name, run_ticks=0):
    """A 4-host gang, 4 GPUs a pod, held to one NVLink domain."""
    annotations = {RUN_TICKS_ANNOTATION: str(run_ticks)} if run_ticks \
        else {}
    return VCJob(
        name=name, min_available=4,
        network_topology=NetworkTopologySpec(NetworkTopologyMode.HARD, 1),
        tasks=[TaskSpec(name="worker", replicas=4, template=Pod(
            name="t", annotations=annotations,
            containers=[Container(requests={"cpu": 8, GPU: 4})]))],
        plugins={"torch": [], "svc": []})


def add_domains(kubectl, names=("sa", "sb")):
    for name in names:
        for node in domain_nodes(DomainTopology(name, PRODUCT, 4, 4),
                                 ib_fabric="ib-0"):
            kubectl.add_node(node)


def job_pods(kubectl, job):
    return [p for p in kubectl.pods.values()
            if p.labels.get("volcano-tpu.io/job-name") == job]


def running(kubectl, job):
    return sum(1 for p in job_pods(kubectl, job)
               if p.phase is TaskStatus.RUNNING)


def domains_used(kubectl, job):
    return {p.node_name.rsplit("-w", 1)[0]
            for p in job_pods(kubectl, job) if p.node_name}


def test_gang_over_the_wire_survives_a_scheduler_crash(plane):
    plane.start_server()
    kubectl = RemoteCluster(plane.url)
    try:
        add_domains(kubectl)
        plane.start("controllers", "controllers")
        plane.start_scheduler("sched-1")
        wait_for(lambda: plane.leases().get("scheduler", {}).get(
            "holder") == "sched-1", 15, "sched-1 leads")
        plane.start_scheduler("sched-2")
        kubectl.add_vcjob(gpu_job("job1"))
        try:
            wait_for(lambda: running(kubectl, "job1") == 4, 20,
                     "job1 running")
        except AssertionError:
            raise AssertionError(plane.logs())
        used1 = domains_used(kubectl, "job1")
        assert len(used1) == 1, used1
        assert any(hn.tier == 1 for hn in kubectl.hypernodes.values())
        env = job_pods(kubectl, "job1")[0].containers[0].env
        assert CONTRACT <= set(env), env
        assert plane.leases()["scheduler"]["holder"] == "sched-1"

        plane.kill("sched-1", signal.SIGKILL)
        kubectl.add_vcjob(gpu_job("job2"))
        try:
            wait_for(lambda: running(kubectl, "job2") == 4, 20,
                     "job2 running after the failover")
        except AssertionError:
            raise AssertionError(plane.logs())
        assert plane.leases()["scheduler"]["holder"] == "sched-2"
        used2 = domains_used(kubectl, "job2")
        assert len(used2) == 1 and not used1 & used2, (used1, used2)
    finally:
        kubectl.close()


def test_pod_bound_over_the_wire_runs_the_port_worker(plane):
    from test_torch_worker import PRINTED, SHARE, _launch_workers, \
        _one_process_loss
    plane.start_server()
    kubectl = RemoteCluster(plane.url)
    try:
        for node in domain_nodes(DomainTopology("nvl", PRODUCT, 1, 8),
                                 ib_fabric="ib-0"):
            kubectl.add_node(node)
        plane.start("controllers", "controllers")
        plane.start_scheduler("sched-1")
        job = kubectl.add_vcjob(VCJob(
            name="one", min_available=1, plugins={"torch": [], "svc": []},
            tasks=[TaskSpec(name="worker", replicas=1, template=Pod(
                name="t", containers=[Container(
                    requests={"cpu": 4, GPU: 8})]))]))
        try:
            wait_for(lambda: kubectl.vcjobs[job.key].phase is
                     JobPhase.RUNNING, 20, "the job running")
        except AssertionError:
            raise AssertionError(plane.logs())
        (pod,) = [p for p in kubectl.pods.values() if p.owner == job.uid]
        assert pod.node_name == "nvl-w0"
        assert CONTRACT <= set(pod.containers[0].env)
        (res,) = _launch_workers([pod])
        assert (res["process_id"], res["num_processes"],
                res["device_count"]) == (0, 1, 1)
        assert abs(res["loss"] - _one_process_loss(1, 2)) <= PRINTED + SHARE
    finally:
        kubectl.close()


def test_tls_and_bearer_token_plane(tmp_path):
    pytest.importorskip("cryptography")
    import ssl

    from volcano_tpu_torch.cache.remote_cluster import RemoteError
    from volcano_tpu_torch.server.tlsutil import generate_self_signed
    cert, key = str(tmp_path / "server.crt"), str(tmp_path / "server.key")
    generate_self_signed(cert, key)
    token = "test-cluster-token"
    plane = Plane(tmp_path, scheme="https",
                  ctx=ssl.create_default_context(cafile=cert))
    kubectl = None
    try:
        plane.start_server("--tls-cert", cert, "--tls-key", key,
                           "--token", token)
        kubectl = RemoteCluster(plane.url, token=token, ca_cert=cert)
        add_domains(kubectl, ("sa",))
        for name in ("controllers", "scheduler"):
            plane.start(name, name, "--token", token, "--ca-cert", cert)
        kubectl.add_vcjob(gpu_job("secure", run_ticks=3))
        try:
            wait_for(lambda: kubectl.vcjobs["default/secure"].phase is
                     JobPhase.COMPLETED, 30, "the job completed")
        except AssertionError:
            raise AssertionError(plane.logs())
        # plaintext against the TLS port is refused at the handshake
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/healthz",
                                   timeout=2)
        # a wrong token is refused on its first read
        with pytest.raises(RemoteError) as err:
            RemoteCluster(plane.url, start_watch=False, token="wrong",
                          ca_cert=cert)
        assert err.value.code == 401
    finally:
        if kubectl is not None:
            kubectl.close()
        plane.shutdown()


def _controllers_against_a_dead_server(pkg, log):
    """`python -m <pkg> --components controllers` against its package's
    state server, in process, holding one job (the job controller reads
    the job's commands over the wire every sync); the server is then
    shut down, so every sync retries.  Returns the running process."""
    import importlib
    serve = importlib.import_module(f"{pkg}.server.state_server").serve
    api = importlib.import_module(f"{pkg}.api.vcjob")
    pods = importlib.import_module(f"{pkg}.api.pod")
    client = importlib.import_module(f"{pkg}.cache.remote_cluster")
    httpd, _ = serve(port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    kubectl = client.RemoteCluster(url, start_watch=False)
    kubectl.add_vcjob(api.VCJob(name="j", tasks=[api.TaskSpec(
        name="w", template=pods.Pod(name="t", containers=[
            pods.Container(requests={"cpu": 1})]))]))
    kubectl.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg, "--cluster-url", url, "--components",
         "controllers", "--controllers", "job", "--period", "0.1"],
        stdout=log, stderr=log, env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO)
    return proc, httpd


def test_sigterm_stops_a_client_retrying_against_a_dead_server(tmp_path):
    """The reference's client process outlives SIGTERM once its server
    is gone: the handler sets only the main loop's event, and the call
    in flight sleeps out its 30 s retry budget.  The port's handler
    closes the cluster client, whose back-off waits on that stop: the
    process exits within about a second."""
    procs = {}
    try:
        for pkg in ("volcano_tpu", "volcano_tpu_torch"):
            procs[pkg] = _controllers_against_a_dead_server(
                pkg, open(tmp_path / f"{pkg}.log", "w"))
        for pkg, (proc, httpd) in procs.items():
            log = tmp_path / f"{pkg}.log"
            wait_for(lambda: "control plane up" in log.read_text(), 30,
                     f"{pkg}'s controllers up")
            httpd.shutdown()
            httpd.server_close()
        # a sync every 0.1 s: each process is now inside a call that
        # retries (its budget is 30 s)
        time.sleep(1.0)
        t0 = time.monotonic()
        for proc, _ in procs.values():
            proc.send_signal(signal.SIGTERM)
        port = procs["volcano_tpu_torch"][0]
        assert port.wait(timeout=10) == 0
        assert time.monotonic() - t0 < 1.5
        time.sleep(max(0.0, t0 + 3.0 - time.monotonic()))
        assert procs["volcano_tpu"][0].poll() is None, \
            "the reference's client no longer outlives SIGTERM"
    finally:
        for proc, httpd in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
            httpd.server_close()

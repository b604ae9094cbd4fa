"""The port's deploy bundle (`volcano_tpu_torch.bundle`) against the
reference's.

Both bundles are rendered with the same port, token and data dir, the
reference over TPU slices and the port over their NVLink mirrors.  They
hold the same files; the scheduler conf, the values (topology aside),
the Prometheus scrape and the dashboards are equal once the GPU layer's
words are mapped (panel titles); each role's command is the reference's
with the port's modules in place of the reference's console scripts
and the gpu collector in place of tpu.  The port's `FAMILIES` declare
every family a live port exposition emits, and the rendered
`cluster-init.sh` registers, through the port's vtpctl on a live port
server, exactly the NVLink domains and IB fabrics it declares.
"""

import json
import os
import re
import shlex
import stat
import subprocess
import sys

import pytest

from volcano_tpu import bundle as rbundle
from volcano_tpu_torch import bundle as tbundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "tok123"
REF_TOPOLOGY = "sa:v5e-16,sb:v5e-4"
PORT_TOPOLOGY = "sa:dgx-h100-256@ib-0,sb:hgx-h100-8@ib-1"

# the port's role commands in the reference's words
COMMANDS = (("python3 -m volcano_tpu_torch.server ", "volcano-tpu-server "),
            ("python3 -m volcano_tpu_torch ", "volcano-tpu "),
            ("collectors:local,gpu,", "collectors:local,tpu,"))
# the port's panel titles in the reference's words
TITLES = (("NVLink-domain fragmentation", "ICI fragmentation"),
          ("mCPU / GPUs", "mCPU / chips"))


@pytest.fixture
def bundles(tmp_path):
    ref = rbundle.render(str(tmp_path / "ref"), topology=REF_TOPOLOGY,
                         port=8701, data_dir="/data/vtp", token=TOKEN)
    port = tbundle.render(str(tmp_path / "port"), topology=PORT_TOPOLOGY,
                          port=8701, data_dir="/data/vtp", token=TOKEN)
    return ref, port


def _read(path, ref_dir="", port_dir=""):
    text = open(path).read()
    return text.replace(port_dir, ref_dir) if port_dir else text


def _back(text, pairs):
    for port_word, ref_word in pairs:
        text = text.replace(port_word, ref_word)
    return text


def test_same_files_and_modes(bundles):
    ref, port = bundles
    assert sorted(port) == sorted(ref)
    for rel in ref:
        assert stat.S_IMODE(os.stat(port[rel]).st_mode) == \
            stat.S_IMODE(os.stat(ref[rel]).st_mode), rel
    assert open(port["token"]).read().strip() == TOKEN


@pytest.mark.parametrize("rel", ["token", "scheduler.conf.yaml",
                                 "prometheus.yml", "grafana/agents.json",
                                 "grafana/federation.json"])
def test_equal_files(bundles, rel):
    ref, port = bundles
    rdir, pdir = (os.path.dirname(ref["token"]),
                  os.path.dirname(port["token"]))
    assert _read(port[rel], rdir, pdir) == _read(ref[rel])


def test_scheduler_dashboard_equal_but_titles(bundles):
    ref, port = bundles
    text = _back(_read(port["grafana/scheduler.json"]), TITLES)
    assert text == _read(ref["grafana/scheduler.json"])
    assert "NVLink-domain fragmentation" in \
        _read(port["grafana/scheduler.json"])


def test_values_equal_but_topology(bundles):
    ref, port = bundles
    rv = json.load(open(ref["values.json"]))
    pv = json.load(open(port["values.json"]))
    assert pv.pop("topology") == PORT_TOPOLOGY
    assert rv.pop("topology") == REF_TOPOLOGY
    assert pv.pop("bundle_dir") != rv.pop("bundle_dir")
    assert pv == rv


@pytest.mark.parametrize("role", ["server", "scheduler", "controllers",
                                  "agents"])
def test_role_units_are_the_port_entry_points(bundles, role):
    ref, port = bundles
    rel = f"systemd/volcano-tpu-{role}.service"
    rdir, pdir = (os.path.dirname(ref["token"]),
                  os.path.dirname(port["token"]))
    unit = _read(port[rel], rdir, pdir)
    assert unit != _read(ref[rel])
    assert _back(unit, COMMANDS) == _read(ref[rel])
    cmd = next(line for line in unit.splitlines()
               if line.startswith("ExecStart="))
    argv = shlex.split(cmd[len("ExecStart="):])
    assert argv[:3] == ["python3", "-m", "volcano_tpu_torch.server"
                        if role == "server" else "volcano_tpu_torch"]
    # every flag the unit passes is one the port's entry point declares
    entry = os.path.join(REPO, "volcano_tpu_torch", *(
        ("server", "__main__.py") if role == "server" else ("__main__.py",)))
    source = open(entry).read()
    flags = {a for a in argv[3:] if a.startswith("--")}
    assert flags and all(f'"{f}"' in source for f in flags), flags
    if role == "agents":
        assert "collectors:local,gpu,netaccounting,goodput,serving" in argv


def test_compose_uses_the_port_entry_points(bundles):
    ref, port = bundles
    rc = json.load(open(ref["docker-compose.yaml"]))
    pc = json.load(open(port["docker-compose.yaml"]))
    assert set(pc["services"]) == set(rc["services"])
    for role, svc in pc["services"].items():
        want = rc["services"][role]
        assert _back(svc["command"][2], COMMANDS) == want["command"][2]
        assert svc["command"][:2] == want["command"][:2]
        assert {k: v for k, v in svc.items() if k not in ("command",
                                                         "volumes")} == \
            {k: v for k, v in want.items() if k not in ("command",
                                                       "volumes")}


def test_topology_and_cluster_init_name_nvlink_domains(bundles):
    _, port = bundles
    topo = json.load(open(port["topology.json"]))
    assert topo == {"slices": [
        {"name": "sa", "kind": "dgx-h100-256", "ib_fabric": "ib-0"},
        {"name": "sb", "kind": "hgx-h100-8", "ib_fabric": "ib-1"}]}
    init = open(port["cluster-init.sh"]).read()
    assert os.access(port["cluster-init.sh"], os.X_OK)
    calls = [line for line in init.splitlines()
             if "volcano_tpu_torch.cli.vtpctl" in line]
    assert len(calls) == 2
    assert "--ib-fabric ib-0 --slices sa=dgx-h100-256" in calls[0]
    assert "--ib-fabric ib-1 --slices sb=hgx-h100-8" in calls[1]
    # defaults: one DGX domain in ib-0
    assert tbundle.render(os.path.dirname(port["token"]) + "-d",
                          token="t")["topology.json"]
    assert json.load(open(os.path.dirname(port["token"])
                          + "-d/topology.json")) == {"slices": [
        {"name": "nvl-a", "kind": "dgx-h100-256", "ib_fabric": "ib-0"}]}


def test_conf_plugins_resolve_in_the_port_registry(bundles):
    import volcano_tpu_torch.plugins  # noqa: F401 — registers the plugins
    from volcano_tpu_torch.conf import load_conf
    from volcano_tpu_torch.framework.plugins import (PLUGIN_BUILDERS,
                                                     get_action)
    _, port = bundles
    doc = json.load(open(port["scheduler.conf.yaml"]))
    names = [p["name"] for tier in doc["tiers"] for p in tier["plugins"]]
    assert not [n for n in names if n not in PLUGIN_BUILDERS]
    conf = load_conf(doc)
    assert all(get_action(a) is not None for a in conf.actions)


def test_bundle_cli_renders(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bundle", "--out",
         str(tmp_path / "b"), "--topology", "h0:hgx-h100-8"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "grafana/scheduler.json" in out.stdout.split()


def test_dashboards_query_declared_families():
    for dash in (tbundle.scheduler_dashboard(), tbundle.agent_dashboard(),
                 tbundle.federation_dashboard()):
        names = tbundle.dashboard_metric_names(dash)
        assert names and not names - set(tbundle.FAMILIES)
    assert tbundle.FAMILIES == rbundle.FAMILIES
    # the label schema names the port's enums (GPU generations)
    assert tbundle.FAMILY_LABELS["frag_index"]["generation"] == \
        "enum:volcano_tpu_torch.api.goodput:GENERATIONS"


def test_families_cover_a_live_port_exposition():
    """A scheduling session, the agent's GPU collector and health
    handler, the controllers and a state server's own registry: every
    family they emit is declared."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.agent.agent import FakeUsageProvider, NodeAgent
    from volcano_tpu_torch.agent.handlers import GpuHealthHandler
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import make_gpu_cluster
    from volcano_tpu_torch.uthelper import gang_job
    from volcano_tpu_torch.webhooks import default_admission

    metrics.reset()
    try:
        cluster = make_gpu_cluster([("h0", "hgx-h100-8"),
                                    ("h1", "hgx-h100-8")])
        cluster.admission = default_admission()
        pg, pods = gang_job("dash", replicas=2,
                            requests={"cpu": 1, GPU: 8})
        cluster.add_podgroup(pg)
        for p in pods:
            cluster.add_pod(p)
        prov = FakeUsageProvider()
        prov.set("h0-w0", cpu_fraction=0.4, gpu_chips_detected=8,
                 gpu_chips_healthy=7)
        agent = NodeAgent(cluster, "h0-w0", prov,
                          handlers=[GpuHealthHandler])
        mgr = ControllerManager(cluster, enabled=["job", "queue",
                                                  "podgroup", "failover"])
        sched = Scheduler(cluster, schedule_period=0)
        for _ in range(3):
            agent.sync()
            mgr.sync_all()
            sched.run_once()
            cluster.tick()
        mgr.stop()
        dumped = metrics.dump()
    finally:
        metrics.reset()
    names = {line.split("{")[0].split(" ")[0]
             for line in dumped.splitlines() if line and line[0] != "#"}
    for family in ("e2e_scheduling_latency_seconds_count",
                   "action_latency_seconds_count",
                   "schedule_attempts_total"):
        assert family in names, sorted(names)[:30]
    undeclared = {n for n in names if n not in tbundle.FAMILIES and
                  tbundle.FAMILIES.get(re.sub(r"_(count|sum)$", "", n))
                  != "histogram"}
    assert not undeclared, sorted(undeclared)
    from volcano_tpu_torch.analysis.schema import check_exposition
    assert not check_exposition(dumped)


def test_cluster_init_registers_the_declared_domains(tmp_path):
    """The rendered script, run as an operator runs it, against a live
    port server that takes the bundle's token."""
    from volcano_tpu_torch.controllers.hypernode import IB_FABRIC_LABEL
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
    from volcano_tpu_torch.server.state_server import serve
    httpd, state = serve(port=0, token=TOKEN)
    try:
        port = httpd.server_address[1]
        topo = ",".join([f"h{i}:hgx-h100-8@ib-{i % 2}" for i in range(4)]
                        + ["dgx:dgx-h100-256@ib-2"])
        written = tbundle.render(str(tmp_path / "b"), topology=topo,
                                 port=port, token=TOKEN)
        proc = subprocess.run(
            ["sh", written["cluster-init.sh"]], cwd=REPO,
            env=dict(os.environ, PYTHON=sys.executable),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        nodes = state.cluster.nodes
        assert len(nodes) == 4 + 32
        by_domain = {}
        for n in nodes.values():
            by_domain.setdefault(n.labels[GPU_CLIQUE_LABEL], set()).add(
                n.labels[IB_FABRIC_LABEL])
        want = {f"h{i}": {f"ib-{i % 2}"} for i in range(4)}
        want["dgx"] = {"ib-2"}
        assert by_domain == want
        assert {"ib-0", "ib-1", "ib-2"} <= set(state.cluster.hypernodes)
    finally:
        httpd.shutdown()
        httpd.server_close()

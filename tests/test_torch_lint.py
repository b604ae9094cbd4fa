"""The port's invariant linter (`volcano_tpu_torch.analysis`) against the
reference's.

1. The port's tree lints clean under --strict: the AST rules, the
   flakes pass, the ownership (race) pass and the registry checks, in
   process and through `python -m volcano_tpu_torch.analysis.vtplint
   --strict`, with every waiver explained.
2. Every broken fixture of the reference's rule tests is caught by the
   port's linter with the same findings (rule, line, message, waiver)
   as the reference's, the fixture's paths and imports renamed to the
   port's tree.
3. The label schema over a live exposition of a port session (the
   scheduler with the elastic, goodput and trace families on a
   mirrored GPU cluster; a two-region federation plane) has zero
   violations, and every family it exports is declared in the port's
   `bundle.FAMILIES`.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.analysis import (flakes, racecheck, registry,
                                        vtplint)
from volcano_tpu_torch.analysis.schema import check_exposition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAME = re.compile(r"\bvolcano_tpu\b")
H100 = "NVIDIA-H100-80GB-HBM3"


def _pkg(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return dict(astlint=m("analysis.astlint"), flakes=m("analysis.flakes"),
                racecheck=m("analysis.racecheck"),
                schema=m("analysis.schema"))


REF, PORT = _pkg("volcano_tpu"), _pkg("volcano_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_registries():
    metrics.reset()
    trace.reset()
    yield
    metrics.reset()
    trace.reset()


# -- 1. the port's tree is clean ------------------------------------------

def test_vtplint_strict_port_tree_is_clean():
    active, suppressed = vtplint.run(
        [os.path.join(REPO, "volcano_tpu_torch")])
    assert not active, "\n".join(f.format() for f in active)
    assert suppressed and all(f.suppressed for f in suppressed)
    assert not [f for f in suppressed
                if f.rule == "unexplained-suppression"]


def test_vtplint_module_strict_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.analysis.vtplint",
         "--strict", "--json"], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["findings"] == 0
    assert doc["suppressions"] and \
        all(s["reason"] for s in doc["suppressions"])
    # the port's tree only, and the reference's cache left alone
    assert all(s["site"].startswith("volcano_tpu_torch/")
               for s in doc["suppressions"])
    assert vtplint.DEFAULT_PATHS == ("volcano_tpu_torch",)
    from volcano_tpu_torch.analysis.lintcache import CACHE_DIR
    assert CACHE_DIR == ".vtplint_torch_cache"


def test_registry_checks_pass():
    findings = registry.check_all()
    assert not findings, "\n".join(f.format() for f in findings)


def test_racecheck_classifies_the_port_reader_trees():
    prog = racecheck.build_program([os.path.join(REPO, "volcano_tpu_torch")])
    findings = prog.analyze()
    assert not [f for f in findings if f.suppressed is None]
    readers = set(prog.readers())
    for needle in ("volcano_tpu_torch/actions/util.py:fit_class",
                   "volcano_tpu_torch/actions/sweep.py:sweep_shard",
                   "volcano_tpu_torch/plugins/predicates.py:"
                   "PredicatesPlugin._predicate"):
        assert any(r.endswith(needle) for r in readers), needle


# -- 2. the reference's broken fixtures, on both linters ------------------

STATE_SERVER = "volcano_tpu/server/state_server.py"

# a bare retry loop: it handles an error and sleeps a fixed delay
_RETRY = ("import time\ndef poll(c):\n    while True:\n        try:\n"
          "            return c.get()\n        except OSError:\n"
          "            time.sleep(0.5)\n")

# (name, source, path): the reference's layer-2 fixtures
AST_FIXTURES = [
    ("req-id", "class C:\n    def create(self, body):\n        return "
     "self._request('POST', '/objects/vcjob', body)\n",
     "volcano_tpu/cache/x.py"),
    ("req-id-keyed", "class C:\n    def create(self, body):\n        "
     "return self._request('POST', '/objects/vcjob', body, "
     "idempotency_key=True)\n", "volcano_tpu/cache/x.py"),
    ("wall-clock-file", "import time\ndeadline = time.time() + 5\n",
     STATE_SERVER),
    ("wall-clock-lease", "import time\ndef renew_lease():\n    return "
     "time.time() + 15\n", "volcano_tpu/somewhere.py"),
    ("wall-clock-outside", "import time\ndef measure():\n    return "
     "time.time()\n", "volcano_tpu/somewhere.py"),
    ("metric-family", "from volcano_tpu import metrics\n"
     "metrics.inc('totally_unregistered_total')\n",
     "volcano_tpu/actions/x.py"),
    ("metric-labels-key", "from volcano_tpu import metrics\n"
     "metrics.inc('elastic_decisions_total', job='ns/j')\n",
     "volcano_tpu/actions/x.py"),
    ("metric-labels-enum", "from volcano_tpu import metrics\n"
     "metrics.inc('elastic_decisions_total', kind='explode')\n",
     "volcano_tpu/actions/x.py"),
    ("metric-labels-member", "from volcano_tpu import metrics\n"
     "metrics.inc('elastic_decisions_total', kind='grow')\n",
     "volcano_tpu/actions/x.py"),
    ("append-lock", "class S:\n    def record(self, rec):\n        "
     "self.durable.append(rec)\n", STATE_SERVER),
    ("append-lock-held", "class S:\n    def record(self, rec):\n        "
     "with self._lock:\n            self.durable.append(rec)\n",
     STATE_SERVER),
    ("ship-purity", "import multiprocessing\ndef leak(conn, obj):\n    "
     "conn.send(obj)\n", "volcano_tpu/actions/x.py"),
    ("ship-purity-seam", "import multiprocessing\ndef post_bytes(conn, "
     "data):\n    conn.send_bytes(data)\n", "volcano_tpu/actions/x.py"),
    ("ship-purity-no-mp", "def notify(ch, obj):\n    ch.send(obj)\n",
     "volcano_tpu/actions/x.py"),
    ("except-pass", "def poke(path):\n    try:\n        "
     "open(path).read()\n    except Exception:\n        pass\n",
     "volcano_tpu/x.py"),
    ("except-pass-narrow", "def poke(d):\n    try:\n        return "
     "d['k']\n    except KeyError:\n        pass\n", "volcano_tpu/x.py"),
    ("episode", "class R:\n    def _move(self, h, job):\n        "
     "self.rpc.call('ra', 'add_vcjob',\n                      lambda: "
     "h.client.add_vcjob(job))\n", "volcano_tpu/federation/router.py"),
    ("episode-threaded", "from volcano_tpu.api import federation as "
     "fedapi\nclass R:\n    def _move(self, h, job):\n        "
     "fedapi.ensure_episode(job)\n        self.rpc.call('ra', "
     "'add_vcjob',\n                      lambda: "
     "h.client.add_vcjob(job))\n", "volcano_tpu/federation/router.py"),
    ("episode-fence", "class R:\n    def _fence(self, adv):\n        "
     "self.rpc.call('ra', 'advance_fence', adv)\n",
     "volcano_tpu/federation/router.py"),
    ("episode-controller", "class C:\n    def _decide(self, pg, now):\n"
     "        self._episodes[pg.key] = ResizeEpisode(\n            "
     "pg.key, 'grow', now)\n", "volcano_tpu/controllers/elastic.py"),
    ("episode-controller-threaded", "from volcano_tpu.api import "
     "federation as fedapi\nclass C:\n    def _decide(self, pg, now):\n"
     "        self._episodes[pg.key] = ResizeEpisode(\n            "
     "pg.key, 'grow', now,\n            episode=fedapi.episode_of(pg) "
     "or '')\n", "volcano_tpu/controllers/elastic.py"),
    ("episode-waived", "class C:\n    def _decide(self, pg, now):\n"
     "        # vtplint: disable=episode-propagation (fixture: "
     "pre-federation local resize)\n        self._episodes[pg.key] = "
     "ResizeEpisode(\n            pg.key, 'grow', now)\n",
     "volcano_tpu/controllers/elastic.py"),
    ("fed-retry", _RETRY, "volcano_tpu/federation/mirror.py"),
    ("fed-retry-policy", _RETRY, "volcano_tpu/federation/retry.py"),
    ("fed-retry-outside", _RETRY, "volcano_tpu/cache/x.py"),
    ("suppressed-with-reason", "import time\n# vtplint: disable="
     "wall-clock (fixture: wire carries wall time)\ndeadline = "
     "time.time() + 5\n", STATE_SERVER),
    ("unexplained-suppression", "import time\n# vtplint: disable="
     "wall-clock\ndeadline = time.time() + 5\n", STATE_SERVER),
]

# the rule each fixture must raise unwaived (None: nothing unwaived)
FIRES = {"req-id": "req-id", "wall-clock-file": "wall-clock",
         "wall-clock-lease": "wall-clock", "metric-family": "metric-family",
         "metric-labels-key": "metric-labels",
         "metric-labels-enum": "metric-labels", "append-lock": "append-lock",
         "ship-purity": "process-ship-purity", "except-pass": "except-pass",
         "episode": "episode-propagation",
         "episode-controller": "episode-propagation",
         "fed-retry": "fed-retry",
         "unexplained-suppression": "unexplained-suppression"}


def _key(findings):
    return sorted((f.rule, f.line, RENAME.sub("volcano_tpu_torch", f.msg),
                   f.suppressed) for f in findings)


@pytest.mark.parametrize("name,src,path", AST_FIXTURES,
                         ids=[f[0] for f in AST_FIXTURES])
def test_rule_fixture_same_findings(name, src, path):
    ref = REF["astlint"].Linter().lint_source(src, path)
    port = PORT["astlint"].Linter().lint_source(
        RENAME.sub("volcano_tpu_torch", src),
        RENAME.sub("volcano_tpu_torch", path))
    assert _key(port) == _key(ref)
    active = {f.rule for f in port if f.suppressed is None}
    if name in FIRES:
        assert FIRES[name] in active
    else:
        assert not active, active
    if name in ("episode-waived", "suppressed-with-reason"):
        assert any(f.suppressed for f in port)


RACE_PLUGIN = "volcano_tpu/plugins/fixture_plugin.py"
_PRED = ("class P:\n    def on_session_open(self, ssn):\n"
         "        ssn.add_predicate_fn('p', self._predicate)\n"
         "    def _predicate(self, task, node):\n")
RACE_FIXTURES = [
    ("attribute-write", _PRED + "        task.node_name = node.name\n"
     "        return None\n", "snapshot-write"),
    ("mutator-call", _PRED + "        node.idle.sub(task.resreq)\n"
     "        return None\n", "snapshot-write"),
    ("item-write-taint", "class P:\n    def on_session_open(self, ssn):\n"
     "        ssn.add_node_order_fn('p', self._score)\n"
     "    def _score(self, task, node):\n"
     "        owner = node.tasks.get(task.uid)\n"
     "        node.tasks[task.uid] = task\n        return 0.0\n",
     "snapshot-write"),
    ("clean-reader", _PRED + "        fresh = node.idle.clone()\n"
     "        fresh.sub(task.resreq)\n        counts = {}\n"
     "        counts[node.name] = 1\n        return None\n", None),
    ("shared-cache", _PRED + "        self._memo[task.uid] = node.name\n"
     "        return None\n", "shared-cache-unkeyed"),
    ("shared-cache-waived", _PRED + "        # vtplint: disable="
     "shared-cache-unkeyed (idempotent memo under plugin lock)\n"
     "        self._memo[task.uid] = node.name\n        return None\n",
     None),
    ("through-helper", _PRED + "        return self._helper(task, node)\n"
     "    def _helper(self, task, node):\n"
     "        node.bind_generation = 0\n        return None\n",
     "snapshot-write"),
]


@pytest.mark.parametrize("name,src,rule", RACE_FIXTURES,
                         ids=[f[0] for f in RACE_FIXTURES])
def test_race_fixture_same_findings(name, src, rule):
    ref = REF["racecheck"].check_sources({RACE_PLUGIN: src})
    port = PORT["racecheck"].check_sources(
        {RENAME.sub("volcano_tpu_torch", RACE_PLUGIN): src})
    assert _key(port) == _key(ref)
    active = {f.rule for f in port if f.suppressed is None}
    assert active == ({rule} if rule else set())
    if name == "shared-cache-waived":
        assert any(f.suppressed for f in port)


FLAKE_FIXTURES = [
    ("unused-import", "import os\nx = 1\n", True),
    ("type-checking-and-try", "from typing import TYPE_CHECKING\n"
     "if TYPE_CHECKING:\n    from volcano_tpu.framework.session import "
     "Session\ntry:\n    import optional_dep\nexcept ImportError:\n"
     "    optional_dep = None\n", False),
    ("syntax-error", "def broken(:\n", True),
]


@pytest.mark.parametrize("name,src,fires", FLAKE_FIXTURES,
                         ids=[f[0] for f in FLAKE_FIXTURES])
def test_flakes_fixture_same_findings(name, src, fires):
    ref = REF["flakes"].check_source(src, "volcano_tpu/x.py")
    port = PORT["flakes"].check_source(
        RENAME.sub("volcano_tpu_torch", src), "volcano_tpu_torch/x.py")
    assert _key(port) == _key(ref)
    assert bool([f for f in port if f.rule != "unused-import"
                 or "optional_dep" not in f.msg]) == fires


# generation values: the reference's TPU generation, the port's GPU one
SCHEMA_FIXTURES = [
    ("undeclared-family", "bogus_family_total 1\n", True),
    ("undeclared-key", 'elastic_decisions_total{job="ns/j"} 1\n', True),
    ("out-of-enum", 'elastic_decisions_total{kind="explode"} 1\n', True),
    ("happy", 'elastic_decisions_total{kind="grow"} 1\n'
     'frag_index{generation="GEN"} 0.25\ngoodput_jobs 3\n', False),
]


@pytest.mark.parametrize("name,text,fires", SCHEMA_FIXTURES,
                         ids=[f[0] for f in SCHEMA_FIXTURES])
def test_schema_fixture_same_violations(name, text, fires):
    ref = REF["schema"].check_exposition(text.replace("GEN", "v5e"))
    port = PORT["schema"].check_exposition(text.replace("GEN", "h100"))
    assert [v.replace("h100", "v5e") for v in port] == ref
    assert bool(port) == fires
    # a TPU generation is out of the port's enum
    if name == "happy":
        assert PORT["schema"].check_exposition(text.replace("GEN", "v5e"))


def test_lintcache_roundtrip_and_invalidation(tmp_path):
    import time as _time
    from volcano_tpu_torch.analysis.lintcache import LintCache
    src = tmp_path / "volcano_tpu_torch"
    src.mkdir()
    f = src / "mod.py"
    f.write_text("import os\nx = 1\n")
    cache = LintCache(REPO, cache_dir=str(tmp_path / ".c"))
    findings = flakes.check_source(f.read_text(), str(f))
    assert findings
    cache.put_file("flakes", str(f), findings)
    cache.save()
    reloaded = LintCache(REPO, cache_dir=str(tmp_path / ".c"))
    hit = reloaded.get_file("flakes", str(f))
    assert [(x.rule, x.line) for x in hit] == \
        [(x.rule, x.line) for x in findings]
    _time.sleep(0.01)
    f.write_text("import os\nimport sys\nx = 1\n")
    assert reloaded.get_file("flakes", str(f)) is None
    # the toolchain digest stats the port's own entry point
    from volcano_tpu_torch.analysis import lintcache
    assert "volcano_tpu_torch/analysis/vtplint.py" in lintcache._TOOLCHAIN
    assert not [p for p in lintcache._TOOLCHAIN if p.startswith("tools/")]


# -- 3. live expositions of the port against the schema -------------------

def _assert_declared(dumped):
    """Every series of the exposition belongs to a declared family (a
    histogram's as its _count and _sum)."""
    from volcano_tpu_torch.bundle import FAMILIES
    names = {line.split("{")[0].split(" ")[0]
             for line in dumped.splitlines() if line and line[0] != "#"}
    assert names
    undeclared = {n for n in names if n not in FAMILIES and
                  FAMILIES.get(re.sub(r"_(count|sum)$", "", n)) !=
                  "histogram"}
    assert not undeclared, sorted(undeclared)


def test_live_exposition_honours_label_schema():
    """The reference's scheduler drive on the GPU mirror: a stuck gang,
    an elastic torch gang that grows into the idle NVLink domain, a
    goodput report of an h100 job."""
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api.devices.gpu.topology import DomainTopology
    from volcano_tpu_torch.api.pod import make_pod
    from volcano_tpu_torch.api.resource import GPU
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.controllers.hypernode import HyperNodeController
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import domain_nodes
    from volcano_tpu_torch.uthelper import gang_job
    from volcano_tpu_torch.webhooks import default_admission

    conf = {
        "actions": "enqueue, allocate, elastic, backfill",
        "tiers": [
            {"plugins": [{"name": "priority"}, {"name": "gang"},
                         {"name": "failover"}, {"name": "elastic"},
                         {"name": "conformance"}]},
            {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                         {"name": "predicates"},
                         {"name": "proportion"},
                         {"name": "nodeorder"}, {"name": "binpack"}]},
        ],
        "configurations": {"elastic": {"elastic.cooldownSeconds": 0}},
    }
    cluster = FakeCluster()
    for name in ("sa", "sb"):
        for node in domain_nodes(DomainTopology(name, H100, 4, 4)):
            cluster.add_node(node)
    hnc = HyperNodeController()
    hnc.initialize(cluster)
    hnc.sync()
    cluster.admission = default_admission()
    pg, pods = gang_job("stuck", replicas=2, requests={"cpu": 1})
    for p in pods:
        p.node_selector = {"zone": "nowhere"}
    cluster.add_podgroup(pg)
    for p in pods:
        cluster.add_pod(p)
    cluster.add_vcjob(VCJob(
        name="etrain", min_available=4,
        annotations={eapi.ELASTIC_MIN_SLICES_ANNOTATION: "1",
                     eapi.ELASTIC_MAX_SLICES_ANNOTATION: "2",
                     eapi.ELASTIC_SLICES_ANNOTATION: "1"},
        plugins={"torch": []},
        tasks=[TaskSpec(name="worker", replicas=4, template=make_pod(
            "t", requests={"cpu": 8, GPU: 4}))]))
    cluster.put_object("goodputreport", gapi.GoodputReport(
        node="sa-w0", ts=1.0, usages=[gapi.PodGoodput(
            pod_key="default/p", uid="u1", job="default/etrain",
            generation="h100", step=10, steps_per_s=2.0,
            allocated_s=1.0, productive_s=1.0)]))
    mgr = ControllerManager(cluster, enabled=[
        "job", "podgroup", "queue", "failover", "elastic"])
    sched = Scheduler(cluster, conf=conf, schedule_period=0)
    try:
        for _ in range(12):
            mgr.sync_all()
            sched.run_once()
            cluster.tick()
    finally:
        mgr.stop()
    metrics.inc("goodput_gated_grows_total", decision="declined")
    dumped = metrics.dump()
    for prefix in ("sched_span_seconds", "sched_phase_seconds",
                   "sched_unschedulable_reasons_total",
                   "elastic_decisions_total", "frag_index",
                   "action_latency_seconds", "queue_share"):
        assert any(line.startswith(prefix)
                   for line in dumped.splitlines()), prefix
    assert 'generation="h100"' in dumped
    violations = check_exposition(dumped)
    assert not violations, "\n".join(violations)
    _assert_declared(dumped)
    for line in dumped.splitlines():
        if line.startswith(("sched_", "elastic_", "goodput_",
                            "frag_", "starvation_")):
            assert "etrain" not in line and "sa-w0" not in line, line


class _Mirror:
    """An always-fresh mirror over an in-process cluster."""

    def __init__(self, cluster):
        self.cluster = cluster

    def age_s(self):
        return 0.1

    def read_checked(self, max_age_s=None):
        return self.cluster

    def stop(self):
        pass


def test_live_exposition_federation_plane():
    """The reference's two-region router drive on GPU regions: the
    fleet observability families validated wholesale, episode ids never
    in the exposition."""
    from volcano_tpu_torch.api import federation as fedapi
    from volcano_tpu_torch.api.pod import Container, Pod
    from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.federation.retry import (BREAKER_THRESHOLD,
                                                    FedRPCError)
    from volcano_tpu_torch.federation.router import FederationRouter

    def scrape(attainment):
        return "\n".join([
            f"serving_slo_attainment_min {attainment}",
            "e2e_scheduling_latency_seconds_count 10",
            "e2e_scheduling_latency_seconds_sum 4.0",
            'failover_mttr_seconds_count{slice="s0"} 2',
            'failover_mttr_seconds_sum{slice="s0"} 100.0',
            "not_a_registered_family_total 7", ""])

    g = FakeCluster()
    t = [1000.0]
    router = FederationRouter(g, now=lambda: t[0], start_mirrors=False)
    texts = {"ra": scrape(0.999), "rb": scrape(0.42)}
    router._rollup_fetch = (lambda url, token="", timeout=None:
                            texts[url.rsplit("/", 1)[-1]])
    for name in ("ra", "rb"):
        rc = FakeCluster()
        router.attach_region(
            fedapi.region_record(name, f"fake://{name}",
                                 metrics_url=f"fake://metrics/{name}"),
            client=rc, mirror=_Mirror(rc))
    job = VCJob(name="fedjob", min_available=1,
                tasks=[TaskSpec(name="w", replicas=1, template=Pod(
                    name="w", containers=[Container(
                        requests={"cpu": 1})]))])
    g.add_vcjob(job)
    for _ in range(3):
        router.sync()
        t[0] += 5.0
    episode = fedapi.episode_of(g.vcjobs[job.key])
    assert episode and episode in g.fleet_traces

    def boom():
        raise ConnectionError("partition")
    for _ in range(BREAKER_THRESHOLD):
        with pytest.raises(FedRPCError):
            router.rpc.call("rb", "add_vcjob", boom)
    router._gauges()
    dumped = metrics.dump()
    for prefix in ("federation_mirror_staleness_seconds",
                   "federation_router_breaker_failures",
                   "federation_rollup_sum", "slo_burn_rate",
                   "federation_stitched_traces_total",
                   "federation_region_capacity_chips"):
        assert any(line.startswith(prefix)
                   for line in dumped.splitlines()), prefix
    violations = check_exposition(dumped)
    assert not violations, "\n".join(violations)
    _assert_declared(dumped)
    assert "ep-" not in dumped and "fedjob" not in dumped

"""The port's control plane is the reference's, copied, with a GPU layer
in place of the TPU one.

Every module of the slice exists under `volcano_tpu_torch/` at its
mirrored path.  A module not in `GPU_LAYER` must equal the reference's
file after one rename, `volcano_tpu` -> `volcano_tpu_torch` (imports,
dotted paths and paths in comments), so review stays on the GPU layer
and any drift shows here.  A module in `GPU_LAYER` (or in `WORDING`,
a comment reworded) must differ, with its reason beside it.  The copied set is closed: every
`volcano_tpu_torch.*` import in it names a module that exists.  The
default conf names only registered actions and plugins, and each
control plane keeps its own registries.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF, PORT = REPO / "volcano_tpu", REPO / "volcano_tpu_torch"
RENAME = re.compile(r"\bvolcano_tpu\b")

# the modules of the scheduling path, as dotted paths under the package
SLICE = """
__init__ util metrics trace features goodput metrics_source conf
scheduler shardmap simulator
api.__init__ api.fit_error api.resource api.types api.pod api.podgroup
api.queue api.queue_info api.vcjob api.job_info api.node_info
api.hypernode api.goodput api.serving api.elastic api.slicehealth
api.shard api.federation api.netusage api.devices.__init__
cache.__init__ cache.cache cache.cluster cache.fake_cluster cache.kinds
framework.__init__ framework.framework framework.job_updater
framework.plugins framework.session framework.statement
analysis.__init__ analysis.freezeaudit analysis.lockaudit
actions.__init__ actions.enqueue actions.allocate actions.elastic
actions.backfill actions.util actions.sweep actions.topology_alloc
actions.gangcommit actions.procpool
plugins.__init__ plugins.priority plugins.gang plugins.failover
plugins.elastic plugins.conformance plugins.overcommit plugins.drf
plugins.predicates plugins.interpodaffinity plugins.volumebinding
plugins.deviceshare plugins.proportion plugins.nodeorder plugins.binpack
plugins.topology
controllers.__init__ controllers.framework controllers.queue
controllers.podgroup controllers.hypernode controllers.sharding
controllers.cronjob controllers.job.__init__ controllers.job.controller
controllers.job.plugins.__init__ controllers.job.plugins.env
controllers.job.plugins.svc controllers.job.plugins.ssh
controllers.job.plugins.mpi controllers.job.plugins.pytorch
controllers.job.plugins.tensorflow controllers.job.plugins.ray
controllers.job.plugins.util
webhooks.__init__ webhooks.admission
agent.__init__ agent.agent agent.framework agent.collect agent.handlers
agent.enforcer
api.jobflow api.numatopology controllers.hyperjob api.codec faults
server.tlsutil server.httputil server.durability server.replication
server.state_server server.__init__ server.audit_exporter
webhooks.server server.__main__ cache.remote_cluster cache.partitioned
leaderelection dumper agentscheduler __main__
uthelper actions.bundle actions.preempt actions.reclaim actions.gangpreempt
actions.shuffle plugins.capacity plugins.sla plugins.pdb plugins.cdp
plugins.tdm plugins.nodegroup plugins.usage plugins.resourcequota
plugins.tasktopology plugins.extender plugins.datalocality plugins.dra
plugins.serving plugins.numa_policy plugins.resource_strategy_fit
plugins.numaaware plugins.rescheduling controllers.elastic
controllers.failover controllers.serving controllers.jobflow
controllers.colocation controllers.garbagecollector
cli.__init__ cli.manifest cli.vtpctl bundle
analysis.astlint analysis.flakes analysis.lintcache analysis.racecheck
analysis.registry analysis.schema
federation.__init__ federation.retry federation.ha federation.mirror
federation.stitch federation.slo federation.router
""".split()

# the port's own modules, counterparts of reference modules of other names
NEW = {
    "api.devices.gpu.__init__": "api.devices.tpu.__init__",
    "api.devices.gpu.topology": "api.devices.tpu.topology",
    "api.devices.gpu.device_info": "api.devices.tpu.device_info",
    "controllers.job.plugins.torch_plugin":
        "controllers.job.plugins.jax_plugin",
}

# the port's own modules whose counterparts live outside the reference
# package, by their path in the repo
NEW_OUTSIDE = {
    "analysis.vtplint": "tools/vtplint.py",
    "tools.__init__": "tools/__init__.py",
    "tools.chaoslib": "tools/chaoslib.py",
    "tools.chaos_conductor": "tools/chaos_conductor.py",
    "tools.chaos": "tools/chaos.py",
    "tools.chaos_leader": "tools/chaos_leader.py",
    "tools.chaos_partition": "tools/chaos_partition.py",
    "tools.soak": "tools/soak.py",
    "tools.trace_report": "tools/trace_report.py",
    "tools.race_bench": "tools/race_bench.py",
    "tools.fuzz_sweep": "tools/fuzz_sweep.py",
    "tools.fedfleet": "bench.py",
    "tools.churn": "tests/test_fuzz_scheduler.py",
    "bench": "bench.py",
    "tools.gpu_watch": "tools/tpu_watch.py",
}

# a reference tool becomes its port under these renames: the package,
# the tools' own package (imports, paths and usage lines) and the repo
# root, one directory further up
TOOL_RENAMES = (
    (r"\bvolcano_tpu\b", "volcano_tpu_torch"),
    (r"python tools/(\w+)\.py", r"python -m volcano_tpu_torch.tools.\1"),
    (r"\btools/(\w+)\.py", r"volcano_tpu_torch/tools/\1.py"),
    (r"\bfrom tools import\b", "from volcano_tpu_torch.tools import"),
    (r"os\.path\.dirname\(os\.path\.dirname\((\s*)"
     r"os\.path\.abspath\(__file__\)\)\)",
     r"os.path.dirname(os.path.dirname(os.path.dirname(\1"
     r"os.path.abspath(__file__))))"),
)

# bench.py sits at the repo root, its port one directory further down:
# its usage lines and its repo-root path, after TOOL_RENAMES
BENCH_RENAMES = (
    (r"python bench\.py", "python -m volcano_tpu_torch.bench"),
    (r"os\.path\.dirname\(os\.path\.abspath\(__file__\)\)",
     "os.path.dirname(os.path.dirname(os.path.abspath(__file__)))"),
)

# NEW_OUTSIDE module -> why it differs from its counterpart after the
# renames (a tool missing here must equal its reference tool)
OUTSIDE_CHANGES = {
    "analysis.vtplint": "the linter's entry point over the port's tree",
    "tools.__init__": "the package's docstring",
    "tools.chaoslib": "the chaos gang asks nvidia.com/gpu and the torch "
                      "plugin, its units are NVLink domains of 4 hosts x "
                      "4 GPUs (`domain`), the overcommit audit counts "
                      "GPUs; the zoo tells a process that died on its "
                      "own from one a drill killed (`died`); no "
                      "JAX_PLATFORMS in the plane's env",
    "tools.chaos_conductor": "the long elastic and serving gangs ask "
                             "nvidia.com/gpu and the torch plugin; the "
                             "federation classes run on fedfleet, not "
                             "bench.py; the read-QPS row seeds an NVLink "
                             "domain; every result names the processes "
                             "that died on their own (dead_processes); "
                             "logs under the temp dir; no change number "
                             "in a help text",
    "tools.chaos": "logs under the temp dir; no result of the "
                   "reference's machine in the docstring",
    "tools.chaos_leader": "logs under the temp dir; no result of the "
                          "reference's machine in the docstring",
    "tools.chaos_partition": "logs under the temp dir; no change "
                             "number in the docstring",
    "tools.soak": "NVLink domains, gangs in nvidia.com/gpu with the "
                  "torch plugin; logs under the temp dir; no result "
                  "of the reference's machine or issue number in the "
                  "docstring",
    "tools.race_bench": "make_gpu_cluster of HGX H100 hosts, a pod "
                        "takes a host's 8 GPUs; the static pass over "
                        "the port's package; the report in the temp "
                        "dir by default (not over the reference's "
                        "artifact); no issue number in the docstring",
    "tools.fuzz_sweep": "the episode from tools.churn, not tests/",
    "tools.fedfleet": "bench.py's federation fleet and its helpers "
                      "alone, with the GPU layer; the fleet names the "
                      "processes that died on their own (`died`); "
                      "`fed_stamp_and_fold` waits for the region's "
                      "mirror to show the copy the global record says "
                      "runs there (fault: the conductor's router run "
                      "failed when that mirror trailed)",
    "tools.churn": "the reference test's churn_episode and its "
                   "invariants alone, on the mirrored GPU cluster",
    "bench": "the scenarios' TPU slices are NVLink domains of HGX H100 "
             "hosts (8 GPUs a host, so every chip count doubles; "
             "`domain_for`, `make_domain_cluster`), pods ask "
             "nvidia.com/gpu with the torch plugin, the clique label in "
             "place of the slice label, h100 and h200 as the goodput "
             "rows' two generations, no JAX env for the plane's "
             "processes; the federation fleet and its helpers from "
             "tools.fedfleet; the device children rewritten for the card "
             "on CUDA events (the flash child times the port's three "
             "kernels with the plain version and SDPA beside them, the "
             "train child the six-point sweep, the elastic child runs on "
             "8 then 4 gloo ranks with DCP); the card's PEAKS in place "
             "of TPU_PEAK_FLOPS; renamed keys: the metric "
             "p50_gang_allocate_latency_256host_v5p1024 -> "
             "..._256host_h100_256x8, chip_utilization_under_contention "
             "-> gpu_utilization_under_contention, tpu_probe, "
             "flash_attention_tpu, train_step_tpu -> gpu_probe, "
             "flash_attention_gpu, train_step_gpu, tpu_available -> "
             "gpu_available, pallas_* -> kernel_*, jnp_* -> plain_*, "
             "ici_adjacent_ok and victim_ici_adjacent_all -> "
             "nvlink_adjacent_ok and victim_nvlink_adjacent_all, "
             "decision_to_chips_free_s -> decision_to_gpus_free_s; the "
             "last_known_good substitution dropped (a failed probe "
             "leaves its error in the device rows and main exits 1); "
             "two lint findings of the port's linter repaired; no "
             "change-tracking or artifact numbers in docstrings and "
             "comments",
    "tools.gpu_watch": "probes the card and runs the port bench's "
                       "children as modules; names the card and its "
                       "power limit as nvidia-smi gives them; writes "
                       "build/GPU_RESULTS.json or --out, never the repo "
                       "root; the bench never reads it in place of a "
                       "live run; no round numbers in the docstring",
}

# module -> why it differs from the reference beyond the rename
GPU_LAYER = {
    "__init__": "the port's docstring (workloads and control plane) "
                "with the reference's audit arming",
    "trace": "pending-reason slugs gpu-/nvlink-shape-mismatch",
    "features": "GPUDeviceAtomicity gate in place of TPUDeviceAtomicity",
    "goodput": "fragmentation over NVLink domains and IB fabrics, "
               "counted in nvidia.com/gpu",
    "shardmap": "the partition key is the NVLink domain label",
    "simulator": "make_gpu_cluster/domain_nodes with GPU labels in "
                 "place of make_tpu_cluster/slice_nodes",
    "api.__init__": "exports GPU in place of TPU",
    "api.resource": "GPU = nvidia.com/gpu and Resource.gpu",
    "api.types": "GPU Feature Discovery and NVLink-domain labels in "
                 "place of the GKE TPU labels",
    "api.podgroup": "docstring: tiers are NVLink domain and IB fabric",
    "api.vcjob": "comment: GPU requests default to NVLink-local hard",
    "api.job_info": "docstring: a subgroup lands in one NVLink domain",
    "api.node_info": "NVLink domain, shape and host index in place of "
                     "slice, topology, worker id and ICI coordinates",
    "api.hypernode": "docstring: tier 1 is an NVLink domain",
    "api.goodput": "GPU generations derived from nvidia.com/gpu.product",
    "api.serving": "comment: the torch plugin injects the stats env",
    "api.elastic": "docstring: the torch plugin, slices are NVLink "
                   "domains",
    "api.slicehealth": "docstring and field comment: GpuHealthHandler, "
                       "keyed by NVLink domain",
    "api.devices.__init__": "imports GPUDevices in place of TPUDevices",
    "cache.cache": "registers the gpu device in place of tpu",
    "cache.fake_cluster": "a podgroup status flush keeps the serving "
                          "fold's monotone ledgers, as a put does "
                          "(fault: a stale flush rewound the serving "
                          "request ledger); a keyed vcjob put (the "
                          "wire's update) of a deleted job raises "
                          "KeyError, 404 over the wire (fault: a stale "
                          "status flush re-created a migrated job in "
                          "its source region, ROADMAP C.15)",
    "actions.elastic": "slices are NVLink domains in IB fabrics, counted "
                       "in nvidia.com/gpu",
    "actions.topology_alloc": "docstring: NVLink/IB tiers",
    "plugins.failover": "warm spares keyed by NVLink domain and shape",
    "plugins.elastic": "avoid filter keyed by NVLink domain",
    "plugins.deviceshare": "deviceshare.gpu.weight",
    "plugins.binpack": "nvidia.com/gpu weighted in place of TPU chips",
    "plugins.topology": "domain fractions counted in nvidia.com/gpu",
    "controllers.hypernode": "nvlink-domain and ib-fabric tiers from the "
                             "clique and fabric labels and from "
                             "nvlink/ib fabric records",
    "controllers.sharding": "batch keeps the NVLink-domain hosts",
    "controllers.job.controller": "GPU requests default a subgroup to "
                                  "NVLink-local hard topology; a sync "
                                  "stops for a job deleted since its "
                                  "snapshot and makes it no podgroup "
                                  "(ROADMAP C.15: the new podgroup "
                                  "lacked the evacuation hold)",
    "controllers.job.plugins.__init__": "loads the torch plugin in place "
                                        "of jax",
    "webhooks.admission": "elastic divisibility over nvidia.com/gpu "
                          "workers",
    "agent.agent": "gpu-healthy label, gpu-chips annotation and "
                   "gpu_chips_* usage fields",
    "agent.collect": "GpuChipCollector (/dev/nvidia[0-9]*) registered as "
                     "gpu in place of TpuChipCollector",
    "agent.handlers": "GpuHealthHandler in place of TpuHealthHandler",
    "api.numatopology": "nvidia.com/gpu per NUMA cell; "
                        "gpu_host_numatopology (HGX: 2 cells of 4 GPUs) "
                        "in place of tpu_host_numatopology",
    "controllers.hyperjob": "splits count nvidia.com/gpu; members are "
                            "forwarded to IB fabrics by the ib-fabric "
                            "label in place of the DCN-pod label",
    "server.state_server": "the bind/put overcommit guard counts "
                           "nvidia.com/gpu in place of google.com/tpu; "
                           "no change number in a comment; a TLS "
                           "replica's own URL says https (fault: its "
                           "leader hints sent clients to plain HTTP)",
    "agentscheduler": "the fast path's device filter and score read the "
                      "gpu device in place of tpu",
    "__main__": "--usage-source names the gpu collector; SIGTERM "
                "closes the cluster client, so a client retrying "
                "against a dead server stops (fault: it outlived "
                "SIGTERM); --enforcer record logs its ledger at exit "
                "(it lived only in the daemon's memory)",
    "cache.remote_cluster": "the retry back-off waits on the client's "
                            "stop event, so close() ends a call that "
                            "is retrying against a dead server (fault: "
                            "it slept its whole retry budget); a watch "
                            "whose replica fails asks the next one "
                            "(fault: the mirror stayed on a dead "
                            "replica)",
    "server.replication": "promote bumps the epoch before it publishes "
                          "the leader role, and refuses votes in "
                          "between as a leader does (fault: a reader "
                          "saw role == leader with the old epoch); a "
                          "caught-up follower's lag is the age of its "
                          "last proof (fault: it claimed 0 while its "
                          "next poll stalled on a dead link); no "
                          "change numbers for the WAL and the chaos "
                          "engine",
    "uthelper": "comment: a prebuilt cluster from "
                "simulator.make_gpu_cluster",
    "plugins.resource_strategy_fit": "the default packs nvidia.com/gpu "
                                     "(MostAllocated, weight 2)",
    "plugins.numaaware": "nvidia.com/gpu per NUMA cell against the GPU "
                         "cells of api.numatopology; the legacy "
                         "annotation's key is gpu",
    "plugins.rescheduling": "the gpuFragmentation strategy "
                            "consolidates sub-host GPU packs",
    "controllers.elastic": "resizes the specs that request "
                           "nvidia.com/gpu; no change number in the "
                           "docstring",
    "controllers.failover": "the failure unit is the NVLink domain "
                            "(GPU_CLIQUE_LABEL); docstring: "
                            "GpuHealthHandler and the worker's DCP "
                            "resume",
    "controllers.serving": "the pool is the NVLink domains "
                           "(GPU_CLIQUE_LABEL) of the replicas",
    "cli.manifest": "docstring: the example requests nvidia.com/gpu "
                    "with the torch plugin",
    "cli.vtpctl": "init provisions NVLink domains into an IB fabric "
                  "(--ib-fabric); --gpu requests nvidia.com/gpu; node "
                  "list, slices, elastic, fleet, failover and regions "
                  "read the GPU labels, reasons and counts",
    "bundle": "--topology takes NVLink domains and their IB fabrics; "
              "cluster-init.sh runs the port's vtpctl once a fabric; "
              "the roles run the port's modules with the gpu "
              "collector; NVLink and GPU panel titles; no change "
              "number in a comment",
    "analysis.lintcache": "a cache directory of its own, and the "
                          "port's vtplint entry point in the "
                          "toolchain digest; no change numbers in the "
                          "docstring",
    "federation.router": "a gang's demand, a region's capacity and "
                         "idle GPUs and its generation counted in "
                         "nvidia.com/gpu; the h100/h200 example",
}


# module -> the comment it rewords (a reference note naming the change
# that introduced a feature), with no GPU change
WORDING = {
    "actions.procpool": "docstring: no change number for the thread "
                        "backend",
    "actions.sweep": "docstring: no change number for the thread pilot",
    "cache.partitioned": "docstring: no change number for replication",
    "faults": "docstring: no change number for the WAL",
    "analysis.astlint": "docstring: no change numbers for the req-id "
                        "rule",
    "federation.mirror": "docstring: no issue or change number",
    "federation.slo": "docstring: no change numbers for the three SLOs",
}


def _path(root, module):
    return root / (module.replace(".", "/") + ".py")


def test_gpu_layer_names_slice_modules():
    assert set(GPU_LAYER) | set(WORDING) <= set(SLICE)
    assert not set(GPU_LAYER) & set(WORDING)
    assert all(GPU_LAYER.values()) and all(WORDING.values())


@pytest.mark.parametrize("module", SLICE + sorted(NEW) + sorted(NEW_OUTSIDE))
def test_module_is_ported(module):
    assert _path(PORT, module).is_file(), module


@pytest.mark.parametrize("module", [m for m in SLICE
                                    if m not in GPU_LAYER | WORDING])
def test_copy_equals_reference_after_rename(module):
    want = RENAME.sub("volcano_tpu_torch", _path(REF, module).read_text())
    assert _path(PORT, module).read_text() == want, \
        f"{module} drifted from the reference (or belongs in GPU_LAYER)"


@pytest.mark.parametrize("module", sorted(GPU_LAYER) + sorted(WORDING)
                         + sorted(NEW))
def test_gpu_layer_module_differs(module):
    ref = _path(REF, NEW.get(module, module))
    want = RENAME.sub("volcano_tpu_torch", ref.read_text())
    assert _path(PORT, module).read_text() != want, \
        f"{module} equals the reference: drop it from GPU_LAYER/WORDING"


def _tool_renamed(text, extra=()):
    for pattern, repl in TOOL_RENAMES + tuple(extra):
        text = re.sub(pattern, repl, text)
    return text


def _counterpart(module):
    """The module's counterpart after its renames."""
    return _tool_renamed((REPO / NEW_OUTSIDE[module]).read_text(),
                         BENCH_RENAMES if module == "bench" else ())


def test_outside_changes_name_outside_modules():
    assert set(OUTSIDE_CHANGES) <= set(NEW_OUTSIDE)
    assert all(OUTSIDE_CHANGES.values())


@pytest.mark.parametrize("module", sorted(OUTSIDE_CHANGES))
def test_new_module_differs_from_its_counterpart(module):
    want = _counterpart(module)
    assert _path(PORT, module).read_text() != want, \
        f"{module} equals its counterpart: drop it from OUTSIDE_CHANGES"


@pytest.mark.parametrize("module", sorted(set(NEW_OUTSIDE)
                                          - set(OUTSIDE_CHANGES)))
def test_tool_equals_reference_after_rename(module):
    want = _counterpart(module)
    assert _path(PORT, module).read_text() == want, \
        f"{module} drifted from its reference tool (or belongs in " \
        "OUTSIDE_CHANGES)"


def test_tool_rename_maps_paths_and_imports():
    text = ("from tools import chaoslib\n"
            "python tools/chaos.py; see tools/soak.py and volcano_tpu/x\n"
            "REPO = os.path.dirname(os.path.dirname(\n"
            "    os.path.abspath(__file__)))\n")
    assert _tool_renamed(text) == (
        "from volcano_tpu_torch.tools import chaoslib\n"
        "python -m volcano_tpu_torch.tools.chaos; see "
        "volcano_tpu_torch/tools/soak.py and volcano_tpu_torch/x\n"
        "REPO = os.path.dirname(os.path.dirname(os.path.dirname(\n"
        "    os.path.abspath(__file__))))\n")


def test_bench_rename_maps_usage_and_repo_root():
    text = ("    `python bench.py --scale-40k` regenerates it\n"
            "    repo = os.path.dirname(os.path.abspath(__file__))\n"
            "    from volcano_tpu.simulator import domain_nodes\n")
    assert _tool_renamed(text, BENCH_RENAMES) == (
        "    `python -m volcano_tpu_torch.bench --scale-40k` regenerates "
        "it\n"
        "    repo = os.path.dirname(os.path.dirname("
        "os.path.abspath(__file__)))\n"
        "    from volcano_tpu_torch.simulator import domain_nodes\n")


def test_bench_differs_only_beside_the_gpu_layer():
    """Every scenario of the reference's bench is in the port's under
    its name, and the port's lines are the reference's after the
    renames but for a share: the GPU layer and the device children."""
    import difflib
    ref = _counterpart("bench").splitlines()
    port = _path(PORT, "bench").read_text().splitlines()
    names = {n.name for n in ast.parse("\n".join(ref)).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    port_names = {n.name for n in ast.parse("\n".join(port)).body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    # the fleet is fedfleet's; the device rows' helpers took GPU names
    gone = {"_FederationFleet", "_fed_job", "_fed_view", "_fed_running",
            "_fed_stamp_steps", "_fed_stamp_and_fold", "_fed_folded_step",
            "_fed_copy_regions", "_fed_regions_ready", "_fed_dual_sampler",
            "bench_train_step_tpu", "bench_flash_attention_tpu",
            "run_tpu_benchmarks", "_last_known_good", "_tpu_subprocess"}
    assert names - port_names == gone
    same = sum(b.size for b in difflib.SequenceMatcher(
        None, ref, port, autojunk=False).get_matching_blocks())
    assert same / len(port) > 0.85, same / len(port)


def _control_plane_files():
    return [p for p in sorted(PORT.rglob("*.py"))
            if "workloads" not in p.parts and p.name != "entry.py"]


def _module_exists(dotted):
    rel = dotted.split(".")[1:]
    base = PORT.joinpath(*rel) if rel else PORT
    return base.with_suffix(".py").is_file() or \
        (base / "__init__.py").is_file()


def test_import_closure_is_closed():
    """Every volcano_tpu_torch import of the control plane, at module
    level or inside a function, names a module (or a name of a
    package) that exists."""
    missing = []
    for path in _control_plane_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.level == 0:
                names = [node.module]
                names += [f"{node.module}.{a.name}" for a in node.names
                          if _module_exists(f"{node.module}.{a.name}")]
            else:
                continue
            for name in names:
                if name.split(".")[0] == "volcano_tpu_torch" and \
                        not _module_exists(name):
                    missing.append(f"{path.relative_to(REPO)}: {name}")
    assert not missing, missing


def test_default_conf_names_only_registered_actions_and_plugins():
    from volcano_tpu_torch.conf import load_conf
    from volcano_tpu_torch.framework.plugins import (get_action,
                                                     get_plugin_builder)
    conf = load_conf()
    assert conf.actions == ["enqueue", "allocate", "elastic", "backfill"]
    assert all(get_action(a) is not None for a in conf.actions)
    assert all(get_plugin_builder(p) is not None
               for p in conf.plugin_names()), conf.plugin_names()


def test_registries_are_the_port_own():
    """Both control planes load in one process; neither sees the
    other's devices, job plugins, controllers, actions or plugins."""
    import volcano_tpu.actions  # noqa: F401
    import volcano_tpu.controllers  # noqa: F401
    import volcano_tpu.plugins  # noqa: F401
    import volcano_tpu_torch.actions  # noqa: F401
    import volcano_tpu_torch.controllers  # noqa: F401
    import volcano_tpu_torch.plugins  # noqa: F401
    from volcano_tpu.cache import cache as rcache
    from volcano_tpu.controllers import CONTROLLERS as RCONTROLLERS
    from volcano_tpu.controllers.job import plugins as rjp
    from volcano_tpu.framework import plugins as rplugins
    from volcano_tpu_torch.cache import cache as tcache
    from volcano_tpu_torch.controllers import CONTROLLERS as TCONTROLLERS
    from volcano_tpu_torch.controllers.job import plugins as tjp
    from volcano_tpu_torch.framework import plugins as tplugins
    assert set(tcache.REGISTERED_DEVICES) == {"gpu"}
    assert "tpu" in rcache.REGISTERED_DEVICES
    assert tjp.job_plugin_exists("torch") and not tjp.job_plugin_exists("jax")
    assert rjp.job_plugin_exists("jax") and not rjp.job_plugin_exists("torch")
    assert set(TCONTROLLERS) == {
        "job", "queue", "podgroup", "hypernode", "sharding", "cronjob",
        "hyperjob", "jobtemplate", "elastic", "failover", "jobflow",
        "serving", "colocationconfig", "garbagecollector"}
    assert set(TCONTROLLERS) == set(RCONTROLLERS)
    assert TCONTROLLERS is not RCONTROLLERS
    assert tplugins.ACTIONS is not rplugins.ACTIONS
    tplugins.get_action("enqueue")   # loads the port's registrations
    assert set(tplugins.ACTIONS) == {
        "enqueue", "allocate", "elastic", "backfill", "preempt", "reclaim",
        "gangpreempt", "gangreclaim", "shuffle"}
    assert set(tplugins.ACTIONS) == set(rplugins.ACTIONS)
    assert tplugins.PLUGIN_BUILDERS is not rplugins.PLUGIN_BUILDERS
    assert set(tplugins.PLUGIN_BUILDERS) == set(rplugins.PLUGIN_BUILDERS)

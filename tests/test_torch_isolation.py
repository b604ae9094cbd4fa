"""The port stands alone: nothing under volcano_tpu_torch/, nor
chip_smoke.py, imports jax, the libraries built on it (optax, orbax,
flax), the JAX package (volcano_tpu), or the repo's other top-level
code: the reference's tools, its bench and the tests."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "volcano_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


FORBIDDEN = ("jax", "optax", "orbax", "flax", "volcano_tpu", "tools",
             "bench", "tests")


def _forbidden(module: str) -> bool:
    # a forbidden package or anything under it, not a name that merely
    # shares the prefix (the port, `volcano_tpu_torch`)
    return any(module == root or module.startswith(root + ".")
               for root in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_forbidden_prefix_rule():
    assert _forbidden("volcano_tpu") and _forbidden("volcano_tpu.api")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint")
    assert _forbidden("flax.linen")
    assert not _forbidden("volcano_tpu_torch.workloads")
    assert not _forbidden("jaxlib_like")
    assert _forbidden("tools") and _forbidden("tools.chaoslib")
    assert _forbidden("bench") and _forbidden("tests.test_fuzz_scheduler")
    assert not _forbidden("volcano_tpu_torch.tools.chaoslib")
    assert not _forbidden("benchmark")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_bench_and_gpu_watch_are_scanned():
    """The port's bench harness and its capture daemon are among the
    files scanned above (the reference's bench.py and tools/ are not)."""
    names = {str(p.relative_to(REPO)) for p in FILES}
    assert {"volcano_tpu_torch/bench.py",
            "volcano_tpu_torch/tools/gpu_watch.py"} <= names
    assert "bench.py" not in names and "tools/tpu_watch.py" not in names


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import volcano_tpu_torch.workloads.serve\n"
            "import volcano_tpu_torch.workloads.model\n"
            "import volcano_tpu_torch.workloads.moe\n"
            "import volcano_tpu_torch.workloads.pipeline\n"
            "import volcano_tpu_torch.workloads.convert\n"
            "import volcano_tpu_torch.workloads.train\n"
            "import volcano_tpu_torch.workloads.bootstrap\n"
            "import volcano_tpu_torch.workloads.progress\n"
            "import volcano_tpu_torch.workloads.mesh\n"
            "import volcano_tpu_torch.workloads.checkpoint\n"
            "import volcano_tpu_torch.workloads.worker\n"
            "import volcano_tpu_torch.entry\n"
            f"roots = {FORBIDDEN!r}\n"
            "bad = [m for m in sys.modules if any(m == r or "
            "m.startswith(r + '.') for r in roots)]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_control_plane_loads_neither_torch_nor_jax():
    """A scheduler host needs no CUDA: the port's control plane imports
    no torch (nor jax, nor the reference)."""
    code = ("import sys\n"
            "import volcano_tpu_torch.scheduler\n"
            "import volcano_tpu_torch.simulator\n"
            "import volcano_tpu_torch.controllers.job.controller\n"
            "import volcano_tpu_torch.agent.handlers\n"
            "import volcano_tpu_torch.controllers\n"
            "import volcano_tpu_torch.webhooks.admission\n"
            "import volcano_tpu_torch.server\n"
            "import volcano_tpu_torch.cache.remote_cluster\n"
            "import volcano_tpu_torch.__main__\n"
            "import volcano_tpu_torch.uthelper\n"
            "import volcano_tpu_torch.actions\n"
            "import volcano_tpu_torch.actions.preempt\n"
            "import volcano_tpu_torch.actions.reclaim\n"
            "import volcano_tpu_torch.actions.gangpreempt\n"
            "import volcano_tpu_torch.actions.shuffle\n"
            "import volcano_tpu_torch.plugins\n"
            "import volcano_tpu_torch.plugins.numaaware\n"
            "import volcano_tpu_torch.plugins.rescheduling\n"
            "import volcano_tpu_torch.plugins.resource_strategy_fit\n"
            "import volcano_tpu_torch.plugins.dra\n"
            "import volcano_tpu_torch.controllers.elastic\n"
            "import volcano_tpu_torch.controllers.failover\n"
            "import volcano_tpu_torch.controllers.serving\n"
            "import volcano_tpu_torch.controllers.jobflow\n"
            "import volcano_tpu_torch.controllers.colocation\n"
            "import volcano_tpu_torch.controllers.garbagecollector\n"
            "import volcano_tpu_torch.cli.manifest\n"
            "import volcano_tpu_torch.cli.vtpctl\n"
            "import volcano_tpu_torch.bundle\n"
            "import volcano_tpu_torch.analysis.astlint\n"
            "import volcano_tpu_torch.analysis.flakes\n"
            "import volcano_tpu_torch.analysis.lintcache\n"
            "import volcano_tpu_torch.analysis.racecheck\n"
            "import volcano_tpu_torch.analysis.registry\n"
            "import volcano_tpu_torch.analysis.schema\n"
            "import volcano_tpu_torch.analysis.vtplint\n"
            "import volcano_tpu_torch.federation\n"
            "import volcano_tpu_torch.federation.router\n"
            "import volcano_tpu_torch.federation.slo\n"
            "import volcano_tpu_torch.tools.chaoslib\n"
            "import volcano_tpu_torch.tools.chaos_conductor\n"
            "import volcano_tpu_torch.tools.fedfleet\n"
            "import volcano_tpu_torch.tools.churn\n"
            "import volcano_tpu_torch.tools.trace_report\n"
            "import volcano_tpu_torch.tools.race_bench\n"
            "import volcano_tpu_torch.tools.gpu_watch\n"
            "import volcano_tpu_torch.bench\n"
            "import volcano_tpu_torch.workloads.progress\n"
            "from volcano_tpu_torch.analysis import registry\n"
            "assert not registry.check_all()\n"
            f"roots = {FORBIDDEN + ('torch',)!r}\n"
            "bad = [m for m in sys.modules if any(m == r or "
            "m.startswith(r + '.') for r in roots)]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"

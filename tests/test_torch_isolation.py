"""The port stands alone: nothing under volcano_tpu_torch/, nor
chip_smoke.py, imports jax or the JAX package (volcano_tpu)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "volcano_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # the module `volcano_tpu` or anything under `volcano_tpu.`, not the
    # port (`volcano_tpu_torch` shares the prefix)
    return module == "jax" or module.startswith("jax.") or \
        module == "volcano_tpu" or module.startswith("volcano_tpu.")


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
    assert not _forbidden("volcano_tpu_torch.workloads")
    assert not _forbidden("jaxlib_like")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import volcano_tpu_torch.workloads.serve\n"
            "import volcano_tpu_torch.workloads.model\n"
            "import volcano_tpu_torch.workloads.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'volcano_tpu' or "
            "m.startswith('volcano_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"

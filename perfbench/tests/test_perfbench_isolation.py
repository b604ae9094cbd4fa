"""No file of the benchmark imports JAX, the JAX package or the repo's
other harnesses, and the reference imports nothing of the program.
Module names are compared by their whole top-level name, so
`volcano_tpu_torch` is not `volcano_tpu`."""

import ast

import pytest

from perfbench.cells import PKG

FORBIDDEN = {"jax", "jaxlib", "flax", "volcano_tpu", "bench", "tools",
             "chip_smoke"}


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_imports(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & FORBIDDEN
    if path.parent.name == "reference":
        assert "volcano_tpu_torch" not in tops
        assert tops <= {"__future__", "math", "typing", "torch"}


def test_the_scan_sees_through_prefixes():
    names = {"volcano_tpu_torch.workloads.train", "volcano_tpu.api"}
    assert {n.split(".")[0] for n in names} & FORBIDDEN == {"volcano_tpu"}


def test_a_run_refuses_a_loaded_jax_module():
    from perfbench import harness
    assert harness.forbidden_modules({"volcano_tpu_torch": 1,
                                      "volcano_tpu_torch.x": 1}) == []
    assert harness.forbidden_modules({"jax.numpy": 1, "os": 1}) == ["jax"]

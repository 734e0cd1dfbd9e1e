"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (``blasr_tpu_torch`` begins with ``blasr_tpu``)."""

import ast

import pytest

from benchmark import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "blasr_tpu"}
MODULES = sorted(p for p in registry.ROOT.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_the_modules():
    rel = {str(p.relative_to(registry.ROOT)) for p in MODULES}
    assert {"run.py", "check.py", "reference/map_read.py",
            "metrics/device_idle_pct.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(registry.ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "blasr_tpu_torch" not in top_level_imports(path)
    # nor names it in code that could import it some other way
    code = "".join(line for line in path.read_text().splitlines(True)
                   if not line.lstrip().startswith("#"))
    assert "import_module" not in code and "__import__" not in code

"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `repro_torch` is the port, `repro` the JAX
package), none reads `benchmarks/`, and the references import nothing of
the port."""
import ast
from pathlib import Path

import pytest

from _cpu import CELLS, harness, smoke_run

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(harness.HERE.rglob("*.py"))


def _strings(path: Path):
    """String constants of the code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(body[0].value,
                                                  ast.Constant):
            docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def check_sources(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path != Path(__file__).resolve():
        assert not [t for t in _strings(path) if "benchmarks" in t]
    if "reference" in path.parts or path.name == "weights.py":
        assert "repro_torch" not in names


def check_loaded_after_a_run():
    smoke_run(CELLS[0])
    assert not harness.forbidden_loaded()

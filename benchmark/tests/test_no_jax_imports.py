"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "k8s_operator_libs_tpu"}
PORT = "k8s_operator_libs_tpu_torch"


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_top_level_imports(path)) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_level_imports(path))
    assert PORT not in names
    assert "benchmark" not in names  # nor the harness, which drives the port


def test_the_names_are_compared_whole():
    assert PORT.split(".")[0] not in BANNED
    assert PORT.startswith("k8s_operator_libs_tpu")

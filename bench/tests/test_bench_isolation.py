"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `repro_torch` begins with `repro`), and the
reference imports nothing of the port or of the harness."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".")[0] != "repro"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "dataclasses",
                                       "typing", "numpy", "torch"}

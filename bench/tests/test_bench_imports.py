"""Nothing under bench/ imports JAX or the JAX package ``repro``, compared by
top-level name as a whole word; the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

from bench import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = run.FORBIDDEN


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in imported(path), path
        assert not imported(path) & FORBIDDEN, path


def test_run_names_what_it_finds(monkeypatch):
    import sys
    import types

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("repro_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]

"""Nothing under bench_port/ imports JAX or the JAX package, and nothing
under bench_port/reference/ imports the program.  Each import's
top-level name (before the first dot) is compared whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "vfx_image_stitching_tpu"}
PROGRAM = "vfx_image_stitching_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_check_compares_whole_names():
    assert PROGRAM.split(".")[0] not in JAX_SIDE


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=str)
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=str)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert PROGRAM not in path.read_text()


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    import sys

    from bench_port import run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, PROGRAM, object())
    assert "vfx_image_stitching_tpu" not in run.forbidden_modules()

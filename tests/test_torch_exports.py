"""PyTorch port: every package re-exports the names of its JAX
counterpart's ``__all__``.

The JAX package's ``__init__`` files are parsed with ``ast`` (importing
the JAX package configures jax), and each name is imported from the
port's package at the same relative path.  The port's ``__all__`` lists
the same names in the same order.
"""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "vfx_image_stitching_tpu")


def _packages():
    out = []
    for root, _dirs, files in os.walk(JAX_PKG):
        if "__init__.py" in files:
            rel = os.path.relpath(root, JAX_PKG)
            out.append("" if rel == "." else rel.replace(os.sep, "."))
    return sorted(out)


def _jax_all(rel: str):
    path = os.path.join(JAX_PKG, *rel.split("."), "__init__.py") if rel else (
        os.path.join(JAX_PKG, "__init__.py"))
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


PACKAGES = [p for p in _packages() if _jax_all(p) is not None]


def test_every_jax_package_with_all_is_checked():
    assert len(PACKAGES) == 12
    assert {"", "parallel", "viz", "models.sift"} <= set(PACKAGES)


@pytest.mark.parametrize("rel", PACKAGES, ids=lambda r: r or "top")
def test_port_package_reexports_jax_all(rel):
    names = _jax_all(rel)
    mod = importlib.import_module(
        "vfx_image_stitching_tpu_torch" + ("." + rel if rel else ""))
    assert list(mod.__all__) == list(names)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, missing


def test_top_level_import_stays_light():
    """``import vfx_image_stitching_tpu_torch`` imports neither torch, nor
    the stitch pipeline, nor the JAX package; ``stitch_many`` stays
    lazy."""
    code = ("import sys, vfx_image_stitching_tpu_torch as p; "
            "print(sorted(m for m in ('torch', "
            "'vfx_image_stitching_tpu_torch.pipeline.multi', "
            "'vfx_image_stitching_tpu') if m in sys.modules)); "
            "print(callable(p.stitch_many))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def _imported_modules(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port and nothing in ``chip_smoke.py`` imports
    ``jax`` or the JAX package."""
    port = os.path.join(REPO, "vfx_image_stitching_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _d, fs in os.walk(port)
        for f in fs if f.endswith(".py")]
    assert len(files) > 50
    bad = [(f, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "vfx_image_stitching_tpu")]
    assert not bad, bad

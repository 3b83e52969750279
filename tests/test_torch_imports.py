"""The port imports torch and never jax: no module of ``pyamg_tpu_torch``
imports ``jax`` or the JAX-backed parts of ``pyamg_tpu`` (``engine``,
``sparse``, ``parallel``), directly or at run time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pyamg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pyamg_tpu.engine", "pyamg_tpu.sparse",
             "pyamg_tpu.parallel")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_a_forbidden_import(tmp_path):
    """The scan itself catches both import forms."""
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\n"
                 "from pyamg_tpu import sparse\n"
                 "from pyamg_tpu.gallery import poisson\n")
    assert [m for m in _imported_modules(p) if _forbidden(m)] == [
        "jax.numpy", "pyamg_tpu.sparse"]


def test_import_loads_no_jax():
    """Importing the port (and compiling nothing) leaves jax out of
    sys.modules, in a fresh interpreter."""
    code = ("import sys, pyamg_tpu_torch, pyamg_tpu_torch.convert, "
            "pyamg_tpu_torch.engine, pyamg_tpu_torch.sparse; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'pyamg_tpu.engine', 'pyamg_tpu.sparse', 'pyamg_tpu.parallel')));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

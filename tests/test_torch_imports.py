"""The port imports torch and never jax: no module of ``pyamg_tpu_torch``,
and not ``chip_smoke.py``, imports ``jax`` or anything of the JAX package
``pyamg_tpu`` (not even its host modules, which load no JAX), directly or
at run time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pyamg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pyamg_tpu")


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
    """``pyamg_tpu`` and its submodules; ``pyamg_tpu_torch`` is the port."""
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
                 "from pyamg_tpu.gallery import poisson\n"
                 "import pyamg_tpu_torch.gallery\n"
                 "from pyamg_tpu_torch import poisson\n")
    assert [m for m in _imported_modules(p) if _forbidden(m)] == [
        "jax.numpy", "pyamg_tpu", "pyamg_tpu.sparse", "pyamg_tpu.gallery",
        "pyamg_tpu.gallery.poisson"]


def test_import_loads_no_jax():
    """Importing the port, running its host SA setup with the compile to
    the (CPU) device, a batched solve and a W-cycle GMRES solve on it, the
    default smoother's (multicolour Gauss-Seidel) compile and W-cycle
    solve, its device-built setup with a batched solve, with Chebyshev
    smoothers, lane-aligned too (the
    interleaved route), a world-of-one gloo sharded solve of the
    host-built hierarchy, an unstructured setup with a solve, the
    classical (Ruge-Stüben) and AIR device setups with a solve each, the
    unstructured classical (Ruge-Stüben and AIR) setups with a solve
    each, and the block device setup of elasticity with a mixed solve and adaptive
    SA with a solve, the partitioned RS and block setups in the same world
    of one with a solve each, and the host Ruge-Stüben and rootnode setups
    with a solve each, in a fresh interpreter, leaves every
    ``jax*`` and ``pyamg_tpu*`` module (but the port's own) out of
    sys.modules.  The interpreter runs one intra-op thread (beside the
    other test workers, torch's default thread count oversubscribes the
    cores)."""
    code = ("import torch; torch.set_num_threads(1)\n"
            "import sys, numpy as np, pyamg_tpu_torch as pt, "
            "pyamg_tpu_torch.convert, pyamg_tpu_torch.engine, "
            "pyamg_tpu_torch.sparse\n"
            "A = pt.poisson((40, 40), format='csr')\n"
            "kw = dict(presmoother=('jacobi', {'omega': 4 / 3}), "
            "postsmoother=('jacobi', {'omega': 4 / 3}))\n"
            "ml = pt.smoothed_aggregation_solver(A, **kw)\n"
            "b = np.random.default_rng(0).random((A.shape[0], 2))\n"
            "dml = pt.as_device_solver(ml, device='cpu')\n"
            "dml.solve(b[:, 0], accel='cg'); dml.solve(b, accel='cg')\n"
            "dml.solve(b[:, 0], accel='gmres', cycle='W', restart=5)\n"
            "pt.as_device_solver(pt.smoothed_aggregation_solver(A), "
            "device='cpu').solve(b[:, 0], accel='cg', cycle='W')\n"
            "cheb = ('chebyshev', {'degree': 3})\n"
            "pt.device_sa_setup(A, grid=(40, 40), device='cpu', "
            "max_coarse=100, presmoother=cheb, postsmoother=cheb).solve("
            "b[:, 0], accel='cg')\n"
            "pt.initialize_distributed(device='cpu')\n"
            "mesh = pt.make_solver_mesh(device='cpu')\n"
            "pt.DeviceMultilevelSolver(pt.shard_hierarchy(dml.hierarchy, "
            "mesh)).solve(b[:, 0], accel='cg')\n"
            "pt.device_rs_setup(A, grid=(40, 40), device='cpu', "
            "max_coarse=100, mesh=mesh).solve(b[:, 0], accel='cg')\n"
            "Ap, Bp = pt.linear_elasticity((24, 24))\n"
            "pt.device_sa_setup_block(Ap, grid=(24, 23), B=Bp, device='cpu', "
            "max_coarse=120, mesh=mesh).solve(np.ones(Ap.shape[0]), "
            "accel='cg')\n"
            "pt.device_sa_setup(A, grid=(40, 40), device='cpu', "
            "max_coarse=100).solve(b, accel='cg')\n"
            "A2 = pt.poisson((24, 512), format='csr')\n"
            "pt.device_sa_setup(A2, grid=(24, 512), device='cpu', "
            "max_coarse=60, lane_align=True).solve(np.ones((A2.shape[0], 2)),"
            " accel='cg', tol=1e-5)\n"
            "V, E = pt.regular_triangle_mesh(30, 30)\n"
            "M = pt.gradgradform(V, E) + 1e-2 * __import__('scipy.sparse')"
            ".sparse.eye(900)\n"
            "pt.device_unstructured_sa_setup(M, device='cpu', max_coarse=50)"
            ".solve(np.ones(900), accel='cg', tol=1e-6)\n"
            "pt.device_rs_setup(A, grid=(40, 40), device='cpu', "
            "max_coarse=100).solve(b[:, 0], accel='cg')\n"
            "Aa, ba = pt.advection_2d((32, 32))\n"
            "pt.device_air_setup(Aa, grid=(32, 32), device='cpu', "
            "max_coarse=100).solve(ba, maxiter=3)\n"
            "pt.device_unstructured_rs_setup(M, device='cpu', "
            "max_coarse=50).solve(np.ones(900), accel='cg', tol=1e-6)\n"
            "pt.device_unstructured_air_setup(Aa, device='cpu', "
            "max_coarse=100).solve(ba, accel='fgmres', tol=1e-8)\n"
            "Ae, Be = pt.linear_elasticity((20, 20))\n"
            "pt.device_sa_setup_block(Ae, grid=(20, 19), B=Be, device='cpu', "
            "max_coarse=100, mixed_precision=True).solve(np.ones(Ae.shape[0])"
            ", accel='cg', precision='mixed')\n"
            "pt.device_adaptive_sa_setup(A, grid=(40, 40), device='cpu', "
            "max_coarse=100).solve(b[:, 0], accel='cg')\n"
            "pt.as_device_solver(pt.ruge_stuben_solver(A), device='cpu')"
            ".solve(b[:, 0], accel='gmres')\n"
            "pt.as_device_solver(pt.rootnode_solver(Ae, B=Be[:, :2], "
            "strength='symmetric'), device='cpu').solve("
            "np.ones(Ae.shape[0]), accel='cg')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyamg_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_the_card():
    """``device=None`` means the CUDA device: it raises where torch sees
    no GPU, and it never resolves to the CPU."""
    import torch

    from pyamg_tpu_torch.backend import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"

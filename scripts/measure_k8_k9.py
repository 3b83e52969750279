"""K8 and K9 on the card, beside a parent checkout's kernels.

K8 (``dia_spmm``, ``dia_spmm_scaled``, ``dia_spmm_add``) and K9
(``dia_jacobi_k``) put the lane on the grid (csrc/dia_k.cu::
dia_k_lane_kernel, ``sparse/dia.py::k8_plan``), or run the thread-per-row
kernel for a shape the plan refuses.  For each path shape, mode and dtype
this script:

- checks the bits: the lane kernel equal to the thread-per-row kernel and
  across two launches, and with ``--parent DIR`` to the kernel built from
  the checkout DIR (its own ``_build.py`` and C interface: one thread per
  row in 16-lane chunks); and its error against the plain twin;
- times it by CUDA events (``chip_smoke.py::time_ms``, 30 calls) in the
  order parent, change, change, parent (the best of each pair), beside the
  thread-per-row kernel, the plain twin, the library call where one
  computes the same function (``torch.sparse.mm`` of the CSR for the plain
  mode, ``torch.addmm`` for the add) and the bound (bytes once at 3.35
  TB/s);
- times the one-off variants of ``scripts/dia_k_variants.cu`` (one thread
  per row tuned; the lane on the grid with one row or 16 bytes of rows a
  thread and lanes fastest or in super tiles of 16 to 512 row blocks;
  every float32 X load 16 bytes wide, the misaligned ones picked from two
  aligned runs; staged bursts by bulk copies), each checked to give the
  same bits (the
  package's form is "lane grid pairs, super 128" in float32 and "lane
  grid 1 row" in float64).

Shapes (K = 8): the device-built 2048^2 hierarchy's levels 0 and 1 (A for
plain and Jacobi, S for add, St for scale; float32 and float64), the
host-built level 0 (A: plain and Jacobi, float32), the lane-aligned
hierarchy's level 1 (float32) and both hierarchies' float64 A64 (plain).
K10 (``dia_jacobi_zero_res_k``, the thread-per-row kernel) is timed at the
host-built level 0 beside its parent, to show it did not move.

With ``--solves`` (needs ``--parent``) it then times whole solves in four
child processes, parent, change, change, parent, each importing its own
tree: the device-built and host-built batched native solves (2048^2, K =
8, f32 CG to 1e-5) and the device-built batched mixed one (to 1e-8), median
of 3 walls with ``b`` on the card, with torch.profiler's busy share and
each K-lane kernel's time and launches over one solve.  The card's name
and power limit, then one JSON line, end the output.

    python scripts/measure_k8_k9.py [--parent DIR [--solves]]   # one GPU
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
if "--solves-of" in sys.argv:        # a child: the package of that tree
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--solves-of") + 1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LANES = 8
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
# mode -> (wrapper name, C mode, shared vectors, stacks) for the bound
MODES = {"plain": ("dia_spmm", 0, 0, 2), "scale": ("dia_spmm_scaled", 1, 1, 2),
         "add": ("dia_spmm_add", 2, 0, 3), "jacobi": ("dia_jacobi_k", 3, 1, 3)}
# the one-off variants: (name, variant, rows a thread (0: 16 bytes' worth),
# super tile, staged tile)
VARIANTS = [("rows tuned", 0, 1, 1, 0),
            ("lane grid 1 row", 1, 1, 1, 0),
            ("lane grid 16 B", 1, 0, 1, 0),
            ("lane grid 16 B, super 16", 1, 0, 16, 0),
            ("lane grid 16 B, super 128", 1, 0, 128, 0),
            ("lane grid 16 B, super 512", 1, 0, 512, 0),
            ("lane grid 1 row, super 16", 1, 1, 16, 0),
            ("lane grid 1 row, super 128", 1, 1, 128, 0),
            ("lane grid pairs, super 128", 3, 0, 128, 0),
            ("staged 1024", 2, 0, 1, 1024),
            ("staged 2048", 2, 0, 1, 2048)]


def _scalar(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def _omega_args(omega, dtype):
    if isinstance(omega, torch.Tensor):
        return _scalar(dtype)(0.0), omega.data_ptr()
    return _scalar(dtype)(float(omega)), None


def parent_kernels(parent):
    """K8 / K9 of the checkout ``parent`` (its thread-per-row kernel in
    16-lane chunks, built by its own _build.py) as a callable (mode, A, X,
    b, dinv, omega) -> Y; and its K10 as (A, B, dinv, omega) -> (X, R)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def launch(mode, A, X, b, dinv, omega, Y, R):
        suffix = "f32" if A.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_dia_k_{suffix}")
        fn.argtypes = [P, P, I, L, I, P, P, P, _scalar(A.dtype), P, P, P, I,
                       P]
        fn.restype = ctypes.c_int
        w, w_dev = _omega_args(omega, A.dtype)
        for k0 in range(0, Y.shape[0], 16):
            k1 = min(Y.shape[0], k0 + 16)

            def sl(t):
                return None if t is None else (
                    t if t.ndim == 1 else t[k0:k1]).data_ptr()
            assert fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                      A.n_pad, k1 - k0, sl(X), sl(b), sl(dinv), w, w_dev,
                      sl(Y), sl(R), mode,
                      torch.cuda.current_stream().cuda_stream) == 0

    def k8(mode, A, X, b, dinv, omega):
        Y = torch.empty_like(X)
        launch(mode, A, X, b, dinv, omega, Y, None)
        return Y

    def k10(A, B, dinv, omega):
        X, R = torch.empty_like(B), torch.empty_like(B)
        launch(4, A, None, B, dinv, omega, X, R)
        return X, R

    return k8, k10


def variants_library():
    """``scripts/dia_k_variants.cu``, built once with the package's nvcc
    flags into the ignored ``pyamg_tpu_torch/_build/``."""
    from pyamg_tpu_torch import _build

    src = os.path.join(ROOT, "scripts", "dia_k_variants.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            _build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"dia_k_variants_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(tmp), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas (variants): {line.strip()}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, sc in (("sweep_dia_k_f32", ctypes.c_float),
                     ("sweep_dia_k_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [I, I, I, I, P, ctypes.POINTER(I), I, L, I, P, P, P,
                       sc, P, I, P]
        fn.restype = ctypes.c_int
    return lib


def run_variant(lib, spec, mode, A, X, b, dinv, omega):
    _, variant, vec, sup, tile = spec
    sz = A.data.element_size()
    fn = getattr(lib, f"sweep_dia_k_{'f32' if sz == 4 else 'f64'}")
    Y = torch.empty_like(X)
    err = fn(variant, vec or 16 // sz, sup, tile, A.data.data_ptr(),
             A.offsets_c, A.ndiags, A.n_pad, X.shape[0], X.data_ptr(),
             None if b is None else b.data_ptr(),
             None if dinv is None else dinv.data_ptr(), float(omega),
             Y.data_ptr(), MODES[mode][1],
             torch.cuda.current_stream().cuda_stream)
    if err == 1:                   # cudaErrorInvalidValue: not this shape
        return None
    assert err == 0, (spec, mode, err)
    return Y


def turns(parent_fn, change_fn):
    """(change ms, parent ms): parent, change, change, parent."""
    t = [cs.time_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
    return min(t[1], t[2]), min(t[0], t[3])


def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def as_dtype(M, dtype):
    from pyamg_tpu_torch.sparse import DIAMatrix

    return DIAMatrix(data=M.data.to(dtype), offsets=M.offsets, shape=M.shape,
                     nnz=M.nnz)


def shapes(dev):
    """(label, dtype, {mode: operator}, dinv, omega, tv) at the paths'
    shapes."""
    from pyamg_tpu_torch import (as_device_solver, device_sa_setup, poisson,
                                 smoothed_aggregation_solver)

    A = poisson(cs.GRID, format="csr")
    kw = dict(grid=cs.GRID, dtype=torch.float32, device=dev, max_coarse=400,
              mixed_precision=True)
    hd = device_sa_setup(A, **kw).hierarchy
    hl = device_sa_setup(A, lane_align=True, **kw).hierarchy
    dml = as_device_solver(smoothed_aggregation_solver(A, **CONFIG1),
                           device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    hh = dml.hierarchy
    out = []
    for label, lvl, dtypes in (("device level0", hd.levels[0],
                                (torch.float32, torch.float64)),
                               ("device level1", hd.levels[1],
                                (torch.float32, torch.float64)),
                               ("lane-aligned level1", hl.levels[1],
                                (torch.float32,))):
        for dtype in dtypes:
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            ops = {"plain": as_dtype(lvl.A, dtype),
                   "jacobi": as_dtype(lvl.A, dtype),
                   "add": as_dtype(lvl.P.S, dtype),
                   "scale": as_dtype(lvl.R.St, dtype)}
            out.append((label, dtype, ops, dinv, omega,
                        lvl.R.tv.to(dtype)))
    h0 = hh.levels[0]
    out.append(("host level0", torch.float32,
                {"plain": h0.A, "jacobi": h0.A}, h0.pre.arrays[0],
                h0.pre.config[1], None))
    for label, A64 in (("device A64 level0", hd.A64),
                       ("host A64 level0", hh.A64)):
        out.append((label, torch.float64, {"plain": A64}, None, None, None))
    return out, h0


def measure(dev, rng, parent, lib):
    from pyamg_tpu_torch.sparse import dia

    ok, out = True, []
    rows_shapes, h0 = shapes(dev)
    for label, dtype, ops, dinv, omega, tv in rows_shapes:
        for mode, A in ops.items():
            kernel = MODES[mode][0]
            n = A.n_pad
            X, V = (torch.as_tensor(rng.random((LANES, n)), dtype=dtype,
                                    device=dev) for _ in range(2))
            b = {"plain": None, "scale": tv, "add": V, "jacobi": V}[mode]
            dv = dinv if mode == "jacobi" else None
            w = omega if mode == "jacobi" else 0.0
            w_host = float(w)          # the variants take omega by value
            cmode = MODES[mode][1]
            change = {"plain": lambda: dia.dia_spmm(A, X),
                      "scale": lambda: dia.dia_spmm_scaled(A, X, tv),
                      "add": lambda: dia.dia_spmm_add(A, X, V),
                      "jacobi": lambda: dia.dia_jacobi_k(A, X, V, dinv,
                                                         omega)}[mode]
            plain = {"plain": lambda: dia.dia_spmm_ref(A, X),
                     "scale": lambda: dia.dia_spmm_scaled_ref(A, X, tv),
                     "add": lambda: dia.dia_spmm_add_ref(A, X, V),
                     "jacobi": lambda: dia.dia_jacobi_k_ref(A, X, V, dinv,
                                                            omega)}[mode]
            rows = (lambda: dia._dia_k_rows(       # noqa: E731
                kernel, cmode, A, X, b, dv, w))
            plan = dia.k8_plan(A.offsets, n, LANES, dtype)
            got = change()
            want = plain()
            sz = A.data.element_size()
            vecs, stacks = MODES[mode][2:]
            rec = dict(shape=label, mode=mode, kernel=kernel,
                       dtype=str(dtype), n_pad=n, offsets=list(A.offsets),
                       plan=None if plan is None else dict(
                           vec=plan.vec, rows=plan.rows,
                           row_blocks=plan.row_blocks, lo=plan.lo,
                           hi=plan.hi, blocks=plan.blocks),
                       rows_bits=same(got, rows()),
                       two_launches_equal=same(got, change()),
                       max_rel_err_twin=float((got - want).abs().max()
                                              / want.abs().max()),
                       max_abs_err_twin=float((got - want).abs().max()),
                       bound_ms=(A.ndiags + vecs + stacks * LANES) * n * sz
                       / cs.PEAK_BYTES * 1e3)
            if parent is not None:
                pk = (lambda: parent[0](             # noqa: E731
                    cmode, A, X, b, dv, w))
                rec["parent_bits"] = same(got, pk())
                rec["ms"], rec["parent_ms"] = turns(pk, change)
            else:
                rec["ms"] = min(cs.time_ms(change) for _ in range(2))
            rec["rows_ms"] = min(cs.time_ms(rows) for _ in range(2))
            rec["plain_ms"] = cs.time_ms(plain)
            lib_fn = None
            if mode in ("plain", "add"):
                csr = cs.dia_to_csr(A)
                Xc, Vc = X.T.contiguous(), V.T.contiguous()
                lib_fn = ((lambda: torch.sparse.mm(csr, Xc)) if mode ==
                          "plain" else (lambda: torch.addmm(Vc, csr, Xc)))
            rec["library_ms"] = (min(cs.time_ms(lib_fn) for _ in range(2))
                                 if lib_fn is not None else None)
            ok &= (rec["rows_bits"] and rec["two_launches_equal"]
                   and rec.get("parent_bits", True))
            rec["variants"] = []
            for spec in VARIANTS:
                fn = (lambda s=spec: run_variant(   # noqa: E731
                    lib, s, mode, A, X, b, dv, w_host))
                y = fn()
                if y is None:              # its staging does not fit
                    rec["variants"].append(dict(variant=spec[0], ms=None))
                    continue
                v = dict(variant=spec[0], same_bits=same(y, got),
                         ms=min(cs.time_ms(fn) for _ in range(2)))
                ok &= v["same_bits"]
                rec["variants"].append(v)
            print(f"K8/K9 {json.dumps(rec)}", flush=True)
            out.append(rec)
            del X, V, got, want
    # K10 at the host-built level 0, the thread-per-row kernel unchanged
    A, dinv, omega = h0.A, h0.pre.arrays[0], h0.pre.config[1]
    B = torch.as_tensor(rng.random((LANES, A.n_pad)), dtype=A.dtype,
                        device=dev)
    change = lambda: dia.dia_jacobi_zero_res_k(A, B, dinv, omega)  # noqa
    got = change()
    want = dia.dia_jacobi_zero_res_k_ref(A, B, dinv, omega)
    rec = dict(shape="host level0", mode="zero_res", kernel="K10",
               dtype=str(A.dtype), n_pad=A.n_pad,
               max_rel_err_twin=max(float((g - w_).abs().max()
                                          / w_.abs().max())
                                    for g, w_ in zip(got, want)),
               bound_ms=(A.ndiags + 1 + 3 * LANES) * A.n_pad
               * A.data.element_size() / cs.PEAK_BYTES * 1e3)
    if parent is not None:
        pk = lambda: parent[1](A, B, dinv, omega)  # noqa: E731
        rec["parent_bits"] = same(got, pk())
        rec["ms"], rec["parent_ms"] = turns(pk, change)
        ok &= rec["parent_bits"]
    else:
        rec["ms"] = min(cs.time_ms(change) for _ in range(2))
    print(f"K10 {json.dumps(rec)}", flush=True)
    out.append(rec)
    return ok, out


_KERNEL_RE = re.compile(r"(dia_k_lane_kernel|dia_k_kernel|"
                        r"zero_chain_k_ring_kernel|zero_chain_k_kernel)"
                        r"<(float|double), (\d)")
_MODE_NAMES = {"0": "K8 plain", "1": "K8 scale", "2": "K8 add", "3": "K9",
               "4": "K10"}


def solves_of(tree):
    """Child process: the batched solves on the package of ``tree``; one
    JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from pyamg_tpu_torch import (_build, as_device_solver, device_sa_setup,
                                 poisson, smoothed_aggregation_solver)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    A = poisson(cs.GRID, format="csr")
    dsa = device_sa_setup(A, grid=cs.GRID, dtype=torch.float32, device=dev,
                          max_coarse=400, mixed_precision=True)
    dml = as_device_solver(smoothed_aggregation_solver(A, **CONFIG1),
                           device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    Bt = torch.as_tensor(np.random.default_rng(3).random((A.shape[0], LANES)),
                         device=dev)
    native = dict(tol=1e-5, maxiter=100, accel="cg", precision="native")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    runs = {"device-built batched native": lambda r=None: dsa.solve(
                Bt, residuals=r, **native),
            "host-built batched native": lambda r=None: dml.solve(
                Bt, residuals=r, **native),
            "device-built batched mixed": lambda r=None: dsa.solve(
                Bt, residuals=r, **mixed)}
    out = {}
    for label, fn in runs.items():
        res = []
        fn(res)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, kern = 0.0, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = e.device_time_total / 1e3
            busy += t
            m = _KERNEL_RE.search(e.name)
            if m is None:
                continue
            name = ("K11" if m.group(1).startswith("zero_chain")
                    else _MODE_NAMES[m.group(3)])
            name += f" {'f32' if m.group(2) == 'float' else 'f64'}"
            if m.group(1) == "dia_k_kernel" and name[:2] in ("K8", "K9"):
                name += " (per-row)"
            ms, cnt = kern.get(name, (0.0, 0))
            kern[name] = (ms + t, cnt + 1)
        out[label] = dict(iterations=[len(r) - 1 for r in res],
                          wall_ms=float(np.median(walls)) * 1e3,
                          walls_ms=[w * 1e3 for w in walls],
                          profiled_wall_ms=wall * 1e3, kernel_ms=busy,
                          busy=busy / (wall * 1e3),
                          kernels={k: dict(ms=v[0], launches=v[1])
                                   for k, v in sorted(kern.items())})
    print(json.dumps(out))


def measure_solves(parent):
    rows = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--solves-of", tree], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"solves of {tree} failed:\n{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec = dict(tree="parent" if tree == parent else "change", **rec)
        print(f"solves {json.dumps(rec)}", flush=True)
        rows.append(rec)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose K8 / K9 bits the "
                    "kernels must equal, timed beside them")
    ap.add_argument("--solves", action="store_true", help="also time whole "
                    "solves, parent and change (needs --parent)")
    ap.add_argument("--solves-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_k8_k9: torch sees no CUDA device")
    if args.solves_of:
        solves_of(os.path.abspath(args.solves_of))
        return
    if args.solves and not args.parent:
        sys.exit("measure_k8_k9: --solves needs --parent")
    from pyamg_tpu_torch import _build

    dev = torch.device("cuda", 0)
    parent = parent_kernels(os.path.abspath(args.parent)) if args.parent \
        else None
    lib = variants_library()
    _build.library()
    for line in _build.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    ok, recs = measure(dev, np.random.default_rng(0), parent, lib)
    solves = measure_solves(os.path.abspath(args.parent)) if args.solves \
        else None
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), k8_k9=recs,
                          solves=solves)))
    if not ok:
        sys.exit("measure_k8_k9: a kernel or a variant changed the bits")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card,
                                 # nvcc and nvidia-smi on the machine

Phases, in order (any failure exits non-zero before the result lines):

1. toolchain record: Python, torch and CUDA versions, nvcc, the card;
2. build every kernel of pyamg_tpu_torch/csrc with nvcc (one process per
   source, all started together);
3. host smoothed-aggregation setup of BASELINE config 1 (2-D 5-point
   Poisson, 2048^2, Jacobi omega=4/3 before and after) and its compile to
   the card (coarse_cutoff=1024, float32 hierarchy + float64 A64);
4. the device-built hierarchy of the same operator on the card
   (device_sa_setup, float32, max_coarse=400, float64 A64): the setup
   time of a second call after a warm one, and each level's forms;
5. each kernel against its plain PyTorch twin on the same inputs, at the
   paths' shapes: the host-built level-0 and level-1 DIA operators in
   float32 and float64 (three DIA modes) and tentative operators T, T^T;
   the device-built level-0 and level-1 zero-entry chain (K5), level 0's
   Jacobi-plus-residual (K4) and the two SpMV epilogues on level 0's S
   and S^T: max error, and CUDA-event times of both;
6. a small-input reference check: a 128^2 float64 host-built solve on the
   card against the host solver's residual history;
7. host-built config 1: mixed-precision CG to 1e-8 with
   b = default_rng(1).random(n), launch counters zeroed just before and
   read just after; the iteration count, the residual, the solve time;
8. device-built config 1: the same with b = default_rng(0).random(n)
   (the reference bench's right-hand side);
9. a stationary phase (accel=None, native float32, 5 V-cycles) on a
   256^2 device-built hierarchy, against the same run on a CPU copy of
   that hierarchy (the plain twins), with launch counters;
10. one V-cycle of the 2048^2 device-built hierarchy under
    torch.cuda.set_sync_debug_mode("error"): no host read in the cycle;
11. result lines: the kernels' JSON, the card's name and power limit, and
    last {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

F32_REL_TOL = 1e-5     # f32 kernels vs twin: FMA contraction, atomics order
F64_REL_TOL = 1e-12    # f64 kernels vs twin
STATIONARY_RTOL = 1e-4  # f32 card vs f32 CPU twins over 5 cycles
DEVICE = "cuda:0"
GRID = (2048, 2048)
COARSE_CUTOFF = 1024
REF_ITERS = 16         # bench_detail.json config1.iters_to_1e8
REF_ITERS_DEVICE = 18  # bench_detail.json config1.device_setup_iters_to_1e8
STATIONARY_GRID = (256, 256)

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": ("pyamg_tpu_torch/csrc/dia.cu",
                 "pyamg_tpu/sparse/dia.py:449"),
    "dia_spmv_scaled": ("pyamg_tpu_torch/csrc/dia.cu",
                        "pyamg_tpu/sparse/dia.py:449"),
    "dia_spmv_add": ("pyamg_tpu_torch/csrc/dia.cu",
                     "pyamg_tpu/sparse/dia.py:449"),
    "dia_jacobi": ("pyamg_tpu_torch/csrc/dia.cu",
                   "pyamg_tpu/sparse/dia.py:579"),
    "dia_jacobi_zero_res": ("pyamg_tpu_torch/csrc/dia.cu",
                            "pyamg_tpu/sparse/dia.py:642"),
    "dia_jacobi_res": ("pyamg_tpu_torch/csrc/dia_chain.cu",
                       "pyamg_tpu/sparse/dia.py:715"),
    "dia_zero_chain": ("pyamg_tpu_torch/csrc/dia_chain.cu",
                       "pyamg_tpu/sparse/dia.py:861"),
    "windowed_matvec": ("pyamg_tpu_torch/csrc/window.cu",
                        "pyamg_tpu/sparse/window.py:152"),
    "windowed_rmatvec": ("pyamg_tpu_torch/csrc/window.cu",
                         "pyamg_tpu/sparse/window.py:226"),
}
# path -> the kernel instances it must launch
PATHS = {
    "host-built config 1": (
        "dia_spmv.float32", "dia_spmv.float64", "dia_jacobi.float32",
        "dia_jacobi_zero_res.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32"),
    "device-built config 1": (
        "dia_zero_chain.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float64"),
    "device-built stationary": (
        "dia_jacobi_res.float32", "dia_spmv_scaled.float32"),
}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=30):
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, ok, what):
        log(("  ok   " if ok else "  FAIL ") + what)
        if not ok:
            self.failures.append(what)


def compare(check, name, dtype, kernel_fn, plain_fn, results, nbytes=None):
    """Run a kernel and its plain twin on the same inputs; record errors
    and times (the twin first, then the kernel, twice over).  ``nbytes``:
    the bytes the kernel must move, for its rate."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = F32_REL_TOL if dtype == torch.float32 else F64_REL_TOL
    t_plain, t_kernel = [], []
    for _ in range(2):
        t_plain.append(time_ms(plain_fn))
        t_kernel.append(time_ms(kernel_fn))
    ms, plain_ms = min(t_kernel), min(t_plain)
    rate = (f", {nbytes / ms / 1e6:.0f} GB/s" if nbytes else "")
    check(finite and rel_err <= tol,
          f"{name}: max_rel_err {rel_err:.3e} (tol {tol:g}), max_abs_err "
          f"{abs_err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{rate}")
    results.append(dict(name=name, max_abs_err=abs_err, max_rel_err=rel_err,
                        ms=ms, plain_ms=plain_ms))


def to_device(obj, dev):
    """A copy of a hierarchy (frozen dataclasses, tuples, tensors) with
    every tensor on ``dev``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(to_device(o, dev) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    return obj


def forms(lvl):
    out = []
    for op in (lvl.A, lvl.P, lvl.R):
        if op is None:
            continue
        name = type(op).__name__
        if hasattr(op, "ops"):
            name += "(" + ",".join(type(o).__name__ for o in op.ops) + ")"
        for attr in ("S", "St"):
            if hasattr(op, attr):
                name += f"({attr} nd={getattr(op, attr).ndiags})"
        if hasattr(op, "ndiags"):
            name += f"(nd={op.ndiags})"
        out.append(name)
    return " ".join(out)


def solve_phase(check, label, solver, A, b, ref_iters, launches):
    """Mixed CG to 1e-8 on ``solver``: counters zeroed just before the
    timed solve and read just after; four repeats for the median."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    kw = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    solver.solve(b, **kw)                      # warm-up (library handles)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = solver.solve(b, residuals=res, **kw)
    times = [time.perf_counter() - t0]
    counts = dict(_build.launches)
    for _ in range(4):
        t0 = time.perf_counter()
        solver.solve(b, **kw)
        times.append(time.perf_counter() - t0)
    n = A.shape[0]
    iters = len(res) - 1
    normb = float(np.linalg.norm(b))
    relres_hist = res[-1] / normb
    relres_true = float(np.linalg.norm(b - A @ x)) / normb
    log(f"{label} (2048^2, mixed, CG to 1e-8): {iters} iterations, "
        f"history relres {relres_hist:.3e}, true relres {relres_true:.3e}, "
        f"solve {times[0]:.4f} s (repeats "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s, median "
        f"{float(np.median(times)):.4f} s)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(x.shape == (n,) and bool(np.isfinite(x).all()),
          f"{label}: solution finite, shape (n,)")
    check(relres_hist <= 1e-8 and relres_true <= 1e-8,
          f"{label}: relative residual <= 1e-8")
    check(abs(iters - ref_iters) <= 1,
          f"{label}: {iters} CG iterations within {ref_iters} +- 1 "
          "(reference)")
    for k in PATHS[label]:
        check(counts.get(k, 0) > 0, f"{label}: {k} launched "
              f"({counts.get(k, 0)} launches)")
    launches[label] = counts


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    from pyamg_tpu_torch import (_build, as_device_solver, device_sa_setup,
                                 DeviceMultilevelSolver)
    from pyamg_tpu_torch.sparse import DIAMatrix, WindowedELL, dia, window

    check = Checks()
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    # 1. toolchain
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    card = nvidia_smi_line()
    log(f"card: {card}; torch.cuda.device_count() = "
        f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(cached={_build.build_info.get('cached')}) -> "
        f"{_build.build_info.get('path')}")
    for line in _build.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. host setup and compile at 2048^2
    A = poisson(GRID, format="csr")
    n = A.shape[0]
    t0 = time.perf_counter()
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=COARSE_CUTOFF)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    h = dml.hierarchy
    log(f"host SA setup {t_setup:.2f} s; compile to the card "
        f"{t_compile:.2f} s; {len(h.levels)} device levels")
    for i, lvl in enumerate(h.levels):
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")

    # 4. device-built setup at 2048^2 (warm call, then the timed one)
    setup_kw = dict(grid=GRID, dtype=torch.float32, device=dev,
                    max_coarse=400, mixed_precision=True)
    t0 = time.perf_counter()
    dsa = device_sa_setup(A, **setup_kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    del dsa
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dsa = device_sa_setup(A, **setup_kw)
    torch.cuda.synchronize()
    t_dsetup = time.perf_counter() - t0
    hd = dsa.hierarchy
    log(f"device SA setup on the card: {t_dsetup:.3f} s (first call "
        f"{t_first:.3f} s, CUDA-synchronised, host CSR -> DIA included); "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        f" GiB; {len(hd.levels)} levels")
    for i, lvl in enumerate(hd.levels):
        grid = (f"grid_p={lvl.P.fine_grid_p} "
                f"rho={float(dsa.setup_info['levels'][i]['rho_D_inv_A']):.6f}"
                if lvl.P is not None else f"dense {lvl.n}x{lvl.n}")
        log(f"  level {i}: {grid} n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")

    # 5. kernels against their plain twins at the paths' shapes
    log("kernel checks (kernel vs plain twin, same inputs):")
    rng = np.random.default_rng(0)

    def rand(m, dtype):
        return torch.as_tensor(rng.random(m), dtype=dtype, device=dev)

    def as_dtype(M, dtype):
        return DIAMatrix(data=M.data.to(dtype), offsets=M.offsets,
                         shape=M.shape, nnz=M.nnz)

    results = []
    lv0, lv1 = h.levels[0], h.levels[1]
    dia_cases = [("level0", lv0.A, lv0.pre.arrays[0]),
                 ("level1", lv1.A, lv1.pre.arrays[0])]
    omega0 = lv0.pre.config[1]
    for label, Af, dinvf in dia_cases:
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float32:
                Ad, dinv = Af, dinvf
            elif label == "level0":
                Ad, dinv = h.A64, dinvf.double()
            else:
                Ad, dinv = as_dtype(Af, dtype), dinvf.double()
            assert isinstance(Ad, DIAMatrix) and Ad.n_pad == dinv.shape[0]
            x = rand(Ad.n_pad, dtype)
            b = rand(Ad.n_pad, dtype)
            tag = f"host {label} nd={Ad.ndiags} n_pad={Ad.n_pad}"
            dt = str(dtype).removeprefix("torch.")
            compare(check, f"dia_spmv.{dt} [{tag}]", dtype,
                    lambda: dia.dia_spmv(Ad, x),
                    lambda: dia.dia_spmv_ref(Ad, x), results)
            compare(check, f"dia_jacobi.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi(Ad, x, b, dinv, omega0),
                    lambda: dia.dia_jacobi_ref(Ad, x, b, dinv, omega0),
                    results)
            compare(check, f"dia_jacobi_zero_res.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi_zero_res(Ad, b, dinv, omega0),
                    lambda: dia.dia_jacobi_zero_res_ref(Ad, b, dinv, omega0),
                    results)
    for label, lvl in (("level0", lv0), ("level1", lv1)):
        Tf = lvl.P.ops[-1]
        assert isinstance(Tf, WindowedELL) and lvl.R.ops[0].base is Tf
        for dtype in (torch.float32, torch.float64):
            T = Tf if dtype == torch.float32 else WindowedELL(
                data=Tf.data.double(), idx=Tf.idx, starts=Tf.starts,
                shape=Tf.shape, block=Tf.block, w2=Tf.w2,
                m_chunks=Tf.m_chunks, nnz=Tf.nnz)
            x = rand(T.m_chunks * T.w2, dtype)
            r = rand(T.n_pad, dtype)
            tag = (f"host {label} T {T.shape[0]}x{T.shape[1]} k={T.k} "
                   f"block={T.block} w2={T.w2}")
            dt = str(dtype).removeprefix("torch.")
            compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_matvec(T, x),
                    lambda: window.windowed_matvec_ref(T, x), results)
            compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_rmatvec(T, r),
                    lambda: window.windowed_rmatvec_ref(T, r), results)
    # the device-built path's new kernels: K5 on levels 0 and 1, K4 and
    # the two K1 epilogues on level 0, each in float32 and float64
    for label, lvl in (("level0", hd.levels[0]), ("level1", hd.levels[1])):
        for dtype in (torch.float32, torch.float64):
            Ad, St = as_dtype(lvl.A, dtype), as_dtype(lvl.R.St, dtype)
            S = as_dtype(lvl.P.S, dtype)
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            tv = lvl.R.tv.to(dtype)
            m = Ad.n_pad
            b, x, t = (rand(m, dtype) for _ in range(3))
            sz = Ad.data.element_size()
            nd, nds = Ad.ndiags, St.ndiags
            tag = f"device {label} nd={nd} St nd={nds} n_pad={m}"
            dt = str(dtype).removeprefix("torch.")
            compare(check, f"dia_zero_chain.{dt} [{tag}]", dtype,
                    lambda: dia.dia_zero_chain(Ad, St, b, dinv, tv, omega),
                    lambda: dia.dia_zero_chain_ref(Ad, St, b, dinv, tv,
                                                   omega),
                    results, nbytes=(nd + nds + 5) * m * sz)
            if label != "level0":
                continue
            compare(check, f"dia_jacobi_res.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi_res(Ad, x, b, dinv, omega),
                    lambda: dia.dia_jacobi_res_ref(Ad, x, b, dinv, omega),
                    results, nbytes=(nd + 5) * m * sz)
            compare(check, f"dia_spmv_add.{dt} [device {label} S nd="
                    f"{S.ndiags} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_add(S, t, x),
                    lambda: dia.dia_spmv_add_ref(S, t, x),
                    results, nbytes=(S.ndiags + 3) * m * sz)
            compare(check, f"dia_spmv_scaled.{dt} [device {label} St nd="
                    f"{nds} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_scaled(St, x, tv),
                    lambda: dia.dia_spmv_scaled_ref(St, x, tv),
                    results, nbytes=(nds + 3) * m * sz)

    # 6. small input against the host solver (float64, every level kept)
    A_s = poisson((128, 128), format="csr")
    ml_s = pyamg_tpu.smoothed_aggregation_solver(
        A_s, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    b_s = np.random.default_rng(6).random(A_s.shape[0])
    res_d, res_h = [], []
    as_device_solver(ml_s, dtype=torch.float64, device=dev).solve(
        b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_d)
    ml_s.solve(b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_h)
    m = min(len(res_d), len(res_h))
    hist_err = float(np.max(np.abs(np.subtract(res_d[:m], res_h[:m]))
                            / np.asarray(res_h[:m])))
    check(len(res_d) == len(res_h) and hist_err <= 1e-8,
          f"128^2 float64 CG on the card vs host solver: {len(res_d) - 1} "
          f"vs {len(res_h) - 1} iterations, history rel diff "
          f"{hist_err:.2e} (tol 1e-8)")

    # 7. and 8. config 1, host-built and device-built, with counters
    launches = {}
    solve_phase(check, "host-built config 1", dml, A,
                np.random.default_rng(1).random(n), REF_ITERS, launches)
    solve_phase(check, "device-built config 1", dsa, A,
                np.random.default_rng(0).random(n), REF_ITERS_DEVICE,
                launches)

    # 9. stationary V-cycles from a nonzero iterate (K4, K1 SPMV_SCALED)
    label = "device-built stationary"
    A_st = poisson(STATIONARY_GRID, format="csr")
    d_st = device_sa_setup(A_st, grid=STATIONARY_GRID, dtype=torch.float32,
                           device=dev, max_coarse=400)
    b_st = np.random.default_rng(2).random(A_st.shape[0])
    kw = dict(tol=0.0, maxiter=5, accel=None, precision="native")
    _build.reset_launches()
    res_g = []
    d_st.solve(b_st, residuals=res_g, **kw)
    launches[label] = dict(_build.launches)
    cpu_copy = type(d_st)(to_device(d_st.hierarchy, "cpu"), d_st.grid,
                          d_st.grid_p)
    res_c = []
    cpu_copy.solve(b_st, residuals=res_c, **kw)
    st_err = float(np.max(np.abs(np.subtract(res_g, res_c))
                          / np.asarray(res_c)))
    log(f"{label} (256^2, f32, accel=None, 5 cycles): card history "
        f"{' '.join(f'{r:.6e}' for r in res_g)}")
    log(f"  launches: {json.dumps(launches[label], sort_keys=True)}")
    check(len(res_g) == len(res_c) == 6 and st_err <= STATIONARY_RTOL,
          f"{label}: history vs the CPU copy (twins) rel diff {st_err:.2e} "
          f"(tol {STATIONARY_RTOL:g}); factor "
          f"{(res_g[-1] / res_g[0]) ** 0.2:.4f}")
    for k in PATHS[label]:
        check(launches[label].get(k, 0) > 0, f"{label}: {k} launched "
              f"({launches[label].get(k, 0)} launches)")

    # 10. one device-built V-cycle with every host sync an error
    cycle = DeviceMultilevelSolver(hd).cycle_operator("V")
    r = rand(hd.levels[0].n_pad, torch.float32)
    cycle(r)                                   # warm: cached offsets
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        y = cycle(r)
        sync_err = None
    except RuntimeError as exc:
        sync_err = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(sync_err is None and bool(torch.isfinite(y).all()),
          "one device-built V-cycle under set_sync_debug_mode('error'): "
          + ("no host sync" if sync_err is None else sync_err))

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    # 11. result lines: each path kernel instance, with its launches on
    # the paths that run it
    rows = []
    for key in dict.fromkeys(k for ks in PATHS.values() for k in ks):
        base, dt = key.split(".")
        r0 = next(r for r in results if r["name"].startswith(key + " "))
        src, replaces = KERNELS[base]
        by_path = {p: launches[p][key] for p, ks in PATHS.items()
                   if key in ks}
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": next(iter(by_path.values())),
                     "launches_by_path": by_path,
                     "max_abs_err": r0["max_abs_err"], "ms": r0["ms"],
                     "plain_ms": r0["plain_ms"], "shape": r0["name"]})
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

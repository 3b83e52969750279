#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card,
                                 # nvcc and nvidia-smi on the machine

Phases, in order (any failure exits non-zero before the result lines):

1. toolchain record: Python, torch and CUDA versions, nvcc, the card;
2. build every kernel of pyamg_tpu_torch/csrc with nvcc;
3. host smoothed-aggregation setup of BASELINE config 1 (2-D 5-point
   Poisson, 2048^2, Jacobi omega=4/3 before and after) and its compile to
   the card (coarse_cutoff=1024, float32 hierarchy + float64 A64);
4. each kernel against its plain PyTorch twin on the same inputs, at the
   main path's shapes (level-0 and level-1 DIA operators in float32 and
   float64, all three DIA modes; the level-0 and level-1 tentative
   operators T and T^T): max error, and CUDA-event times of both;
5. a small-input reference check: a 128^2 float64 solve on the card
   against the host solver's residual history;
6. config 1: mixed-precision CG to 1e-8 with b = default_rng(1).random(n),
   launch counters zeroed just before and read just after; the iteration
   count, the residual, the solve time;
7. result lines: the kernels' JSON, the card's name and power limit, and
   last {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

F32_REL_TOL = 1e-5     # f32 kernels vs twin: FMA contraction, atomics order
F64_REL_TOL = 1e-12    # f64 kernels vs twin
DEVICE = "cuda:0"
GRID = (2048, 2048)
COARSE_CUTOFF = 1024
REF_ITERS = 16         # bench_detail.json config1.iters_to_1e8

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": ("pyamg_tpu_torch/csrc/dia.cu",
                 "pyamg_tpu/sparse/dia.py:449"),
    "dia_jacobi": ("pyamg_tpu_torch/csrc/dia.cu",
                   "pyamg_tpu/sparse/dia.py:579"),
    "dia_jacobi_zero_res": ("pyamg_tpu_torch/csrc/dia.cu",
                            "pyamg_tpu/sparse/dia.py:642"),
    "windowed_matvec": ("pyamg_tpu_torch/csrc/window.cu",
                        "pyamg_tpu/sparse/window.py:152"),
    "windowed_rmatvec": ("pyamg_tpu_torch/csrc/window.cu",
                         "pyamg_tpu/sparse/window.py:226"),
}
# the kernel instances the main path launches
PATH_KERNELS = ("dia_spmv.float32", "dia_spmv.float64", "dia_jacobi.float32",
                "dia_jacobi_zero_res.float32", "windowed_matvec.float32",
                "windowed_rmatvec.float32")


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


def compare(check, name, dtype, kernel_fn, plain_fn, results):
    """Run a kernel and its plain twin on the same inputs; record errors
    and times (the twin first, then the kernel, twice over)."""
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
    check(finite and rel_err <= tol,
          f"{name}: max_rel_err {rel_err:.3e} (tol {tol:g}), max_abs_err "
          f"{abs_err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(name=name, max_abs_err=abs_err, max_rel_err=rel_err,
                        ms=ms, plain_ms=plain_ms))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    from pyamg_tpu_torch import _build, as_device_solver
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
        forms = [type(op).__name__ + (
            "(" + ",".join(type(o).__name__ for o in op.ops) + ")"
            if hasattr(op, "ops") else "") for op in (lvl.A, lvl.P, lvl.R)
            if op is not None]
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {' '.join(forms)}")

    # 4. kernels against their plain twins at the path's shapes
    log("kernel checks (kernel vs plain twin, same inputs):")
    rng = np.random.default_rng(0)

    def rand(m, dtype):
        return torch.as_tensor(rng.random(m), dtype=dtype, device=dev)

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
                Ad = DIAMatrix(data=Af.data.double(), offsets=Af.offsets,
                               shape=Af.shape, nnz=Af.nnz)
                dinv = dinvf.double()
            assert isinstance(Ad, DIAMatrix) and Ad.n_pad == dinv.shape[0]
            x = rand(Ad.n_pad, dtype)
            b = rand(Ad.n_pad, dtype)
            tag = f"{label} nd={Ad.ndiags} n_pad={Ad.n_pad}"
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
            tag = (f"{label} T {T.shape[0]}x{T.shape[1]} k={T.k} "
                   f"block={T.block} w2={T.w2}")
            dt = str(dtype).removeprefix("torch.")
            compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_matvec(T, x),
                    lambda: window.windowed_matvec_ref(T, x), results)
            compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_rmatvec(T, r),
                    lambda: window.windowed_rmatvec_ref(T, r), results)

    # 5. small input against the host solver (float64, every level kept)
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

    # 6. config 1: the main path, with launch counters
    b1 = np.random.default_rng(1).random(n)
    solve_kw = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    dml.solve(b1, **solve_kw)                  # warm-up (library handles)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = dml.solve(b1, residuals=res, **solve_kw)
    t_solve = time.perf_counter() - t0
    counts = dict(_build.launches)
    times = [t_solve]
    for _ in range(4):
        t0 = time.perf_counter()
        dml.solve(b1, **solve_kw)
        times.append(time.perf_counter() - t0)
    iters = len(res) - 1
    normb = float(np.linalg.norm(b1))
    relres_hist = res[-1] / normb
    relres_true = float(np.linalg.norm(b1 - A @ x)) / normb
    log(f"config 1 (2048^2, mixed, CG to 1e-8): {iters} iterations, "
        f"history relres {relres_hist:.3e}, true relres {relres_true:.3e}, "
        f"solve {times[0]:.4f} s (repeats "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s, median "
        f"{float(np.median(times)):.4f} s)")
    log(f"launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(x.shape == (n,) and bool(np.isfinite(x).all()),
          "solution finite, shape (n,)")
    check(relres_hist <= 1e-8 and relres_true <= 1e-8,
          "relative residual <= 1e-8")
    check(abs(iters - REF_ITERS) <= 1,
          f"{iters} CG iterations within 16 +- 1 (reference)")
    for k in PATH_KERNELS:
        check(counts.get(k, 0) > 0, f"{k} launched on the main path "
              f"({counts.get(k, 0)} launches)")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    # 7. result lines
    rows = []
    for key in PATH_KERNELS:
        base, dt = key.split(".")
        r0 = next(r for r in results if r["name"].startswith(key + " "))
        src, replaces = KERNELS[base]
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[key],
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

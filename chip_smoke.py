#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card,
                                 # nvcc and nvidia-smi on the machine

It imports nothing of JAX or of the JAX package: the port carries its own
host setup.  Phases, in order (any failure exits non-zero before the
result lines):

1. toolchain record: Python, torch and CUDA versions, nvcc, the card;
2. build every kernel of pyamg_tpu_torch/csrc with nvcc (one process per
   source, all started together);
3. the port's host smoothed-aggregation setup of BASELINE config 1 (2-D
   5-point Poisson, 2048^2, Jacobi omega=4/3 before and after) and its
   compile to the card (coarse_cutoff=1024, float32 hierarchy + float64
   A64);
4. the device-built hierarchy of the same operator on the card
   (device_sa_setup, float32, max_coarse=400, float64 A64): the setup
   time of a second call after a warm one, and each level's forms; then
   the same with lane_align=True (the interleaved route's layout);
5. each kernel against its plain PyTorch twin on the same inputs, at the
   paths' shapes: the host-built level-0 and level-1 DIA operators in
   float32 and float64 (three DIA modes) and tentative operators T, T^T;
   the device-built level-0 and level-1 zero-entry chain (K5), level 0's
   Jacobi-plus-residual (K4) and the two SpMV epilogues on level 0's S
   and S^T; the K-lane kernels at K = 8 on the device-built level-0 and
   level-1 operators (K8 in its three modes, K9, K11); K10 at host level 0
   and K12, K13 on the host-built T at K = 8; K15's five modes on the
   lane-aligned level-0 operators at K = 8: max error,
   CUDA-event times of both, the bound from the bytes and operations the
   call needs, and one PyTorch library call as a yardstick where one
   computes the same function (never on the path); the transposes (K7,
   K13) launched twice, bit-identical, equal to the CPU twins bit for bit,
   with their column plan's build time and size;
5b. K16 (dia_halo_spmv) at host level 0, float32 and float64: the ring of
   one against its twin and bit for bit against K1, four in-process row
   blocks (halos copied on a side stream) against K1, and the interior
   alone, the halo copies alone and the overlapped total;
6. a small-input reference check: a 128^2 float64 host-built solve on the
   card against the same hierarchy copied to the CPU (the plain twins);
7. host-built config 1: mixed-precision CG to 1e-8 with
   b = default_rng(1).random(n), launch counters zeroed just before and
   read just after; the iteration count, the residual, the solve time;
8. device-built config 1: the same with b = default_rng(0).random(n)
   (the reference bench's right-hand side);
9. batched config 1, B = default_rng(3).random((n, 8)), native float32 CG
   to 1e-5 and mixed CG to 1e-8, launch counters zeroed before and read
   after; per-lane counts against each column's 1-D solve, residuals, and
   the wall time per solve and per right-hand side beside the 1-D solve:
   on the device-built hierarchy (K8, K9, K11), on the host-built one
   (K10, K12, K13), then on the lane-aligned device-built hierarchy the
   interleaved route (native, K15's five modes) and the K-major mixed
   solve;
10. a stationary phase (accel=None, native float32, 5 V-cycles) on a
    256^2 device-built hierarchy, one right-hand side and then K = 4,
    each against the same run on a CPU copy of that hierarchy (the plain
    twins), with launch counters;
11. one V-cycle of the 2048^2 device-built hierarchy under
    torch.cuda.set_sync_debug_mode("error"), on one vector, on a K = 8
    stack and (interleaved) on the lane-aligned hierarchy: no host read in
    any; the lane-aligned V-cycle's time per right-hand side, interleaved
    and K-major; then a torch.profiler trace of the batched solves and
    the 1-D one (wall, kernel time, launches, busy share, largest
    kernels);
12. the unstructured device setup (device_unstructured_sa_setup): the
    reference's 640k case (a P1 stiffness matrix on a regular 800^2
    triangle mesh plus 1e-2 I, max_coarse=1000) twice, with per-stage
    seconds, peak memory and levels (0-2 against the reference's), counters
    zeroed before the first; K14 (windowed_select, float32 and float64
    payloads, bit-exact; torch.take as the yardstick) on level 0's and
    level 1's A, and K6/K7 (level 0's A and P, level 1's A) and K12/K13
    (K = 64, level 0's A and P) at this hierarchy's shapes; float32 CG to
    1e-6 with b = default_rng(0).standard_normal(n) (counters around the
    solve; the reference's 7 +- 1 iterations); a V-cycle under sync-debug
    "error"; then a 200^2 jittered mesh, scrambled, routed by
    device_sa_setup through RCM (float64; its float64 kernel instances
    K14, K6/K7 and K12/K13 at K = 64 checked on its level 0's A and P),
    and aggressive with smooth_passes=2 in float64 and in float32 (twice),
    each solved to 1e-6 through the ReorderedSolver; the two 640k setups
    must give identical levels and f32 CG histories, the two float32
    aggressive runs identical true residuals (the transposes sum in a
    fixed order);
13. row-sharded solves (pyamg_tpu_torch.parallel) in a world of one NCCL
    rank: host-built config 1 (native f32 CG to 1e-5, K16 on its DIA
    levels) and the 640k unstructured hierarchy (f32 CG to 1e-6), each at
    its unsharded solve's iteration count, with counters; the process
    group is destroyed before the result lines;
14. result lines: the script's seconds, the kernels' JSON, the card's name
    and power limit, and last {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

F32_REL_TOL = 1e-5     # f32 kernels vs twin: FMA contraction, atomics order
                       # of the transposes' twins (index_add_) on the card
F64_REL_TOL = 1e-12    # f64 kernels vs twin
STATIONARY_RTOL = 1e-4  # f32 card vs f32 CPU twins over 5 cycles
DEVICE = "cuda:0"
GRID = (2048, 2048)
COARSE_CUTOFF = 1024
REF_ITERS = 16         # bench_detail.json config1.iters_to_1e8
REF_ITERS_DEVICE = 18  # bench_detail.json config1.device_setup_iters_to_1e8
# bench_detail.json config1.device_setup_cg_iters_to_1e-5 and
# batched_rhs.solve_iters
REF_ITERS_BATCHED_1E5 = 13
LANES = 8
STATIONARY_GRID = (256, 256)
STATIONARY_LANES = 4
# the card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit): HBM3
# bytes/s, and float32 / float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}

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
    "dia_spmm": ("pyamg_tpu_torch/csrc/dia_k.cu",
                 "pyamg_tpu/sparse/dia.py:353"),
    "dia_spmm_scaled": ("pyamg_tpu_torch/csrc/dia_k.cu",
                        "pyamg_tpu/sparse/dia.py:353"),
    "dia_spmm_add": ("pyamg_tpu_torch/csrc/dia_k.cu",
                     "pyamg_tpu/sparse/dia.py:353"),
    "dia_jacobi_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                     "pyamg_tpu/sparse/dia.py:1262"),
    "dia_zero_chain_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                         "pyamg_tpu/sparse/dia.py:975"),
    "dia_jacobi_zero_res_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                              "pyamg_tpu/sparse/dia.py:1141"),
    "windowed_matmat_k": ("pyamg_tpu_torch/csrc/window.cu",
                          "pyamg_tpu/sparse/window.py:505"),
    "windowed_rmatmat_k": ("pyamg_tpu_torch/csrc/window.cu",
                           "pyamg_tpu/sparse/window.py:600"),
    "windowed_select": ("pyamg_tpu_torch/csrc/window.cu",
                        "pyamg_tpu/sparse/window.py:361"),
    "dia_halo_spmv": ("pyamg_tpu_torch/csrc/halo.cu",
                      "pyamg_tpu/parallel/pallas_halo.py:50"),
    **{name: ("pyamg_tpu_torch/csrc/interleaved.cu",
              "pyamg_tpu/sparse/interleaved.py:160")
       for name in ("int_jacobi_zero_res", "int_spmv_scaled", "int_spmv",
                    "int_spmv_add", "int_jacobi_step")},
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
    "device-built batched config 1": (
        "dia_zero_chain_k.float32", "dia_spmm_add.float32",
        "dia_jacobi_k.float32", "dia_spmm.float32", "dia_spmm.float64"),
    "device-built batched stationary": (
        "dia_jacobi_k.float32", "dia_spmm.float32",
        "dia_spmm_scaled.float32"),
    "host-built batched config 1": (
        "dia_jacobi_zero_res_k.float32", "windowed_matmat_k.float32",
        "windowed_rmatmat_k.float32", "dia_jacobi_k.float32",
        "dia_spmm.float32", "dia_spmm.float64"),
    "interleaved batched config 1": (
        "int_jacobi_zero_res.float32", "int_spmv_scaled.float32",
        "int_spmv.float32", "int_spmv_add.float32", "int_jacobi_step.float32",
        "dia_zero_chain_k.float32"),
    "lane-aligned batched mixed": (
        "dia_zero_chain_k.float32", "dia_spmm_add.float32",
        "dia_jacobi_k.float32", "dia_spmm.float64"),
    "unstructured setup": (
        "windowed_select.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32", "windowed_matmat_k.float32",
        "windowed_rmatmat_k.float32"),
    "unstructured solve": (
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    "routed unstructured setup": (
        "windowed_select.float64", "windowed_select.float32",
        "windowed_matvec.float64", "windowed_rmatvec.float64",
        "windowed_matmat_k.float64", "windowed_rmatmat_k.float64"),
    "sharded host-built config 1": (
        "dia_halo_spmv.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32"),
    "sharded unstructured": (
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
}
# the lane-aligned 2048^2 fine grid and its solve padding (the reference's)
LANE_GRID_P = (2064, 2304)
LANE_N_PAD = 4784128


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SLEEP_MS_PER_CYCLE = []


def _sleep_cycles(ms):
    """GPU clock cycles that ``torch.cuda._sleep`` needs to hold the card
    for ``ms`` milliseconds (calibrated once by CUDA events)."""
    import torch

    if not _SLEEP_MS_PER_CYCLE:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        stop.record()
        torch.cuda.synchronize()
        _SLEEP_MS_PER_CYCLE.append(start.elapsed_time(stop) / 10**7)
    return int(ms / _SLEEP_MS_PER_CYCLE[0])


def time_ms(fn, iters=30):
    """Mean device milliseconds per call over ``iters`` back-to-back
    calls, by CUDA events, after a warm-up.  The calls are queued behind a
    sleep kernel longer than the host needs to issue them, so the events
    time the card's work and not the wrappers' host cost (which exceeds a
    small kernel's run time)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_sleep_cycles(min(2 * iters * host_ms + 1.0, 2000.0)))
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


def compare(check, name, dtype, kernel_fn, plain_fn, results, nbytes, ops,
            library_fn=None, path=None, exact=False, repeat_exact=False):
    """Run a kernel and its plain twin on the same inputs; record errors
    and times (the twin first, then the kernel, twice over).  ``nbytes``
    and ``ops``: the bytes the call must move (each input read once, each
    output written once) and the operations it must do, for its bound.
    ``library_fn``: one PyTorch call computing the same function, timed as
    a yardstick only.  ``path``: the path (a key of PATHS) whose shapes
    these are; the kernels line takes a kernel's numbers from the check
    at its first path's shapes where there is one.  ``exact``: the kernel
    must equal its twin bit for bit.  ``repeat_exact``: a second launch
    must give the first one's bits (a fixed summation order)."""
    import torch

    got = kernel_fn()
    again = kernel_fn() if repeat_exact else got
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = want if isinstance(want, tuple) else (want,)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = F32_REL_TOL if dtype == torch.float32 else F64_REL_TOL
    if exact:
        tol = 0.0
        finite = finite and all(torch.equal(g, w) for g, w in zip(got, want))
    t_plain, t_kernel = [], []
    for _ in range(2):
        t_plain.append(time_ms(plain_fn))
        t_kernel.append(time_ms(kernel_fn))
    ms, plain_ms = min(t_kernel), min(t_plain)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[str(dtype).removeprefix("torch.")] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    check(finite and rel_err <= tol and same,
          f"{name}: max_rel_err {rel_err:.3e} "
          f"({'bit-exact required' if exact else f'tol {tol:g}'}), "
          + (f"two launches {'bit-identical' if same else 'DIFFER'}, "
             if repeat_exact else "") +
          f"max_abs_err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{nbytes / ms / 1e6:.0f} GB/s")
    results.append(dict(name=name, max_abs_err=abs_err, max_rel_err=rel_err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, path=path))


def transpose_checks(check, label, W, r, Rk):
    """The column plan of the windowed transposes (K7, K13): its build on
    a fresh copy of ``W`` with every host sync an error (CUDA-synchronised
    ms, int32 bytes), and K7 (and K13 on ``Rk`` when given) against the
    plain twins run on the CPU, bit for bit (the kernels sum each column in
    the CPU twin's order, with separately rounded products and sums)."""
    import torch

    from pyamg_tpu_torch.sparse import window

    fresh = dataclasses.replace(W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("error")
        perm, colptr = fresh.column_plan
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    mb = (perm.numel() + colptr.numel()) * 4 / 1e6
    live = int(colptr[-1])
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    same = torch.equal(window.windowed_rmatvec(W, r).cpu(),
                       window.windowed_rmatvec_ref(W_cpu, r.cpu()))
    if Rk is not None:
        same = same and torch.equal(
            window.windowed_rmatmat_k(W, Rk).cpu(),
            window.windowed_rmatmat_k_ref(W_cpu, Rk.cpu()))
    check(same, f"{label}: column plan of {perm.numel()} entries ({live} "
          f"live), {mb:.2f} MB int32 (perm + colptr), built with no host "
          f"sync in {build_ms:.2f} ms; "
          f"K7{' and K13' if Rk is not None else ''} equal the CPU twins "
          "bit for bit")


def dia_cost(A, vectors, lanes=1, stacks=0, extra_ops=0):
    """(bytes, operations) of a DIA pass: A's diagonals, ``vectors``
    shared (n_pad,) vectors and ``stacks`` (lanes, n_pad) stacks, each
    read or written once; 2 operations per stored diagonal entry per lane
    plus ``extra_ops`` per row and lane."""
    n, sz = A.n_pad, A.data.element_size()
    nbytes = (A.ndiags + vectors + stacks * lanes) * n * sz
    return nbytes, (2 * A.ndiags + extra_ops) * n * lanes


def dia_to_csr(A):
    """The DIA operator as a torch CSR matrix on its device (the library
    yardstick's input)."""
    import torch

    n = A.n_pad
    i = torch.arange(n, device=A.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        j = i + off
        m = (j >= 0) & (j < n) & (A.data[d] != 0)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(A.data[d][m])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n)).coalesce()
    return coo.to_sparse_csr()


def scipy_to_csr(M, dtype, dev):
    import torch

    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, dtype=torch.int64),
        torch.as_tensor(M.indices, dtype=torch.int64),
        torch.as_tensor(M.data), size=M.shape).to(dtype=dtype, device=dev)


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


def stationary_phase(check, label, solver, b, launches):
    """accel=None, native, 5 V-cycles on the card (counters zeroed just
    before, read just after) against the same run on a CPU copy of the
    hierarchy (the plain twins).  ``b`` is a vector or an (n, K) stack."""
    import numpy as np

    from pyamg_tpu_torch import _build

    kw = dict(tol=0.0, maxiter=5, accel=None, precision="native")
    _build.reset_launches()
    res_g = []
    solver.solve(b, residuals=res_g, **kw)
    launches[label] = dict(_build.launches)
    cpu_copy = type(solver)(to_device(solver.hierarchy, "cpu"), solver.grid,
                            solver.grid_p)
    res_c = []
    cpu_copy.solve(b, residuals=res_c, **kw)
    if np.ndim(b) == 1:
        res_g, res_c = [res_g], [res_c]
    st_err = max(float(np.max(np.abs(np.subtract(g, c)) / np.asarray(c)))
                 for g, c in zip(res_g, res_c))
    for k, g in enumerate(res_g):
        log(f"{label} lane {k} (256^2, f32, accel=None, 5 cycles): card "
            f"history {' '.join(f'{r:.6e}' for r in g)}")
    log(f"  launches: {json.dumps(launches[label], sort_keys=True)}")
    check(all(len(g) == len(c) == 6 for g, c in zip(res_g, res_c))
          and st_err <= STATIONARY_RTOL,
          f"{label}: history vs the CPU copy (twins) rel diff {st_err:.2e} "
          f"(tol {STATIONARY_RTOL:g}); factor lane 0 "
          f"{(res_g[0][-1] / res_g[0][0]) ** 0.2:.4f}")
    for k in PATHS[label]:
        check(launches[label].get(k, 0) > 0, f"{label}: {k} launched "
              f"({launches[label].get(k, 0)} launches)")


def batched_phase(check, label, solver, A, launches, ref_native,
                  ref_mixed):
    """Batched config 1: K = 8 lanes, native f32 CG to 1e-5 and mixed CG to
    1e-8 (counters zeroed before both, read after both), then wall times
    per solve and per right-hand side beside the 1-D solve of column 0.
    Every lane takes its own column's 1-D native solve's count +- 1, and
    the reference's counts +- 1 where given (``ref_native`` None: the
    reference has no batched count for this hierarchy).  B lives on the
    card, so the times exclude the host copies of the (n, 8) float64
    stack."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    n = A.shape[0]
    B = np.random.default_rng(3).random((n, LANES))
    Bt = torch.as_tensor(B, device=solver.hierarchy.device)
    native = dict(tol=1e-5, maxiter=100, accel="cg", precision="native")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    solver.solve(Bt, **native)                 # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res_n, res_m = [], []
    Xn, info_n = solver.solve(Bt, residuals=res_n, return_info=True,
                              **native)
    Xm, info_m = solver.solve(Bt, residuals=res_m, return_info=True, **mixed)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    launches[label] = counts
    Xn, Xm = Xn.cpu().numpy(), Xm.cpu().numpy()
    normb = np.linalg.norm(B, axis=0)
    it_n = [len(r) - 1 for r in res_n]
    it_m = [len(r) - 1 for r in res_m]
    true_n = np.linalg.norm(B - A @ Xn, axis=0) / normb
    true_m = np.linalg.norm(B - A @ Xm, axis=0) / normb
    hist_m = np.array([r[-1] for r in res_m]) / normb
    it_1 = []
    for j in range(LANES):
        res_1 = []
        solver.solve(Bt[:, j].contiguous(), residuals=res_1, **native)
        it_1.append(len(res_1) - 1)
    times = {}
    for key, b, kw in (("batched native", Bt, native),
                       ("1-D native", Bt[:, 0].contiguous(), native),
                       ("batched mixed", Bt, mixed),
                       ("1-D mixed", Bt[:, 0].contiguous(), mixed)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            solver.solve(b, **kw)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[key] = float(np.median(ts))
    log(f"{label} (2048^2, K={LANES}, b on the card):")
    log(f"  native f32 CG to 1e-5: iterations per lane {it_n} (info "
        f"{info_n}); true relres max {true_n.max():.3e}; 1-D solves of the "
        f"columns: {it_1} iterations")
    log(f"  mixed CG to 1e-8: iterations per lane {it_m} (info {info_m}); "
        f"history relres max {hist_m.max():.3e}, true relres max "
        f"{true_m.max():.3e}")
    for kind in ("native", "mixed"):
        tb, t1 = times[f"batched {kind}"], times[f"1-D {kind}"]
        log(f"  {kind}: batched solve {tb:.4f} s = {tb / LANES:.4f} s per "
            f"right-hand side; 1-D solve {t1:.4f} s; amortization "
            f"{t1 * LANES / tb:.2f}x (median of 3)")
    log(f"  launches in those two solves: {json.dumps(counts, sort_keys=True)}")
    check(Xn.shape == Xm.shape == (n, LANES)
          and bool(np.isfinite(Xn).all() and np.isfinite(Xm).all()),
          f"{label}: solutions finite, shape (n, {LANES})")
    if ref_native is not None:
        check(all(abs(i - ref_native) <= 1 for i in it_n) and info_n == 0,
              f"{label}: native f32 lanes {it_n} within {ref_native} +- 1 "
              "(reference) to 1e-5")
    check(all(abs(i - i1) <= 1 for i, i1 in zip(it_n, it_1))
          and info_n == 0,
          f"{label}: native f32 lanes {it_n} within +- 1 of their 1-D "
          f"solves {it_1} to 1e-5")
    check(all(abs(i - ref_mixed) <= 1 for i in it_m) and info_m == 0,
          f"{label}: mixed lanes {it_m} within {ref_mixed} +- 1 "
          "(reference) to 1e-8")
    check(bool(hist_m.max() <= 1e-8 and true_m.max() <= 1e-8),
          f"{label}: every lane's true relres <= 1e-8 ({true_m.max():.3e})")
    for k in PATHS[label]:
        check(counts.get(k, 0) > 0, f"{label}: {k} launched "
              f"({counts.get(k, 0)} launches)")


def interleaved_phase(check, dla, A, launches):
    """The lane-aligned device-built config 1, K = 8, B =
    default_rng(3).random((n, 8)) on the card: native f32 CG to 1e-5 takes
    the interleaved route (every K15 mode launched, the reference's 13 +-
    1 iterations per lane), then mixed CG to 1e-8 takes the K-major path
    at the lane-aligned n_pad (no K15 launch; every lane's true relres <=
    1e-8); counters zeroed just before each solve and read just after;
    wall times per solve and per right-hand side."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    n = A.shape[0]
    B = np.random.default_rng(3).random((n, LANES))
    Bt = torch.as_tensor(B, device=dla.hierarchy.device)
    native = dict(tol=1e-5, maxiter=100, accel="cg")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    dla.solve(Bt, **native)                    # warm-up
    dla.solve(Bt, **mixed)
    torch.cuda.synchronize()
    label = "interleaved batched config 1"
    _build.reset_launches()
    res_n = []
    Xn, info_n = dla.solve(Bt, residuals=res_n, return_info=True, **native)
    torch.cuda.synchronize()
    counts_n = launches[label] = dict(_build.launches)
    label_m = "lane-aligned batched mixed"
    _build.reset_launches()
    res_m = []
    Xm, info_m = dla.solve(Bt, residuals=res_m, return_info=True, **mixed)
    torch.cuda.synchronize()
    counts_m = launches[label_m] = dict(_build.launches)
    Xn, Xm = Xn.cpu().numpy(), Xm.cpu().numpy()
    normb = np.linalg.norm(B, axis=0)
    it_n = [len(r) - 1 for r in res_n]
    it_m = [len(r) - 1 for r in res_m]
    hist_n = np.array([r[-1] for r in res_n]) / normb
    true_n = np.linalg.norm(B - A @ Xn, axis=0) / normb
    true_m = np.linalg.norm(B - A @ Xm, axis=0) / normb
    times = {}
    for key, kw in (("interleaved native", native),
                    ("K-major mixed", mixed)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            dla.solve(Bt, **kw)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[key] = float(np.median(ts))
    log(f"{label} (2048^2 lane-aligned, grid_p {dla.grid_p}, n_pad "
        f"{dla.hierarchy.levels[0].n_pad}, K={LANES}, b on the card):")
    log(f"  native f32 CG to 1e-5 (interleaved route): iterations per lane "
        f"{it_n} (info {info_n}); history relres max {hist_n.max():.3e}, "
        f"true relres max {true_n.max():.3e}")
    log(f"  mixed CG to 1e-8 (K-major path): iterations per lane {it_m} "
        f"(info {info_m}); true relres max {true_m.max():.3e}")
    for key, t in times.items():
        log(f"  {key}: {t:.4f} s per solve = {t / LANES:.4f} s per "
            "right-hand side (median of 3)")
    log(f"  launches, native: {json.dumps(counts_n, sort_keys=True)}")
    log(f"  launches, mixed: {json.dumps(counts_m, sort_keys=True)}")
    check(Xn.shape == Xm.shape == (n, LANES)
          and bool(np.isfinite(Xn).all() and np.isfinite(Xm).all()),
          f"{label}: solutions finite, shape (n, {LANES})")
    check(all(abs(i - REF_ITERS_BATCHED_1E5) <= 1 for i in it_n)
          and info_n == 0 and hist_n.max() <= 1e-5,
          f"{label}: native f32 lanes {it_n} within {REF_ITERS_BATCHED_1E5}"
          " +- 1 (reference) to 1e-5")
    check(info_m == 0 and true_m.max() <= 1e-8
          and not any(k.startswith("int_") for k in counts_m),
          f"{label_m}: lanes {it_m} converged to true relres "
          f"{true_m.max():.3e} <= 1e-8 on the K-major path")
    for lab, counts in ((label, counts_n), (label_m, counts_m)):
        for k in PATHS[lab]:
            check(counts.get(k, 0) > 0, f"{lab}: {k} launched "
                  f"({counts.get(k, 0)} launches)")


def profile_phase(title, runs):
    """A torch.profiler trace of each (label, fn) call, after a warm one:
    wall time, CUDA kernel time, kernel launches, the device's busy share,
    and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log(f"profile (torch.profiler, CUDA kernels; {title}):")
    for label, fn in runs:
        fn()                                   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name if len(e.name) < 60 else e.name[:57] + "..."
            t, c = kern.get(name, (0.0, 0))
            kern[name] = (t + e.device_time_total / 1e3, c + 1)
        busy = sum(t for t, _ in kern.values())
        launches = sum(c for _, c in kern.values())
        share = (f"{busy / (wall * 1e3):.3f}" if busy > 0
                 else "not measured (no device events in the trace)")
        log(f"  {label}: wall {wall * 1e3:.2f} ms, kernel time {busy:.2f} "
            f"ms, {launches} kernels, device busy share {share}")
        for name, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"    {t:8.3f} ms {c:5d}x  {name}")


def sync_free_cycle(check, cycle, r, what):
    """One V-cycle ``cycle(r)`` with every host sync an error."""
    import torch

    cycle(r)                                   # warm: cached offsets
    torch.cuda.synchronize()
    y = None
    try:
        torch.cuda.set_sync_debug_mode("error")
        y = cycle(r)
        sync_err = None
    except RuntimeError as exc:
        sync_err = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(sync_err is None and y is not None and y.shape == r.shape
          and bool(torch.isfinite(y).all()),
          f"one V-cycle on {what} under set_sync_debug_mode('error'): "
          + ("no host sync" if sync_err is None else sync_err))


def lane_cycle_times(check, dla, rand):
    """The lane-aligned hierarchy's zero V-cycle on K = 8 lanes, the
    interleaved one against the K-major one (CUDA events, 20 cycles each,
    min of 2 turns), per right-hand side; the layout conversion beside
    them; and the two corrections against each other (f32)."""
    import torch

    from pyamg_tpu_torch import DeviceMultilevelSolver
    from pyamg_tpu_torch.engine.batched_cycle import interleaved_zero_vcycle
    from pyamg_tpu_torch.sparse.interleaved import (from_interleaved,
                                                    to_interleaved)

    h = dla.hierarchy
    Bk = rand((LANES, h.levels[0].n_pad), torch.float32)
    Bi = to_interleaved(Bk)
    kmajor = DeviceMultilevelSolver(h).cycle_operator("V")
    t_int, t_km = [], []
    for _ in range(2):
        t_int.append(time_ms(lambda: interleaved_zero_vcycle(h, Bi), 20))
        t_km.append(time_ms(lambda: kmajor(Bk), 20))
    t_conv = time_ms(lambda: from_interleaved(to_interleaved(Bk)), 20)
    err = float((from_interleaved(interleaved_zero_vcycle(h, Bi))
                 - kmajor(Bk)).abs().max() / kmajor(Bk).abs().max())
    log(f"lane-aligned V-cycle, K={LANES} (CUDA events, 20 cycles, min of "
        f"2): interleaved {min(t_int):.4f} ms = {min(t_int) / LANES:.4f} ms "
        f"per right-hand side; K-major {min(t_km):.4f} ms = "
        f"{min(t_km) / LANES:.4f} ms per right-hand side; to_interleaved + "
        f"from_interleaved of the stack {t_conv:.4f} ms")
    check(err <= 1e-4, f"interleaved V-cycle vs the K-major one: max rel "
          f"diff {err:.2e} (tol 1e-4, f32 sums in another order)")
    sync_free_cycle(check, lambda r: interleaved_zero_vcycle(h, r), Bi,
                    f"a K={LANES} interleaved stack (lane-aligned)")

def halo_phase(check, h, rand, results):
    """K16 at host level 0 of 2048^2 (nd = 5, n = 4.19M, halo 2048), in
    float32 (the level's operator) and float64 (A64): the ring of one
    against its plain twin (the rolled sum over [tail, x, head]) and bit
    for bit against K1; P = 4 in-process row blocks (halos copied on a
    side stream) against K1; then the interior alone, the halo copies
    alone and the overlapped total beside K1 and the bound.  One H100
    gives no scaling number."""
    import torch

    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.dist_spmv import dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import halo_spmv, halo_spmv_shards
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import dia

    shards = 4
    side = torch.cuda.Stream()
    for A in (h.levels[0].A, h.A64):
        one = SolverMesh(rank=0, world=1, device=A.device)
        dtype, n, halo = A.dtype, A.n_pad, halo_width(A)
        dt = str(dtype).removeprefix("torch.")
        x = rand(n, dtype)
        A_csr = dia_to_csr(A)
        tag = f"host level0 nd={A.ndiags} n_pad={n} halo={halo}"

        def ring():
            return halo_spmv(A.data, A.offsets, A.offsets_t, x, halo, one, 1)

        def plain():
            return dia_halo_rows_ref(A.data, A.offsets, x[n - halo:], x,
                                     x[:halo], halo, ((0, n),),
                                     torch.empty_like(x))

        nbytes, ops = dia_cost(A, 2)
        compare(check, f"dia_halo_spmv.{dt} [{tag} ring of one]", dtype,
                ring, plain, results, nbytes, ops,
                library_fn=lambda: torch.mv(A_csr, x),
                path="sharded host-built config 1"
                if dtype == torch.float32 else None, repeat_exact=True)
        k1 = dia.dia_spmv(A, x)
        split = halo_spmv_shards(A, x, shards, side)
        torch.cuda.synchronize()
        check(torch.equal(ring(), k1) and torch.equal(split, k1),
              f"dia_halo_spmv.{dt} [{tag}]: the ring of one and {shards} "
              "in-process shards equal K1 (dia_spmv) bit for bit")
        t = {}
        for label, phases in (("interior", ("interior",)),
                              ("halo copies", ("halos",)),
                              ("overlapped", ("interior", "halos",
                                              "boundary"))):
            t[label] = min(time_ms(lambda: halo_spmv_shards(
                A, x, shards, side, phases=phases)) for _ in range(2))
        t_k1 = min(time_ms(lambda: dia.dia_spmv(A, x)) for _ in range(2))
        log(f"  K16 {shards} shards in one process [{dt} {tag}]: interior "
            f"alone {t['interior']:.4f} ms, halo copies alone (side stream, "
            f"{2 * shards} copies) {t['halo copies']:.4f} ms, overlapped "
            f"total {t['overlapped']:.4f} ms; K1 on the whole operator "
            f"{t_k1:.4f} ms; bound {nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes)")


def sharded_phase(check, dev, dml, A, dus, A_un, launches):
    """Row-sharded solves in a world of one NCCL rank (file:// rendezvous
    in a temporary directory): the host-built config 1 hierarchy sharded
    (every level a ring of one; its DIA levels through K16), native f32 CG
    to 1e-5, and the 640k unstructured hierarchy sharded, f32 CG to 1e-6;
    each against the unsharded solve of the same b in this run (the same
    iterations; the reference's 7 +- 1 for the unstructured one),
    counters zeroed just before each sharded solve and read just after,
    wall times (numpy b and x, median of 3).  The process group is
    destroyed before returning."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import DeviceMultilevelSolver, _build
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    with tempfile.TemporaryDirectory() as tmp:
        rank, world, _ = initialize_distributed(
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            log(f"sharded solves: torch.distributed {dist.get_backend()}, "
                f"rank {rank} of {world} (file:// rendezvous)")
            # the solves below send nothing (every level is a ring of one),
            # so the NCCL collectives on card tensors run here once
            v = torch.arange(1024.0, device=dev)
            parts, s = [torch.empty_like(v)], v.clone()
            dist.all_gather(parts, v)
            dist.all_reduce(s)
            check(torch.equal(parts[0], v) and torch.equal(s, v),
                  "NCCL all_gather and all_reduce of a card tensor in the "
                  "world of one")
            for label, solver, M, b, tol, ref in (
                    ("sharded host-built config 1", dml, A,
                     np.random.default_rng(1).random(A.shape[0]), 1e-5, None),
                    ("sharded unstructured", dus, A_un,
                     np.random.default_rng(0).standard_normal(A_un.shape[0]),
                     1e-6, UNSTR_REF_ITERS)):
                kw = dict(tol=tol, maxiter=100, accel="cg")
                t0 = time.perf_counter()
                sharded = DeviceMultilevelSolver(
                    shard_hierarchy(solver.hierarchy, mesh))
                t_shard = time.perf_counter() - t0
                res0 = []
                solver.solve(b, residuals=res0, **kw)
                sharded.solve(b, **kw)                 # warm-up
                torch.cuda.synchronize()
                _build.reset_launches()
                res1 = []
                x = sharded.solve(b, residuals=res1, **kw)
                torch.cuda.synchronize()
                counts = launches[label] = dict(_build.launches)
                times = {}
                for key, s in (("sharded", sharded), ("unsharded", solver)):
                    ts = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        s.solve(b, **kw)
                        ts.append(time.perf_counter() - t0)
                    times[key] = float(np.median(ts))
                normb = float(np.linalg.norm(b))
                it0, it1 = len(res0) - 1, len(res1) - 1
                true_rel = float(np.linalg.norm(
                    b - M @ x.astype(np.float64))) / normb
                m = min(it0, it1) + 1
                hist_diff = float(np.max(np.abs(np.subtract(
                    res1[:m], res0[:m])) / np.asarray(res0[:m])))
                log(f"{label} (world of one, native f32 CG to {tol:g}): "
                    f"{it1} iterations (unsharded {it0}), history relres "
                    f"{res1[-1] / normb:.3e}, true relres {true_rel:.3e}, "
                    f"history vs unsharded max rel diff {hist_diff:.2e}; "
                    f"shard_hierarchy {t_shard:.3f} s; solve "
                    f"{times['sharded']:.4f} s sharded, "
                    f"{times['unsharded']:.4f} s unsharded (numpy b, "
                    "median of 3)")
                log(f"  launches in that solve: "
                    f"{json.dumps(counts, sort_keys=True)}")
                check(x.shape == (M.shape[0],) and bool(np.isfinite(x).all())
                      and res1[-1] <= tol * normb,
                      f"{label}: solution finite, relres <= {tol:g}")
                check(it1 == it0, f"{label}: {it1} CG iterations, the "
                      f"unsharded solve's {it0}")
                if ref is not None:
                    check(abs(it1 - ref) <= 1, f"{label}: {it1} iterations "
                          f"within {ref} +- 1 (reference)")
                for k in PATHS[label]:
                    check(counts.get(k, 0) > 0, f"{label}: {k} launched "
                          f"({counts.get(k, 0)} launches)")
        finally:
            dist.destroy_process_group()


# the reference's 640k unstructured case (scripts/measure_unstructured_tpu.py:
# a P1 stiffness matrix on a regular 800^2 triangle mesh plus 1e-2 I)
UNSTR_NX = 800
UNSTR_MAX_COARSE = 1000
UNSTR_LEVELS = (640000, 207874, 24773)   # levels 0-2, JAX on the CPU and TPU
UNSTR_DEEP_CPU = (1700, 118)             # levels 3+, JAX on the CPU
UNSTR_REF_ITERS = 7                      # f32 CG to 1e-6, JAX CPU and TPU
PROBE_LANES = 64                         # the setup's probe chunk width
ROUTED_NX = 200
# the jittered mesh has many inverted elements, so CG takes far more
# iterations than on the regular mesh (tests/test_torch_unstructured.py
# holds the count equal to the reference's on the 40^2 stand-in)
ROUTED_MAXITER = 400


def fem_operator(nx, jitter_seed=None):
    """The P1 stiffness matrix of a regular nx^2 triangle mesh plus 1e-2 I;
    with ``jitter_seed`` the interior vertices move by 0.25/nx standard
    normal steps (the reference's airfoil stand-in,
    pyamg_tpu/gallery/example.py:38-48)."""
    import numpy as np
    import scipy.sparse as sp

    from pyamg_tpu_torch import gradgradform, regular_triangle_mesh

    V, E = regular_triangle_mesh(nx, nx)
    if jitter_seed is not None:
        rng = np.random.default_rng(jitter_seed)
        interior = ((V[:, 0] > 0) & (V[:, 0] < 1) & (V[:, 1] > 0)
                    & (V[:, 1] < 1))
        V = V + 0.25 / nx * rng.standard_normal(V.shape) * interior[:, None]
    A = sp.csr_matrix(gradgradform(V, E))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def windowed_to_csr(W, transpose=False):
    """A windowed operator (or its transpose) as a torch CSR matrix on its
    device (the library yardstick's input)."""
    import torch

    from pyamg_tpu_torch.sparse.window import _global_index

    rows = torch.arange(W.n_pad, device=W.device).reshape(
        -1, 1, W.block).expand(W.data.shape)
    cols = _global_index(W)
    live = W.data != 0
    ij = torch.stack([rows[live], cols[live]])
    shape = (W.n_pad, W.m_chunks * W.w2)
    if transpose:
        ij, shape = ij.flip(0), shape[::-1]
    return torch.sparse_coo_tensor(ij, W.data[live], shape).coalesce(
    ).to_sparse_csr()


def windowed_kernel_checks(check, where, selects, ops, probes, dtype, rand,
                           results, path):
    """The unstructured path's windowed kernels at its hierarchy's shapes,
    in ``dtype`` (the operators' dtype), results tagged with ``path``:
    K14 on each (label, W) of ``selects`` (bit-exact against its twin;
    torch.take on the precomputed int64 index as the yardstick), K6/K7 on
    each of ``ops``, and K12/K13 at the probe width on those of ``ops``
    whose labels are in ``probes``."""
    import torch

    from pyamg_tpu_torch.sparse import window

    dt = str(dtype).removeprefix("torch.")
    for label, W in selects:
        gidx = window._global_index(W)
        m = W.m_chunks * W.w2
        tag = (f"{where} {label} n_pad={W.n_pad} k={W.k} block={W.block} "
               f"w2={W.w2}")
        x = rand(m, dtype)
        sz = x.element_size()
        nbytes = W.idx.numel() * (4 + sz) + W.starts.numel() * 4 + m * sz
        compare(check, f"windowed_select.{dt} [{tag}]", dtype,
                lambda: window.windowed_select(W, x),
                lambda: window.windowed_select_ref(W, x), results,
                nbytes, 0, library_fn=lambda: torch.take(x, gidx),
                path=path, exact=True)
    for label, W in ops:
        assert W.dtype == dtype
        W_csr, Wt_csr = windowed_to_csr(W), windowed_to_csr(W, True)
        m = W.m_chunks * W.w2
        x, r = rand(m, dtype), rand(W.n_pad, dtype)
        sz = W.data.element_size()
        meta = W.data.numel() * sz + (W.idx.numel() + W.starts.numel()) * 4
        flops = 2 * int((W.data != 0).sum())
        tag = (f"{where} {label} {W.shape[0]}x{W.shape[1]} k={W.k} "
               f"block={W.block} w2={W.w2}")
        compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                lambda: window.windowed_matvec(W, x),
                lambda: window.windowed_matvec_ref(W, x), results,
                meta + (m + W.n_pad) * sz, flops,
                library_fn=lambda: torch.mv(W_csr, x), path=path)
        compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                lambda: window.windowed_rmatvec(W, r),
                lambda: window.windowed_rmatvec_ref(W, r), results,
                meta + (m + W.n_pad) * sz, flops,
                library_fn=lambda: torch.mv(Wt_csr, r), path=path,
                repeat_exact=True)
        if label not in probes:
            transpose_checks(check, f"{where} {label} {dt}", W, r, None)
            continue
        K = PROBE_LANES
        Xk, Rk = rand((K, m), dtype), rand((K, W.n_pad), dtype)
        Xc, Rc = Xk.T.contiguous(), Rk.T.contiguous()
        ktag = f"{tag} K={K}"
        compare(check, f"windowed_matmat_k.{dt} [{ktag}]", dtype,
                lambda: window.windowed_matmat_k(W, Xk),
                lambda: window.windowed_matmat_k_ref(W, Xk), results,
                meta + K * (m + W.n_pad) * sz, flops * K,
                library_fn=lambda: torch.sparse.mm(W_csr, Xc), path=path)
        compare(check, f"windowed_rmatmat_k.{dt} [{ktag}]", dtype,
                lambda: window.windowed_rmatmat_k(W, Rk),
                lambda: window.windowed_rmatmat_k_ref(W, Rk), results,
                meta + K * (m + W.n_pad) * sz, flops * K,
                library_fn=lambda: torch.sparse.mm(Wt_csr, Rc), path=path,
                repeat_exact=True)
        transpose_checks(check, f"{where} {label} {dt}", W, r, Rk)


def unstructured_kernel_checks(check, h, rand, results):
    """On the 640k float32 hierarchy: K14 on level 0's and level 1's A
    (float32 payloads, the path's; and float64 payloads, the routed
    float64 path's dtype at this hierarchy's shapes); K6/K7 on level 0's A
    and P and level 1's A; K12/K13 at the probe width on level 0's A and
    P."""
    import torch

    lv0, lv1 = h.levels[0], h.levels[1]
    selects = (("level0 A", lv0.A), ("level1 A", lv1.A))
    windowed_kernel_checks(
        check, "unstructured", selects,
        (("level0 A", lv0.A), ("level0 P", lv0.P), ("level1 A", lv1.A)),
        ("level0 A", "level0 P"), torch.float32, rand, results,
        "unstructured setup")
    windowed_kernel_checks(check, "unstructured", selects, (), (),
                           torch.float64, rand, results, None)


def routed_kernel_checks(check, h, rand, results):
    """On the routed float64 hierarchy (RCM-reordered 200^2 jittered
    mesh), the float64 instances that its setup launches, at its level 0's
    shapes: K14 on A, K6/K7 and K12/K13 at the probe width on A and P."""
    import torch

    lv0 = h.levels[0]
    windowed_kernel_checks(
        check, "routed", (("level0 A", lv0.A),),
        (("level0 A", lv0.A), ("level0 P", lv0.P)),
        ("level0 A", "level0 P"), torch.float64, rand, results,
        "routed unstructured setup")


def unstructured_phase(check, dev, rand, results, launches):
    """The unstructured device setup: (a) the reference's 640k case twice
    (per-stage seconds, peak memory, setup_info, levels), counters zeroed
    before the first and read after it; (b) its kernels against their
    twins; (c) f32 CG to 1e-6, counters around the solve; (d) a sync-free
    V-cycle; (e) a 200^2 jittered mesh, scrambled, routed by
    device_sa_setup through RCM (float64, with its float64 kernel
    checks), and aggressive with smooth_passes=2 in float64 and
    float32."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (_build, DeviceMultilevelSolver,
                                 ReorderedSolver, device_sa_setup,
                                 device_unstructured_sa_setup)

    t0 = time.perf_counter()
    A = fem_operator(UNSTR_NX)
    n = A.shape[0]
    log(f"unstructured: {UNSTR_NX}^2 P1 mesh + 1e-2 I, n={n}, nnz={A.nnz}, "
        f"assembled on the host in {time.perf_counter() - t0:.2f} s")
    kw = dict(device=dev, max_coarse=UNSTR_MAX_COARSE)
    runs = []
    for i in range(2):
        prof = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        dus = device_unstructured_sa_setup(A, profile=prof, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i == 0:
            launches["unstructured setup"] = dict(_build.launches)
        peak = (torch.cuda.max_memory_allocated(dev) - live) / 2**30
        sizes = [lv.n for lv in dus.hierarchy.levels]
        runs.append((dus, sizes))
        stages = {}
        for key, sec in prof.items():
            stage = key.split(".", 1)[1]
            stages[stage] = stages.get(stage, 0.0) + sec
        log(f"unstructured setup run {i + 1}: {wall:.3f} s (CUDA-"
            f"synchronised, host CSR -> windowed included), peak device "
            f"memory {peak:.2f} GiB above the {live / 2**30:.2f} GiB live "
            f"before it, levels {sizes}")
        log(f"  stage totals (s): {json.dumps(stages)}")
        log(f"  per level and stage (s): {json.dumps(prof)}")
    dus, sizes = runs[1]
    log(f"  launches in the first setup: "
        f"{json.dumps(launches['unstructured setup'], sort_keys=True)}")
    for info in dus.setup_info["levels"]:
        log(f"  setup_info {json.dumps(info)}")
    for i, lvl in enumerate(dus.hierarchy.levels):
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")
    # the transposes sum in a fixed order (K7/K13's column plan), so the
    # two setups must agree at every level: with theta = 0 a coarse entry
    # that cancels to a few ulp would otherwise move the deep levels
    check(runs[0][1] == runs[1][1], f"unstructured setup: the two runs' "
          f"levels identical: {runs[0][1]} / {runs[1][1]}")
    check(tuple(sizes[:3]) == UNSTR_LEVELS, f"unstructured setup: levels "
          f"0-2 {sizes[:3]} (the reference's {list(UNSTR_LEVELS)}); levels "
          f"3+ {sizes[3:]} (JAX on the CPU: {list(UNSTR_DEEP_CPU)})")
    for k in PATHS["unstructured setup"]:
        c = launches["unstructured setup"].get(k, 0)
        check(c > 0, f"unstructured setup: {k} launched ({c} launches)")

    # (b) the kernels at this hierarchy's shapes
    unstructured_kernel_checks(check, dus.hierarchy, rand, results)

    # (c) f32 CG to 1e-6
    b = np.random.default_rng(0).standard_normal(n)
    skw = dict(tol=1e-6, maxiter=100, accel="cg")
    dus.solve(b, **skw)                        # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = dus.solve(b, residuals=res, **skw)
    t_solve = time.perf_counter() - t0
    counts = launches["unstructured solve"] = dict(_build.launches)
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        dus.solve(bt, **skw)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    res_first = []
    runs[0][0].solve(b, residuals=res_first, **skw)
    check(res_first == res, f"unstructured solve: the two setups' f32 CG "
          f"histories identical ({len(res_first) - 1} and {len(res) - 1} "
          "iterations)")
    normb = float(np.linalg.norm(b))
    iters = len(res) - 1
    rel = res[-1] / normb
    true_rel = float(np.linalg.norm(b - A @ x.astype(np.float64))) / normb
    log(f"unstructured solve (f32 CG to 1e-6): {iters} iterations, history "
        f"relres {rel:.3e}, true relres {true_rel:.3e}; {t_solve:.4f} s with "
        f"numpy b/x, {float(np.median(ts)):.4f} s with b on the card "
        f"(median of 3)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(abs(iters - UNSTR_REF_ITERS) <= 1 and rel <= 1e-6
          and true_rel <= 1e-5 and bool(np.isfinite(x).all()),
          f"unstructured solve: {iters} iterations within {UNSTR_REF_ITERS} "
          f"+- 1 (reference), relres {rel:.2e} <= 1e-6, true {true_rel:.2e} "
          "<= 1e-5")
    for k in PATHS["unstructured solve"]:
        check(counts.get(k, 0) > 0, f"unstructured solve: {k} launched "
              f"({counts.get(k, 0)} launches)")

    profile_phase(f"unstructured {UNSTR_NX}^2", (
        ("unstructured setup", lambda: device_unstructured_sa_setup(A, **kw)),
        ("unstructured f32 CG to 1e-6, b on the card",
         lambda: dus.solve(bt, **skw))))

    # (d) one V-cycle, no host read
    sync_free_cycle(check, DeviceMultilevelSolver(dus.hierarchy)
                    .cycle_operator("V"),
                    rand(dus.hierarchy.levels[0].n_pad, torch.float32),
                    "one vector (unstructured 640k)")
    del runs

    # (e) a jittered, scrambled mesh routed through RCM
    A0 = fem_operator(ROUTED_NX, jitter_seed=5)
    q = np.random.default_rng(11).permutation(A0.shape[0])
    Ar = A0[q][:, q].tocsr()
    br = np.random.default_rng(12).standard_normal(Ar.shape[0])
    aggr = dict(device=dev, max_coarse=400, aggregate="aggressive",
                smooth_passes=2)
    true_rels = []
    # (label, setup, true-relres limit): float64 closes the gap between
    # the history and the true residual; in float32 the true relres stalls
    # near 1e-4 on this distorted mesh in the JAX package as in the port
    # (tests/test_torch_unstructured.py::
    # test_f32_true_residual_floor_matches_reference)
    for label, make, true_tol in (
            ("routed unstructured setup", lambda: device_sa_setup(
                Ar, dtype=torch.float64, device=dev), 1e-5),
            ("routed aggressive smooth_passes=2", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float64, **aggr),
             1e-5),
            ("routed aggressive smooth_passes=2 float32", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float32, **aggr),
             1e-3),
            ("routed aggressive smooth_passes=2 float32, again", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float32, **aggr),
             1e-3)):
        _build.reset_launches()
        t0 = time.perf_counter()
        rs = make()
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t0
        launches[label] = dict(_build.launches)
        res = []
        xr = rs.solve(br, tol=1e-6, maxiter=ROUTED_MAXITER, accel="cg",
                      residuals=res)
        normb = float(np.linalg.norm(br))
        true_rel = float(np.linalg.norm(br - Ar @ xr.astype(np.float64))
                         ) / normb
        log(f"{label} ({ROUTED_NX}^2 jittered, scrambled, n={Ar.shape[0]}): "
            f"{type(rs).__name__}, setup {t_set:.3f} s, levels "
            f"{[lv.n for lv in rs.hierarchy.levels]}; CG to 1e-6 in "
            f"{len(res) - 1} iterations, history relres "
            f"{res[-1] / normb:.3e}, true relres {true_rel:.3e}")
        log(f"  launches in the setup: "
            f"{json.dumps(launches[label], sort_keys=True)}")
        check(isinstance(rs, ReorderedSolver)
              and rs.setup_info.get("reordered") == "rcm"
              and res[-1] <= 1e-6 * normb and true_rel <= true_tol,
              f"{label}: RCM-reordered, converged to 1e-6 (true relres "
              f"{true_rel:.2e} <= {true_tol:g})")
        for k in PATHS.get(label, ()):
            check(launches[label].get(k, 0) > 0, f"{label}: {k} launched "
                  f"({launches[label].get(k, 0)} launches)")
        if label == "routed unstructured setup":
            routed_kernel_checks(check, rs.hierarchy, rand, results)
        true_rels.append(true_rel)
    # the float32 true relres sits at this mesh's f32 floor, where any
    # change of summation order shows: the two f32 runs must agree exactly
    check(true_rels[-1] == true_rels[-2], f"routed aggressive float32: true "
          f"relres identical in two runs ({true_rels[-2]!r} / "
          f"{true_rels[-1]!r})")
    return dus, A


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from pyamg_tpu_torch import (_build, as_device_solver, device_sa_setup,
                                 DeviceMultilevelSolver, poisson,
                                 smoothed_aggregation_solver)
    from pyamg_tpu_torch.engine.batched_cycle import (_jacobi_wd,
                                                      supports_interleaved)
    from pyamg_tpu_torch.sparse import DIAMatrix, WindowedELL, dia, window
    from pyamg_tpu_torch.sparse import interleaved as il

    t_start = time.perf_counter()
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

    # 3. the port's host setup and its compile at 2048^2
    config1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                   postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    A = poisson(GRID, format="csr")
    n = A.shape[0]
    t0 = time.perf_counter()
    ml = smoothed_aggregation_solver(A, **config1)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=COARSE_CUTOFF)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    h = dml.hierarchy
    log(f"host SA setup (the port's own, g++ build of its native subset "
        f"included) {t_setup:.2f} s; {len(ml.levels)} host levels; compile "
        f"to the card {t_compile:.2f} s; {len(h.levels)} device levels")
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
    # ... and lane-aligned, the interleaved route's layout
    t0 = time.perf_counter()
    dla = device_sa_setup(A, lane_align=True, **setup_kw)
    torch.cuda.synchronize()
    log(f"lane-aligned device SA setup on the card: "
        f"{time.perf_counter() - t0:.3f} s; grid_p {dla.grid_p}; "
        f"supports_interleaved {supports_interleaved(dla.hierarchy)}")
    for i, lvl in enumerate(dla.hierarchy.levels):
        grid = (f"grid_p={lvl.P.fine_grid_p}" if lvl.P is not None
                else f"dense {lvl.n}x{lvl.n}")
        log(f"  level {i}: {grid} n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")
    check(dla.grid_p == LANE_GRID_P
          and dla.hierarchy.levels[0].n_pad == LANE_N_PAD
          and supports_interleaved(dla.hierarchy),
          f"lane-aligned hierarchy: grid_p {dla.grid_p}, n_pad "
          f"{dla.hierarchy.levels[0].n_pad} (the reference's {LANE_GRID_P}, "
          f"{LANE_N_PAD}), interleaved route admitted")

    # 5. kernels against their plain twins at the paths' shapes
    log("kernel checks (kernel vs plain twin, same inputs; library calls "
        "are yardsticks only):")
    rng = np.random.default_rng(0)

    def rand(shape, dtype):
        return torch.as_tensor(rng.random(shape), dtype=dtype, device=dev)

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
            lib = None
            if label == "level0":
                A_csr = dia_to_csr(Ad)
                lib = lambda: torch.mv(A_csr, x)   # noqa: E731
            compare(check, f"dia_spmv.{dt} [{tag}]", dtype,
                    lambda: dia.dia_spmv(Ad, x),
                    lambda: dia.dia_spmv_ref(Ad, x), results,
                    *dia_cost(Ad, 2), library_fn=lib)
            compare(check, f"dia_jacobi.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi(Ad, x, b, dinv, omega0),
                    lambda: dia.dia_jacobi_ref(Ad, x, b, dinv, omega0),
                    results, *dia_cost(Ad, 4, extra_ops=4))
            compare(check, f"dia_jacobi_zero_res.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi_zero_res(Ad, b, dinv, omega0),
                    lambda: dia.dia_jacobi_zero_res_ref(Ad, b, dinv, omega0),
                    results, *dia_cost(Ad, 4, extra_ops=3))
            # K10, the host-built batched cycle's zero-entry front-end
            Bk = rand((LANES, Ad.n_pad), dtype)
            compare(check, f"dia_jacobi_zero_res_k.{dt} [{tag} K={LANES}]",
                    dtype,
                    lambda: dia.dia_jacobi_zero_res_k(Ad, Bk, dinv, omega0),
                    lambda: dia.dia_jacobi_zero_res_k_ref(Ad, Bk, dinv,
                                                          omega0),
                    results, *dia_cost(Ad, 1, LANES, 3, extra_ops=3))
    for label, hlvl, host_lvl in (("level0", lv0, ml.levels[0]),
                                  ("level1", lv1, ml.levels[1])):
        Tf = hlvl.P.ops[-1]
        assert isinstance(Tf, WindowedELL) and hlvl.R.ops[0].base is Tf
        T_host = host_lvl.P._sa_factor["T"]
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
            sz = T.data.element_size()
            meta = T.data.numel() * sz + (T.idx.numel()
                                          + T.starts.numel()) * 4
            ops = 2 * T.data.numel()
            lib_mv = lib_rmv = None
            if label == "level0":
                T_csr = scipy_to_csr(T_host, dtype, dev)
                Tt_csr = scipy_to_csr(T_host.T, dtype, dev)
                xm = x[: T.shape[1]].contiguous()
                rn = r[: T.shape[0]].contiguous()
                lib_mv = lambda: torch.mv(T_csr, xm)     # noqa: E731
                lib_rmv = lambda: torch.mv(Tt_csr, rn)   # noqa: E731
            compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_matvec(T, x),
                    lambda: window.windowed_matvec_ref(T, x), results,
                    meta + (x.numel() + T.n_pad) * sz, ops,
                    library_fn=lib_mv)
            compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_rmatvec(T, r),
                    lambda: window.windowed_rmatvec_ref(T, r), results,
                    meta + (r.numel() + T.m_chunks * T.w2) * sz, ops,
                    library_fn=lib_rmv,
                    repeat_exact=True)
            # K12 and K13 at K = 8 (library: torch.sparse.mm of T and T^T
            # in CSR against (n, 8) column stacks)
            Xk = rand((LANES, T.m_chunks * T.w2), dtype)
            Rk = rand((LANES, T.n_pad), dtype)
            lib_mm = lib_rmm = None
            if label == "level0":
                Xc = Xk[:, : T.shape[1]].T.contiguous()
                Rc = Rk[:, : T.shape[0]].T.contiguous()
                lib_mm = lambda: torch.sparse.mm(T_csr, Xc)     # noqa: E731
                lib_rmm = lambda: torch.sparse.mm(Tt_csr, Rc)   # noqa: E731
            ktag = f"{tag} K={LANES}"
            compare(check, f"windowed_matmat_k.{dt} [{ktag}]", dtype,
                    lambda: window.windowed_matmat_k(T, Xk),
                    lambda: window.windowed_matmat_k_ref(T, Xk), results,
                    meta + (Xk.numel() + LANES * T.n_pad) * sz,
                    ops * LANES, library_fn=lib_mm)
            compare(check, f"windowed_rmatmat_k.{dt} [{ktag}]", dtype,
                    lambda: window.windowed_rmatmat_k(T, Rk),
                    lambda: window.windowed_rmatmat_k_ref(T, Rk), results,
                    meta + (Rk.numel() + LANES * T.m_chunks * T.w2) * sz,
                    ops * LANES, library_fn=lib_rmm,
                    repeat_exact=True)
            transpose_checks(check, f"host {label} T {dt}", T, r, Rk)
    # the device-built path's kernels: K5 on levels 0 and 1, K4 and the
    # two K1 epilogues on level 0; the K-lane kernels (K8 in three modes,
    # K9, K11) at K = 8 on levels 0 and 1; each in float32 and float64
    for label, lvl in (("level0", hd.levels[0]), ("level1", hd.levels[1])):
        for dtype in (torch.float32, torch.float64):
            Ad, St = as_dtype(lvl.A, dtype), as_dtype(lvl.R.St, dtype)
            S = as_dtype(lvl.P.S, dtype)
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            tv = lvl.R.tv.to(dtype)
            m = Ad.n_pad
            b, x, t = (rand(m, dtype) for _ in range(3))
            nd, nds = Ad.ndiags, St.ndiags
            sz = Ad.data.element_size()
            tag = f"device {label} nd={nd} St nd={nds} n_pad={m}"
            dt = str(dtype).removeprefix("torch.")
            compare(check, f"dia_zero_chain.{dt} [{tag}]", dtype,
                    lambda: dia.dia_zero_chain(Ad, St, b, dinv, tv, omega),
                    lambda: dia.dia_zero_chain_ref(Ad, St, b, dinv, tv,
                                                   omega),
                    results, (nd + nds + 5) * m * sz,
                    (2 * nd + 2 * nds + 4) * m)
            Xk, Bk, Vk = (rand((LANES, m), dtype) for _ in range(3))
            ktag = f"{tag} K={LANES}"
            compare(check, f"dia_zero_chain_k.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_zero_chain_k(Ad, St, Bk, dinv, tv,
                                                 omega),
                    lambda: dia.dia_zero_chain_k_ref(Ad, St, Bk, dinv, tv,
                                                     omega),
                    results, (nd + nds + 2 + 3 * LANES) * m * sz,
                    (2 * nd + 2 * nds + 4) * m * LANES)
            if dtype == torch.float32:
                # K11's unfused alternative: the zero-guess sweep, the
                # residual through K8 and K8's scale epilogue (three
                # passes, the (K, n) residual stored and read back)
                def composed():
                    Xc = omega * (dinv * Bk)
                    Rc = Bk - dia.dia_spmm(Ad, Xc)
                    return Xc, dia.dia_spmm_scaled(St, Rc, tv)
                log(f"  composed alternative of dia_zero_chain_k.{dt} "
                    f"[{ktag}]: {min(time_ms(composed), time_ms(composed)):.4f}"
                    " ms (sweep + K8 residual + K8 scale)")
            compare(check, f"dia_jacobi_k.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_jacobi_k(Ad, Xk, Bk, dinv, omega),
                    lambda: dia.dia_jacobi_k_ref(Ad, Xk, Bk, dinv, omega),
                    results, *dia_cost(Ad, 1, LANES, 3, extra_ops=4))
            lib = lib_add = None
            if label == "level0":
                A_csr, S_csr = dia_to_csr(Ad), dia_to_csr(S)
                Xcols, Vcols = Xk.T.contiguous(), Vk.T.contiguous()
                lib = lambda: torch.sparse.mm(A_csr, Xcols)   # noqa: E731
                lib_add = lambda: torch.addmm(               # noqa: E731
                    Vcols, S_csr, Xcols)
            compare(check, f"dia_spmm.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_spmm(Ad, Xk),
                    lambda: dia.dia_spmm_ref(Ad, Xk), results,
                    *dia_cost(Ad, 0, LANES, 2), library_fn=lib)
            compare(check, f"dia_spmm_scaled.{dt} [device {label} St nd="
                    f"{nds} n_pad={m} K={LANES}]", dtype,
                    lambda: dia.dia_spmm_scaled(St, Xk, tv),
                    lambda: dia.dia_spmm_scaled_ref(St, Xk, tv), results,
                    *dia_cost(St, 1, LANES, 2, extra_ops=1))
            compare(check, f"dia_spmm_add.{dt} [device {label} S nd="
                    f"{S.ndiags} n_pad={m} K={LANES}]", dtype,
                    lambda: dia.dia_spmm_add(S, Xk, Vk),
                    lambda: dia.dia_spmm_add_ref(S, Xk, Vk), results,
                    *dia_cost(S, 0, LANES, 3, extra_ops=1),
                    library_fn=lib_add)
            if label != "level0":
                continue
            compare(check, f"dia_jacobi_res.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi_res(Ad, x, b, dinv, omega),
                    lambda: dia.dia_jacobi_res_ref(Ad, x, b, dinv, omega),
                    results, *dia_cost(Ad, 5, extra_ops=6))
            compare(check, f"dia_spmv_add.{dt} [device {label} S nd="
                    f"{S.ndiags} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_add(S, t, x),
                    lambda: dia.dia_spmv_add_ref(S, t, x),
                    results, *dia_cost(S, 3, extra_ops=1),
                    library_fn=lambda: torch.addmv(x, S_csr, t))
            compare(check, f"dia_spmv_scaled.{dt} [device {label} St nd="
                    f"{nds} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_scaled(St, x, tv),
                    lambda: dia.dia_spmv_scaled_ref(St, x, tv),
                    results, *dia_cost(St, 3, extra_ops=1))

    # K15's five modes on the lane-aligned level-0 operators, K = 8, f32
    # (library: torch.sparse.mm of A and torch.addmm of S in CSR against
    # (n, 8) column stacks)
    la0 = dla.hierarchy.levels[0]
    A_la, S_la, St_la, tv_la = la0.A, la0.P.S, la0.R.St, la0.R.tv
    wd_la = _jacobi_wd(la0.pre)
    f32 = torch.float32
    Bi, Xi = (rand((A_la.n_pad // 128, LANES, 128), f32) for _ in range(2))
    Tcols = il.from_interleaved(Bi).T.contiguous()
    Xcols = il.from_interleaved(Xi).T.contiguous()
    A_la_csr, S_la_csr = dia_to_csr(A_la), dia_to_csr(S_la)
    itag = f"lane-aligned level0 n_pad={A_la.n_pad} K={LANES}"
    for name, op, kern, plain, cost, lib in (
            ("int_jacobi_zero_res", A_la,
             lambda: il.int_jacobi_zero_res(A_la, wd_la, Bi),
             lambda: il.int_jacobi_zero_res_ref(A_la, wd_la, Bi),
             dia_cost(A_la, 1, LANES, 3, extra_ops=2), None),
            ("int_spmv_scaled", St_la,
             lambda: il.int_spmv_scaled(St_la, Bi, tv_la),
             lambda: il.int_spmv_scaled_ref(St_la, Bi, tv_la),
             dia_cost(St_la, 1, LANES, 2, extra_ops=1), None),
            ("int_spmv", A_la, lambda: il.int_spmv(A_la, Bi),
             lambda: il.int_spmv_ref(A_la, Bi), dia_cost(A_la, 0, LANES, 2),
             lambda: torch.sparse.mm(A_la_csr, Tcols)),
            ("int_spmv_add", S_la, lambda: il.int_spmv_add(S_la, Bi, Xi),
             lambda: il.int_spmv_add_ref(S_la, Bi, Xi),
             dia_cost(S_la, 0, LANES, 3, extra_ops=1),
             lambda: torch.addmm(Xcols, S_la_csr, Tcols)),
            ("int_jacobi_step", A_la,
             lambda: il.int_jacobi_step(A_la, wd_la, Bi, Xi),
             lambda: il.int_jacobi_step_ref(A_la, wd_la, Bi, Xi),
             dia_cost(A_la, 1, LANES, 3, extra_ops=3), None)):
        compare(check, f"{name}.float32 [{itag} nd={op.ndiags}]", f32, kern,
                plain, results, *cost, library_fn=lib)

    # 5b. K16 at host level 0: ring of one and in-process shards vs K1
    halo_phase(check, h, rand, results)

    # 6. small input: the float64 host-built solve on the card against the
    # same hierarchy copied to the CPU (the plain twins), every level kept
    A_s = poisson((128, 128), format="csr")
    ml_s = smoothed_aggregation_solver(A_s, **config1)
    b_s = np.random.default_rng(6).random(A_s.shape[0])
    d_s = as_device_solver(ml_s, dtype=torch.float64, device=dev)
    c_s = DeviceMultilevelSolver(to_device(d_s.hierarchy, "cpu"))
    res_d, res_h = [], []
    d_s.solve(b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_d)
    c_s.solve(b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_h)
    m = min(len(res_d), len(res_h))
    hist_err = float(np.max(np.abs(np.subtract(res_d[:m], res_h[:m]))
                            / np.asarray(res_h[:m])))
    check(len(res_d) == len(res_h) and hist_err <= 1e-8,
          f"128^2 float64 CG on the card vs its CPU copy (twins): "
          f"{len(res_d) - 1} vs {len(res_h) - 1} iterations, history rel "
          f"diff {hist_err:.2e} (tol 1e-8)")

    # 7. and 8. config 1, host-built and device-built, with counters
    launches = {}
    solve_phase(check, "host-built config 1", dml, A,
                np.random.default_rng(1).random(n), REF_ITERS, launches)
    solve_phase(check, "device-built config 1", dsa, A,
                np.random.default_rng(0).random(n), REF_ITERS_DEVICE,
                launches)

    # 9. batched device-built config 1 (K8, K9, K11)
    batched_phase(check, "device-built batched config 1", dsa, A, launches,
                  REF_ITERS_BATCHED_1E5, REF_ITERS_DEVICE)
    # host-built (K10, K12, K13): the reference times no batched host-built
    # native solve; its mixed count is the 1-D host-built one
    batched_phase(check, "host-built batched config 1", dml, A, launches,
                  None, REF_ITERS)
    # the lane-aligned device-built hierarchy: the interleaved route (K15)
    # and the K-major mixed solve
    interleaved_phase(check, dla, A, launches)

    # 10. stationary V-cycles from a nonzero iterate, one right-hand side
    # (K4, K1 SPMV_SCALED) and K = 4 lanes (K9 + K8, K8 scale)
    A_st = poisson(STATIONARY_GRID, format="csr")
    d_st = device_sa_setup(A_st, grid=STATIONARY_GRID, dtype=torch.float32,
                           device=dev, max_coarse=400)
    rng_st = np.random.default_rng(2)
    stationary_phase(check, "device-built stationary", d_st,
                     rng_st.random(A_st.shape[0]), launches)
    stationary_phase(check, "device-built batched stationary", d_st,
                     rng_st.random((A_st.shape[0], STATIONARY_LANES)),
                     launches)

    # 11. one device-built V-cycle, on a vector and on a K = 8 stack, with
    # every host sync an error; then the batched solve's profile
    cycle = DeviceMultilevelSolver(hd).cycle_operator("V")
    sync_free_cycle(check, cycle, rand(hd.levels[0].n_pad, torch.float32),
                    "one vector (device-built)")
    sync_free_cycle(check, cycle, rand((LANES, hd.levels[0].n_pad),
                                       torch.float32),
                    f"a K={LANES} stack (device-built)")
    lane_cycle_times(check, dla, rand)
    Bp = torch.as_tensor(np.random.default_rng(3).random((n, LANES)),
                         device=dev)
    b0 = Bp[:, 0].contiguous()
    native, mixed = (dict(tol=1e-5, accel="cg"),
                     dict(tol=1e-8, accel="cg", precision="mixed"))
    profile_phase(f"2048^2, K={LANES}", (
        ("device-built batched native", lambda: dsa.solve(Bp, **native)),
        ("device-built batched mixed", lambda: dsa.solve(Bp, **mixed)),
        ("device-built 1-D native", lambda: dsa.solve(b0, **native)),
        ("host-built batched native", lambda: dml.solve(Bp, **native)),
        ("host-built batched mixed", lambda: dml.solve(Bp, **mixed)),
        ("interleaved batched native (lane-aligned)",
         lambda: dla.solve(Bp, **native))))

    # 12. the unstructured device setup and solve
    t_u = time.perf_counter()
    dus, A_un = unstructured_phase(check, dev, rand, results, launches)
    log(f"unstructured phases: {time.perf_counter() - t_u:.1f} s")

    # 13. row-sharded solves in a world of one NCCL rank
    t_s = time.perf_counter()
    sharded_phase(check, dev, dml, A, dus, A_un, launches)
    log(f"sharded phase: {time.perf_counter() - t_s:.1f} s")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    # 14. result lines: each path kernel instance, with its launches on
    # the paths that run it (``launches``: the first of them)
    rows = []
    for key in dict.fromkeys(k for ks in PATHS.values() for k in ks):
        base, dt = key.split(".")
        src, replaces = KERNELS[base]
        by_path = {p: launches[p][key] for p, ks in PATHS.items()
                   if key in ks}
        # the check at the shapes of the first path that launches it,
        # else the first check of this instance
        mine = [r for r in results if r["name"].startswith(key + " ")]
        r0 = next((r for r in mine if r["path"] == next(iter(by_path))),
                  mine[0])
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": next(iter(by_path.values())),
                     "launches_by_path": by_path,
                     "max_abs_err": r0["max_abs_err"], "ms": r0["ms"],
                     "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
                     "bound_by": r0["bound_by"],
                     "library_ms": r0["library_ms"], "shape": r0["name"]})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

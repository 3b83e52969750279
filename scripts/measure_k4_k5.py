"""K5 and K4 on the card, beside a parent checkout's kernels.

K5 (``dia_zero_chain``) and K4 (``dia_jacobi_res``) march strips of rows
through three stages with two rings in shared memory
(csrc/dia_chain.cu::chain_ring_kernel, ``sparse/dia.py::chain_plan``), or
run the per-row kernel for a shape the plan refuses.  For each path shape
and dtype this script:

- checks the bits: the strip march equal to the per-row kernel and across
  two launches, and with ``--parent DIR`` to the kernel built from the
  checkout DIR (its own ``_build.py``: one thread per row); and its error
  against the plain twin;
- times it by CUDA events (``chip_smoke.py::time_ms``, 30 calls) in the
  order parent, change, change, parent (the best of each pair), beside the
  per-row kernel, the plain twin, the composed alternative (K5: K3, then
  K1 ``SPMV_SCALED``; K4: K2, then K1 and b - A y) and the bound (bytes
  once at 3.35 TB/s);
- at levels 0 and 1, sweeps the strip march's launch (threads 256 / 512 /
  1024, rows a thread, CTAs an SM 1 to 4: the package's entry point with
  another plan) and times the one-off variants: 2 float32 rows a thread
  and K5 on 2-D tiles of the grid (``scripts/dia_chain_variants.cu``), and
  K11's
  strip march at K = 1 (``dia_zero_chain_k``); each must give the same
  bits.

Shapes: the device-built 2048^2 hierarchy (max_coarse=400), K5 on every
level with a restrictor in float32 and on levels 0 and 1 in float64, K4
on levels 0 and 1 in float32 and float64.

With ``--solves`` (needs ``--parent``) it then times whole solves in four
child processes, parent, change, change, parent, each importing its own
tree: the 1-D device-built config 1 solve (mixed CG to 1e-8, numpy in and
out, median of 5) and the device-built stationary solve (accel=None, 5
V-cycles, native float32, median of 5), with torch.profiler's busy share
and K5's and K4's kernel time and launches over one solve, and the host's
time per K5 call (500 calls at the coarsest level with a restrictor, no
sync).  The card's name and power limit, then one JSON line, end the
output.

    python scripts/measure_k4_k5.py [--parent DIR [--solves]]   # one GPU
"""
import argparse
import ctypes
import dataclasses
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

CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
SMS_CTAS = (1, 2, 3, 4)
THREADS = (256, 512, 1024)
# 2-D tiles (TY, TX) of the grid for K5's tile variant
TILES = ((8, 512), (16, 256), (32, 256), (16, 512), (32, 512))


def _scalar(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def _omega_args(omega, dtype):
    if isinstance(omega, torch.Tensor):
        return _scalar(dtype)(0.0), omega.data_ptr()
    return _scalar(dtype)(float(omega)), None


def parent_kernels(parent):
    """K5 and K4 of the checkout ``parent`` (its per-row kernels, built by
    its own _build.py): (A, St, b, dinv, tv, omega) -> (x, y) and (A, x,
    b, dinv, omega) -> (y, r)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def launch(mode, A, St, x, b, dinv, tv, omega, out0, out1):
        suffix = "f32" if A.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_dia_chain_{suffix}")
        fn.argtypes = [P, P, I, P, P, I, L, P, P, P, P, _scalar(A.dtype), P,
                       P, P, I, P]
        fn.restype = ctypes.c_int
        w, w_dev = _omega_args(omega, A.dtype)

        def ptr(t):
            return None if t is None else t.data_ptr()
        assert fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                  ptr(None if St is None else St.data),
                  None if St is None else St.offsets_t.data_ptr(),
                  0 if St is None else St.ndiags, A.n_pad, ptr(x), ptr(b),
                  ptr(dinv), ptr(tv), w, w_dev, out0.data_ptr(),
                  out1.data_ptr(), mode,
                  torch.cuda.current_stream().cuda_stream) == 0

    def k5(A, St, b, dinv, tv, omega):
        x, y = torch.empty_like(b), torch.empty_like(b)
        launch(0, A, St, None, b, dinv, tv, omega, x, y)
        return x, y

    def k4(A, x, b, dinv, omega):
        y, r = torch.empty_like(x), torch.empty_like(x)
        launch(1, A, None, x, b, dinv, None, omega, y, r)
        return y, r

    return k5, k4


def variants_library():
    """``scripts/dia_chain_variants.cu``, built once with the package's
    nvcc flags into the ignored ``pyamg_tpu_torch/_build/``."""
    from pyamg_tpu_torch import _build

    src = os.path.join(ROOT, "scripts", "dia_chain_variants.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in (src, os.path.join(ROOT, "pyamg_tpu_torch", "csrc",
                                "dia_chain.cu")):
        with open(p, "rb") as f:
            h.update(f.read())
    out = _build.BUILD_DIR / f"dia_chain_variants_{h.hexdigest()[:16]}.so"
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
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, sc in (("sweep_chain_ring_f32", ctypes.c_float),
                     ("sweep_chain_ring_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [I, I, P, P, I, P, P, I, I, I, I, I, I, I, I, P, P, P,
                       P, sc, P, P, P]
        fn.restype = ctypes.c_int
    fn = lib.sweep_zero_chain_tile_f32
    fn.argtypes = [P, P, I, P, P, I, I, I, I, I, I, I, P, P, P,
                   ctypes.c_float, P, P, P]
    fn.restype = ctypes.c_int
    return lib


def plan_with(base, n, sms, threads, vec, per_sm):
    """``base`` at another form: threads, rows a thread, and as many strips
    as sms * per_sm CTAs (none shorter than its own floor)."""
    p = dataclasses.replace(base, threads=threads, vec=vec)
    strips = max(1, min(sms * per_sm, n // max(p.step, 2 * (p.hl + p.hr))))
    strip = -(-(-(-n // strips)) // vec) * vec
    return dataclasses.replace(p, strip=strip, strips=-(-n // strip))


def run_ring_variant(lib, mode, plan, A, St, x, b, dinv, tv, w):
    """The variants library's strip march (any vec) by ``plan``."""
    sz = A.data.element_size()
    fn = getattr(lib, f"sweep_chain_ring_{'f32' if sz == 4 else 'f64'}")
    o0, o1 = torch.empty_like(b), torch.empty_like(b)
    Out = St if St is not None else A
    err = fn(mode, plan.vec, A.data.data_ptr(), A.offsets_t.data_ptr(),
             A.ndiags, Out.data.data_ptr(), Out.offsets_t.data_ptr(),
             Out.ndiags, A.n_pad, plan.threads, plan.strip, plan.al, plan.ar,
             plan.hl, plan.hr, None if x is None else x.data_ptr(),
             b.data_ptr(), dinv.data_ptr(),
             None if tv is None else tv.data_ptr(), float(w), o0.data_ptr(),
             o1.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err == 1:                   # cudaErrorInvalidValue: not this shape
        return None
    assert err == 0, (plan, err)
    return o0, o1


def run_tile(lib, A, St, b, dinv, tv, w, ty, tx):
    """K5 on 2-D tiles, the grid stride s and the halo (DY, DX) from St's
    offsets (the stride that makes each offset dy * s + dx smallest)."""
    def split(offsets, s):
        dy = [(o + s // 2) // s if o >= 0 else -((-o + s // 2) // s)
              for o in offsets]
        return max(abs(d) for d in dy), max(abs(o - d * s)
                                           for o, d in zip(offsets, dy))
    top = max(abs(o) for o in St.offsets)
    s = min(range(max(top - 2, 1), top + 1),
            key=lambda c: split(St.offsets, c)[::-1])
    dy, dx = split(St.offsets, s)
    x, y = torch.empty_like(b), torch.empty_like(b)
    err = lib.sweep_zero_chain_tile_f32(
        A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
        St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags, A.n_pad, s,
        ty, tx, dy, dx, b.data_ptr(), dinv.data_ptr(), tv.data_ptr(),
        float(w), x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err == 1:
        return None
    assert err == 0, (ty, tx, err)
    return x, y


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


def cases(dev):
    """(label, kernel, dtype, A, St, dinv, omega, tv, sweep) at the paths'
    shapes."""
    from pyamg_tpu_torch import device_sa_setup, poisson

    A = poisson(cs.GRID, format="csr")
    hd = device_sa_setup(A, grid=cs.GRID, dtype=torch.float32, device=dev,
                         max_coarse=400, mixed_precision=True).hierarchy
    out = []
    for i, lvl in enumerate(hd.levels):
        if lvl.P is None or getattr(lvl.R, "St", None) is None:
            continue
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float64 and i > 1:
                continue
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            Ad, St = as_dtype(lvl.A, dtype), as_dtype(lvl.R.St, dtype)
            tv = lvl.R.tv.to(dtype)
            out.append((f"device level{i}", "K5", dtype, Ad, St, dinv, omega,
                        tv, i <= 1))
            if i <= 1:
                out.append((f"device level{i}", "K4", dtype, Ad, None, dinv,
                            omega, None, i <= 1))
    return out


def measure(dev, rng, parent, lib):
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import dia

    sms = _build.sm_count(dev)
    ok, out = True, []
    for label, kern, dtype, A, St, dinv, omega, tv, sweep in cases(dev):
        n, sz = A.n_pad, A.data.element_size()
        b, x = (torch.as_tensor(rng.random(n), dtype=dtype, device=dev)
                for _ in range(2))
        w_host = float(omega)      # the variants take omega by value
        if kern == "K5":
            change = lambda: dia.dia_zero_chain(A, St, b, dinv, tv, omega)  # noqa
            plain = lambda: dia.dia_zero_chain_ref(A, St, b, dinv, tv, omega)  # noqa
            rows = lambda: dia._zero_chain_rows(A, St, b, dinv, tv, omega)  # noqa

            def composed():
                _, r = dia.dia_jacobi_zero_res(A, b, dinv, omega)
                return dia.dia_spmv_scaled(St, r, tv)
            pk = (lambda: parent[0](A, St, b, dinv, tv, omega)) \
                if parent else None
            outer, mode = St, 0
            nvals = A.ndiags + St.ndiags + 5
        else:
            change = lambda: dia.dia_jacobi_res(A, x, b, dinv, omega)  # noqa
            plain = lambda: dia.dia_jacobi_res_ref(A, x, b, dinv, omega)  # noqa
            rows = lambda: dia._jacobi_res_rows(A, x, b, dinv, omega)  # noqa

            def composed():
                y = dia.dia_jacobi(A, x, b, dinv, omega)
                return b - dia.dia_spmv(A, y)
            pk = (lambda: parent[1](A, x, b, dinv, omega)) if parent else None
            outer, mode = A, 1
            nvals = A.ndiags + 5
        plan = dia.chain_plan(A.offsets, outer.offsets, n, dtype, sms)
        got, want = change(), plain()
        rec = dict(shape=label, kernel=kern, dtype=str(dtype), n_pad=n,
                   offsets=list(A.offsets),
                   plan=None if plan is None else dict(
                       threads=plan.threads, vec=plan.vec, strip=plan.strip,
                       strips=plan.strips, caps=list(plan.caps),
                       smem=plan.smem(sz)),
                   rows_bits=same(got, rows()),
                   two_launches_equal=same(got, change()),
                   max_rel_err_twin=max(float((g - v).abs().max()
                                              / v.abs().max())
                                        for g, v in zip(got, want)),
                   bound_ms=nvals * n * sz / cs.PEAK_BYTES * 1e3)
        if pk is not None:
            rec["parent_bits"] = same(got, pk())
            rec["ms"], rec["parent_ms"] = turns(pk, change)
        else:
            rec["ms"] = min(cs.time_ms(change) for _ in range(2))
        rec["rows_ms"] = min(cs.time_ms(rows) for _ in range(2))
        rec["plain_ms"] = cs.time_ms(plain)
        rec["composed_ms"] = min(cs.time_ms(composed) for _ in range(2))
        ok &= (rec["rows_bits"] and rec["two_launches_equal"]
               and rec.get("parent_bits", True))
        rec["sweep"] = []
        if sweep and plan is not None:
            entries = []
            vecs = (1, 2, 4) if dtype == torch.float32 and n % 4 == 0 \
                else (1, 2)
            for threads in THREADS:
                for vec in vecs:
                    for per_sm in SMS_CTAS:
                        p = plan_with(plan, n, sms, threads, vec, per_sm)
                        if p.smem(sz) + 256 > dia._SMEM_BLOCK:
                            continue
                        in_pkg = vec in ((1, 4) if sz == 4 else (1, 2))
                        name = (f"{threads} threads x {vec}, {per_sm} "
                                f"CTA/SM ({p.strips} strips)")
                        if in_pkg:      # the package's entry point
                            run = (lambda p=p: _outputs(  # noqa: E731
                                dia, mode, p, A, St, x, b, dinv, tv, omega))
                        else:
                            run = (lambda p=p: run_ring_variant(  # noqa
                                lib, mode, p, A, St, x, b, dinv, tv, w_host))
                        entries.append((name, run))
            if kern == "K5":
                Bk = b.reshape(1, n)
                entries.append(("K11 strip march at K = 1", lambda: tuple(
                    t.reshape(n) for t in dia.dia_zero_chain_k(
                        A, St, Bk, dinv, tv, omega))))
                if dtype == torch.float32:
                    for ty, tx in TILES:
                        entries.append((
                            f"2-D tiles {ty}x{tx}",
                            (lambda ty=ty, tx=tx: run_tile(
                                lib, A, St, b, dinv, tv, w_host, ty, tx))))
            for name, run in entries:
                y = run()
                if y is None:
                    rec["sweep"].append(dict(form=name, ms=None))
                    continue
                s = dict(form=name, same_bits=same(y, got),
                         ms=min(cs.time_ms(run) for _ in range(2)))
                ok &= s["same_bits"]
                rec["sweep"].append(s)
        print(f"{kern} {json.dumps(rec)}", flush=True)
        out.append(rec)
    return ok, out


def _outputs(dia, mode, plan, A, St, x, b, dinv, tv, omega):
    """The package's strip march by ``plan`` (counted as "sweep")."""
    o0, o1 = torch.empty_like(b), torch.empty_like(b)
    dia._chain(mode, "sweep", plan, A, St if mode == 0 else None,
               None if mode == 0 else x, b, dinv, tv, omega, o0, o1)
    return o0, o1


_KERNEL_RE = re.compile(r"(chain_ring_kernel|zero_chain_kernel|"
                        r"jacobi_res_kernel)<(float|double)(?:, (\d))?")


def solves_of(tree):
    """Child process: the 1-D device-built solves on the package of
    ``tree``; one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from pyamg_tpu_torch import _build, device_sa_setup, poisson

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    A = poisson(cs.GRID, format="csr")
    dsa = device_sa_setup(A, grid=cs.GRID, dtype=torch.float32, device=dev,
                          max_coarse=400, mixed_precision=True)
    b = np.random.default_rng(0).random(A.shape[0])
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    stat = dict(tol=0.0, maxiter=5, accel=None, precision="native")
    runs = {"device-built config 1 (mixed, 1e-8)":
            lambda r=None: dsa.solve(b, residuals=r, **mixed),
            "device-built stationary (5 V-cycles)":
            lambda r=None: dsa.solve(b, residuals=r, **stat)}
    out = {}
    for label, fn in runs.items():
        res = []
        fn(res)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
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
            k5 = (m.group(1) == "zero_chain_kernel"
                  or (m.group(1) == "chain_ring_kernel"
                      and m.group(3) == "0"))
            name = f"{'K5' if k5 else 'K4'} " \
                   f"{'f32' if m.group(2) == 'float' else 'f64'}"
            if m.group(1) != "chain_ring_kernel":
                name += " (per-row)"
            ms, cnt = kern.get(name, (0.0, 0))
            kern[name] = (ms + t, cnt + 1)
        out[label] = dict(iterations=len(res) - 1,
                          relres=float(res[-1] / res[0]) if res else None,
                          wall_ms=float(np.median(walls)) * 1e3,
                          walls_ms=[w * 1e3 for w in walls],
                          profiled_wall_ms=wall * 1e3, kernel_ms=busy,
                          busy=busy / (wall * 1e3),
                          kernels={k: dict(ms=v[0], launches=v[1])
                                   for k, v in sorted(kern.items())})
    # the host's cost of one K5 call (wrapper and launch, no sync) at the
    # smallest level with a restrictor, where the card waits on the host
    from pyamg_tpu_torch.sparse import dia

    lvl = [lv for lv in dsa.hierarchy.levels
           if getattr(lv.R, "St", None) is not None][-1]
    dinv, omega = lvl.pre.arrays
    bl = torch.rand(lvl.A.n_pad, device=dev)

    def k5():
        return dia.dia_zero_chain(lvl.A, lvl.R.St, bl, dinv, lvl.R.tv, omega)
    for _ in range(20):
        k5()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        k5()
    out["host_us_per_k5_call"] = (time.perf_counter() - t0) / 500 * 1e6
    torch.cuda.synchronize()
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
    ap.add_argument("--parent", help="a checkout whose K5 / K4 bits the "
                    "kernels must equal, timed beside them")
    ap.add_argument("--solves", action="store_true", help="also time whole "
                    "solves, parent and change (needs --parent)")
    ap.add_argument("--solves-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_k4_k5: torch sees no CUDA device")
    if args.solves_of:
        solves_of(os.path.abspath(args.solves_of))
        return
    if args.solves and not args.parent:
        sys.exit("measure_k4_k5: --solves needs --parent")
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
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), k4_k5=recs,
                          solves=solves)))
    if not ok:
        sys.exit("measure_k4_k5: a kernel or a variant changed the bits")


if __name__ == "__main__":
    main()

"""K6 and K14 on the card, beside a parent checkout's kernels.

K6 (``windowed_matvec``) and K14 (``windowed_select``) are one kernel
template with a sum or a per-slot store epilogue
(csrc/window.cu::windowed_gather_kernel), launched by
``sparse/window.py::gather_plan``.  For each path shape and dtype this
script:

- checks the bits: K6 equal to the per-row kernel and, with ``--parent
  DIR``, to the kernel built from the checkout DIR (its own
  ``_build.py``), K14 equal to its twin and to the parent's kernel;
- times the kernel by CUDA events (``chip_smoke.py::time_ms``, 30 calls)
  in the order parent, change, change, parent (the best of each pair),
  beside the per-row kernel and K12 at K = 1 (both K6 only), an empty kernel
  launched with the plan's grid (the floor a launch of that grid reaches
  in this timer), the plain twin, one PyTorch call (``torch.mv`` of the
  operator in CSR for K6, ``torch.take`` for K14) and the bound (bytes
  once at 3.35 TB/s);
- sweeps the launch (16 bytes or 1 value a thread, threads a CTA, items
  a thread: the wrappers' launch with another plan) and times the
  one-off variant of ``scripts/window_variants.cu`` (each row block's
  window of x staged in shared memory) at the plan's form and at one or
  two CTAs a row block; each form must give the same bits;
- counts K6's and K14's launches per operator shape, and so per level, on
  each path: the host-built config 1 solve (mixed CG to 1e-8), the 640k
  unstructured setup (second call) and its float32 CG solve to 1e-6, and
  the routed float64 setup of the 200^2 jittered mesh.

Shapes: the host-built 2048^2 hierarchy's T (levels 0 and 1), the 640k
unstructured hierarchy's level-0 A and P and level-1 A (K6 float32; K14
float32 and float64 payloads on both A), the routed float64 hierarchy's
level-0 A and P (K6 float64; K14 float64 and float32 payloads on A).

With ``--solves`` (needs ``--parent``) it then times, in four child
processes, parent, change, change, parent, each importing its own tree:
the host-built config 1 solve (mixed CG to 1e-8, numpy in and out, median
of 5) and the 640k unstructured setup (second call, median of 3), with
torch.profiler's busy share and K6's and K14's kernel time and launches
over one more run.  The card's name and power limit, then one JSON line,
end the output.

    python scripts/measure_k6_k14.py [--parent DIR [--solves]]   # one GPU
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
THREADS = (64, 128, 256, 512, 1024)
ITEMS = (1, 2, 4, 8)


def parent_kernels(parent):
    """K6 and K14 of the checkout ``parent`` (one thread per row / entry,
    built by its own _build.py): (W, x) -> y and (W, x) -> out."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def fn(kind, dtype):
        f = getattr(lib, f"pyamg_windowed_{kind}_"
                         f"{'f32' if dtype == torch.float32 else 'f64'}")
        f.argtypes = ([P] if kind == "matvec" else []) + [P, P, I, I, I, L, P,
                                                          P, P]
        f.restype = ctypes.c_int
        return f

    def k6(W, x):
        y = torch.empty(W.n_pad, dtype=W.dtype, device=x.device)
        assert fn("matvec", W.dtype)(
            W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(), W.k,
            W.block, W.w2, W.n_pad, x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0
        return y

    def k14(W, x):
        out = torch.empty(W.idx.shape, dtype=x.dtype, device=x.device)
        assert fn("select", x.dtype)(
            W.idx.data_ptr(), W.starts.data_ptr(), W.k, W.block, W.w2,
            W.n_pad, x.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0
        return out

    return k6, k14


def turns(parent_fn, change_fn):
    """(change ms, parent ms): parent, change, change, parent."""
    t = [cs.time_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
    return min(t[1], t[2]), min(t[0], t[3])


def hierarchies(dev):
    """The three paths' solvers and operators: (dml, A), (dus, A_un),
    (routed solver, Ar)."""
    from pyamg_tpu_torch import (as_device_solver, device_sa_setup,
                                 device_unstructured_sa_setup, poisson,
                                 smoothed_aggregation_solver)

    A = poisson(cs.GRID, format="csr")
    ml = smoothed_aggregation_solver(A, **CONFIG1)
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    A_un = cs.fem_operator(cs.UNSTR_NX)
    dus = device_unstructured_sa_setup(A_un, device=dev,
                                       max_coarse=cs.UNSTR_MAX_COARSE)
    A0 = cs.fem_operator(cs.ROUTED_NX, jitter_seed=5)
    q = np.random.default_rng(11).permutation(A0.shape[0])
    Ar = A0[q][:, q].tocsr()
    rs = device_sa_setup(Ar, dtype=torch.float64, device=dev)
    return (dml, A), (dus, A_un), (rs, Ar)


def cases(h_host, h_un, h_routed):
    """(kernel, label, W, dtype) at the paths' shapes."""
    out = []
    for i in (0, 1):
        T = h_host.levels[i].P.ops[-1]
        out.append(("K6", f"host level{i} T", T, torch.float32))
    un0, un1 = h_un.levels[0], h_un.levels[1]
    for label, W in (("640k level0 A", un0.A), ("640k level0 P", un0.P),
                     ("640k level1 A", un1.A)):
        out.append(("K6", label, W, torch.float32))
    for label, W in (("640k level0 A", un0.A), ("640k level1 A", un1.A)):
        for dt in (torch.float32, torch.float64):
            out.append(("K14", label, W, dt))
    r0 = h_routed.levels[0]
    for label, W in (("routed level0 A", r0.A), ("routed level0 P", r0.P)):
        out.append(("K6", label, W, torch.float64))
    for dt in (torch.float64, torch.float32):
        out.append(("K14", "routed level0 A", r0.A, dt))
    return out


def variants_library():
    """``scripts/window_variants.cu``, built once with the package's nvcc
    flags into the ignored ``pyamg_tpu_torch/_build/``."""
    from pyamg_tpu_torch import _build

    src = os.path.join(ROOT, "scripts", "window_variants.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in (src, os.path.join(ROOT, "pyamg_tpu_torch", "csrc",
                                "window.cu")):
        with open(p, "rb") as f:
            h.update(f.read())
    out = _build.BUILD_DIR / f"window_variants_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(tmp), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "staged" in line or "spill" in line:
                print(f"ptxas (variants): {line.strip()}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("variant_gather_staged_f32", "variant_gather_staged_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [I, P, P, P, I, I, I, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return lib


def run_staged(lib, W, x, plan):
    """The staged variant by ``plan``; None where the window does not fit
    a CTA's shared memory."""
    from pyamg_tpu_torch.sparse import window

    out = torch.empty(W.idx.shape if plan.select else (W.n_pad,),
                      dtype=x.dtype, device=x.device)
    fn = getattr(lib, "variant_gather_staged_"
                      f"{'f32' if x.dtype == torch.float32 else 'f64'}")
    err = fn(window._GATHER_SELECT if plan.select else window._GATHER_SUM,
             None if plan.select else W.data.data_ptr(), W.idx.data_ptr(),
             W.starts.data_ptr(), W.k, W.block, W.w2, plan.n_blocks,
             plan.vec, plan.threads, plan.ctas_per_block, plan.items,
             x.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err == 1:                   # cudaErrorInvalidValue: no room
        return None
    assert err == 0, (plan, err)
    return out


def with_form(base, per_block, vec, threads, cpb):
    """``base`` at ``vec`` values an item, ``threads`` a CTA and ``cpb``
    CTAs a row block (the items spread evenly, none of the CTAs empty)."""
    items = -(-per_block // cpb)
    return dataclasses.replace(base, vec=vec, threads=threads, items=items,
                               ctas_per_block=-(-per_block // items))


def forms(W, base, x):
    """Launch forms for the sweep: ``base`` with another vec, threads
    and items a thread; and the forms the staged variant is timed at."""
    sz = x.element_size()
    sweep, staged = [], [base]
    for vec in sorted({1, 16 // sz}):
        if W.block % vec:
            continue
        per_block = (W.k * W.block if base.select else W.block) // vec
        for threads in THREADS:
            for per_thread in ITEMS:
                sweep.append(with_form(base, per_block, vec, threads, max(
                    1, -(-per_block // (threads * per_thread)))))
        for cpb in (1, 2):                 # one or two CTAs a row block
            staged.append(with_form(base, per_block, vec, min(
                1024, -(-per_block // cpb // 32) * 32), cpb))
    uniq = lambda ps: list(dict.fromkeys(ps))  # noqa: E731
    return [p for p in uniq(sweep) if p != base], uniq(staged)


def measure(dev, rng, parent, hs):
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    lib = _build.library()
    lib_v = variants_library()
    (dml, _), (dus, _), (rs, _) = hs
    ok, out = True, []
    for kern, label, W, dtype in cases(dml.hierarchy, dus.hierarchy,
                                       rs.hierarchy):
        m = W.m_chunks * W.w2
        sz = torch.empty((), dtype=dtype).element_size()
        x = torch.as_tensor(rng.random(m), dtype=dtype, device=dev)
        select = kern == "K14"
        if select:
            change = lambda: window.windowed_select(W, x)  # noqa: E731
            plain = lambda: window.windowed_select_ref(W, x)  # noqa: E731
            rows = None
            gidx = window._global_index(W)
            library = lambda: torch.take(x, gidx)  # noqa: E731
            pk = (lambda: parent[1](W, x)) if parent else None
            nbytes = W.idx.numel() * (4 + sz) + W.starts.numel() * 4 + m * sz
            out_t = torch.empty(W.idx.shape, dtype=dtype, device=dev)
        else:
            assert W.dtype == dtype
            change = lambda: window.windowed_matvec(W, x)  # noqa: E731
            plain = lambda: window.windowed_matvec_ref(W, x)  # noqa: E731
            rows = lambda: window._windowed_matvec_rows(W, x)  # noqa: E731
            W_csr = cs.windowed_to_csr(W)
            library = lambda: torch.mv(W_csr, x)  # noqa: E731
            pk = (lambda: parent[0](W, x)) if parent else None
            nbytes = (W.data.numel() * sz + (W.idx.numel()
                      + W.starts.numel()) * 4 + (m + W.n_pad) * sz)
            out_t = torch.empty(W.n_pad, dtype=dtype, device=dev)
            xk = x.reshape(1, m)
            k12 = lambda: window.windowed_matmat_k(W, xk)  # noqa: E731
        plan = window._gather_plan_for(W, x, out_t, select)
        got = change()
        want = plain()
        torch.cuda.synchronize()
        rec = dict(kernel=kern, shape=label, dtype=str(dtype), n_pad=W.n_pad,
                   k=W.k, block=W.block, w2=W.w2,
                   plan=dataclasses.asdict(plan),
                   two_launches_equal=torch.equal(got, change()),
                   max_rel_err_twin=float((got - want).abs().max()
                                          / want.abs().max()),
                   twin_exact=torch.equal(got, want),
                   bound_ms=nbytes / cs.PEAK_BYTES * 1e3)
        if pk is not None:
            rec["parent_bits"] = torch.equal(got, pk())
            rec["ms"], rec["parent_ms"] = turns(pk, change)
        else:
            rec["ms"] = min(cs.time_ms(change) for _ in range(2))
        rec["share"] = rec["bound_ms"] / rec["ms"]
        if rows is not None:
            rec["rows_bits"] = torch.equal(got, rows())
            rec["rows_ms"] = min(cs.time_ms(rows) for _ in range(2))
        rec["plain_ms"] = cs.time_ms(plain)
        rec["library_ms"] = min(cs.time_ms(library) for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream
        rec["empty_ms"] = min(cs.time_ms(lambda: _build.check(
            "pyamg_empty_launch", lib.pyamg_empty_launch(
                plan.grid, plan.threads, stream))) for _ in range(2))
        if not select:
            y12 = k12().reshape(-1)
            rec["k12_bits"] = torch.equal(y12, got)
            rec["k12_ms"] = min(cs.time_ms(k12) for _ in range(2))
        ok &= (rec["two_launches_equal"] and rec.get("parent_bits", True)
               and (rec["twin_exact"] if select else rec["rows_bits"]))
        rec["sweep"], rec["staged"] = [], []
        sweep, staged = forms(W, plan, x)
        for p in sweep:
            y = window._gather(W, x, torch.empty_like(out_t), p)
            s = dict(plan=dataclasses.asdict(p),
                     same_bits=torch.equal(y, got),
                     ms=min(cs.time_ms(lambda p=p: window._gather(
                         W, x, torch.empty_like(out_t), p))
                            for _ in range(2)))
            ok &= s["same_bits"]
            rec["sweep"].append(s)
        rec["best_form"] = min(rec["sweep"] + [dict(
            plan=dataclasses.asdict(plan), ms=rec["ms"])],
            key=lambda s: s["ms"])
        for p in staged:
            y = run_staged(lib_v, W, x, p)
            if y is None:
                continue
            s = dict(plan=dataclasses.asdict(p),
                     same_bits=torch.equal(y, got),
                     ms=min(cs.time_ms(lambda p=p: run_staged(
                         lib_v, W, x, p)) for _ in range(2)))
            ok &= s["same_bits"]
            rec["staged"].append(s)
        print(f"{kern} {json.dumps(rec)}", flush=True)
        out.append(rec)
    return ok, out


def level_names(h):
    """n_pad -> "level i" (A, or P, of level i) for a hierarchy."""
    names = {}
    for i, lv in enumerate(h.levels):
        for op in (lv.A, getattr(lv, "P", None)):
            n = getattr(op, "n_pad", None)
            if n is not None:
                names.setdefault(n, f"level{i}")
        names.setdefault(lv.n_pad, f"level{i}")
    return names


def launches_per_level(dev, hs):
    """K6's and K14's launches by operator shape on each path (the wrapper
    calls tallied by the operator's n_pad, k and the dtype)."""
    from pyamg_tpu_torch import (_build, device_sa_setup,
                                 device_unstructured_sa_setup)
    from pyamg_tpu_torch.sparse import window

    (dml, A), (dus, A_un), (rs, Ar) = hs
    tally = {}
    originals = {"K6": window.windowed_matvec, "K14": window.windowed_select}

    def wrap(kern):
        def call(W, x):
            key = (kern, W.n_pad, W.k, str(x.dtype).removeprefix("torch."))
            tally[key] = tally.get(key, 0) + 1
            return originals[kern](W, x)
        return call

    runs = {
        "host-built config 1 (mixed CG to 1e-8)": (dml.hierarchy, lambda:
            dml.solve(np.random.default_rng(1).random(A.shape[0]), tol=1e-8,
                      maxiter=100, accel="cg", precision="mixed")),
        "640k unstructured setup (second call)": (dus.hierarchy, lambda:
            device_unstructured_sa_setup(A_un, device=dev,
                                         max_coarse=cs.UNSTR_MAX_COARSE)),
        "640k unstructured solve (f32 CG to 1e-6)": (dus.hierarchy, lambda:
            dus.solve(np.random.default_rng(0).standard_normal(
                A_un.shape[0]), tol=1e-6, maxiter=100, accel="cg")),
        "routed float64 setup": (rs.hierarchy, lambda: device_sa_setup(
            Ar, dtype=torch.float64, device=dev)),
    }
    out = {}
    window.windowed_matvec, window.windowed_select = wrap("K6"), wrap("K14")
    try:
        for label, (h, fn) in runs.items():
            tally.clear()
            _build.reset_launches()
            fn()
            torch.cuda.synchronize()
            names = level_names(h)
            rows = [dict(kernel=k, n_pad=n, k=kk, dtype=dt,
                         level=names.get(n, "other"), launches=c)
                    for (k, n, kk, dt), c in sorted(tally.items())]
            # the wrappers' own counts, which the tally must add up to
            counted = {key: c for key, c in _build.launches.items()
                       if key.startswith(("windowed_matvec",
                                          "windowed_select"))}
            print(f"launches {label}: {json.dumps(rows)}; counted "
                  f"{json.dumps(counted, sort_keys=True)}", flush=True)
            out[label] = dict(by_shape=rows, counted=counted)
    finally:
        window.windowed_matvec = originals["K6"]
        window.windowed_select = originals["K14"]
    return out


_KERNEL_RE = re.compile(r"(windowed_matvec_kernel|windowed_select_kernel|"
                        r"windowed_gather_kernel|windowed_matvec_rows_kernel)"
                        r"<(float|double)"
                        r"(?:, (\d+), (\d+))?")


def profiled(fn):
    """(wall ms, device ms, {K6 / K14 name: (ms, launches)}) of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kern = 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.device_time_total / 1e3
        busy += t
        m = _KERNEL_RE.search(e.name)
        if m is None:
            continue
        k14 = ("select" in m.group(1)
               or (m.group(1) == "windowed_gather_kernel"
                   and m.group(4) == "1"))
        name = f"{'K14' if k14 else 'K6'} " \
               f"{'f32' if m.group(2) == 'float' else 'f64'}"
        ms, cnt = kern.get(name, (0.0, 0))
        kern[name] = (ms + t, cnt + 1)
    return wall, busy, {k: dict(ms=v[0], launches=v[1])
                        for k, v in sorted(kern.items())}


def solves_of(tree):
    """Child process: the host-built config 1 solve and the 640k setup on
    the package of ``tree``; one JSON line."""
    from pyamg_tpu_torch import (_build, as_device_solver,
                                 device_unstructured_sa_setup, poisson,
                                 smoothed_aggregation_solver)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    A = poisson(cs.GRID, format="csr")
    dml = as_device_solver(smoothed_aggregation_solver(A, **CONFIG1),
                           device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    b = np.random.default_rng(1).random(A.shape[0])
    A_un = cs.fem_operator(cs.UNSTR_NX)
    runs = {"host-built config 1 (mixed, 1e-8)": (5, lambda r=None: dml.solve(
                b, tol=1e-8, maxiter=100, accel="cg", precision="mixed",
                residuals=r)),
            "640k unstructured setup (second call)": (3, lambda r=None:
                device_unstructured_sa_setup(
                    A_un, device=dev, max_coarse=cs.UNSTR_MAX_COARSE))}
    out = {}
    for label, (reps, fn) in runs.items():
        res = []
        fn(res)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, busy, kern = profiled(fn)
        out[label] = dict(iterations=len(res) - 1 if res else None,
                          wall_ms=float(np.median(walls)), walls_ms=walls,
                          profiled_wall_ms=wall, kernel_ms=busy,
                          busy=busy / wall, kernels=kern)
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
    ap.add_argument("--parent", help="a checkout whose K6 / K14 bits the "
                    "kernels must equal, timed beside them")
    ap.add_argument("--solves", action="store_true", help="also time the "
                    "host-built solve and the 640k setup, parent and change "
                    "(needs --parent)")
    ap.add_argument("--solves-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_k6_k14: torch sees no CUDA device")
    if args.solves_of:
        solves_of(os.path.abspath(args.solves_of))
        return
    if args.solves and not args.parent:
        sys.exit("measure_k6_k14: --solves needs --parent")
    from pyamg_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    parent = parent_kernels(os.path.abspath(args.parent)) if args.parent \
        else None
    _build.library()
    for line in _build.build_info.get("log", "").splitlines():
        if ("Used" in line or "spill" in line or "Compiling" in line) and (
                "window" in line or "gather" in line or "bytes" in line):
            print(f"ptxas: {line.strip()}")
    hs = hierarchies(dev)
    ok, recs = measure(dev, np.random.default_rng(0), parent, hs)
    per_level = launches_per_level(dev, hs)
    solves = measure_solves(os.path.abspath(args.parent)) if args.solves \
        else None
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), k6_k14=recs,
                          launches=per_level, solves=solves)))
    if not ok:
        sys.exit("measure_k6_k14: a kernel or a launch form changed the bits")


if __name__ == "__main__":
    main()

"""K7 and K11 on the card, beside a parent checkout's kernels.

K7 (``windowed_rmatvec``, csrc/window.cu) sums each output column of a
windowed operator's transpose in plan order, one thread per column for
short columns, else from products that a CTA forms in parallel for a tile
of whole columns.  K11 (``dia_zero_chain_k``,
csrc/dia_k.cu) marches strips of rows with a ring of the residual in
shared memory (``sparse/dia.py::k11_plan``), or runs its per-row kernel
when St's reach is too large for the ring.  For each path shape this
script:

- checks the bits: K7 equal to the CPU twin and across two launches; K11's
  ring equal to its per-row kernel; with ``--parent DIR`` both equal to the
  kernels built from the checkout DIR (its own ``_build.py`` and C
  interface: K7 one thread per column, K11 one thread per row in 16-lane
  chunks);
- times them by CUDA events (``chip_smoke.py::time_ms``, 30 calls) in the
  order parent, change, change, parent (the best of each pair), beside
  K7's yardsticks (``torch.mv`` of the CSR transpose; K13 on a one-lane
  stack, the tile kernel it started from) and K11's composed alternative
  (K10, then K8's ``scale``: the residual stored and read back), each with
  its bound (bytes once at 3.35 TB/s);
- times K7's two forms (one thread per column, tiles) at every shape, and
  sweeps the launch choices (K7's tile budget and columns per tile; K11's
  strip count, and the one-off variants of
  ``scripts/zero_chain_k_variants.cu``: threads and CTAs per SM, lanes per
  group, unrolled term loops, and 2-D tiles of the grid in place of the
  strip march, plain and with the package's L2 hints and unrolled loops),
  each checked to give the same bits.

K11 shapes: the device-built 2048^2 hierarchy's levels 0 and 1 (float32
and float64, K = 8) and the lane-aligned hierarchy's level 1 (the
interleaved route's K11, float32).  K7 shapes: the host-built level-0 Tᵀ
(float32), the 640k unstructured hierarchy's level-0 Aᵀ and Pᵀ and
level-1 Aᵀ (float32), the routed hierarchy's level-0 Aᵀ and Pᵀ (float64).

With ``--solves`` (needs ``--parent``) it then times whole solves in four
child processes, parent, change, change, parent, each importing its own
tree: the device-built batched native solve (2048^2, K = 8, f32 CG to
1e-5), the interleaved one on the lane-aligned hierarchy, and the 640k
unstructured f32 CG to 1e-6 (median of 3 walls, ``b`` on the card), with
torch.profiler's busy share and K7's / K11's kernel time over one solve.
The card's name and power limit, then one JSON line, end the output.

    python scripts/measure_k7_k11.py [--parent DIR [--solves]]   # one GPU
"""
import argparse
import ctypes
import dataclasses
import hashlib
import importlib.util
import json
import os
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


def _ctypes_scalar(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def _omega_args(omega, dtype):
    if isinstance(omega, torch.Tensor):
        return _ctypes_scalar(dtype)(0.0), omega.data_ptr()
    return _ctypes_scalar(dtype)(float(omega)), None


def parent_kernels(parent):
    """K7 and K11 of the checkout ``parent``, built by its own _build.py,
    as callables k7(W, r) -> y and k11(A, St, Bk, dinv, tv, omega) -> (X,
    Y)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def k7(W, r):
        suffix = "f32" if W.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_windowed_rmatvec_{suffix}")
        fn.argtypes, fn.restype = [P, P, P, I, I, L, P, P, P], ctypes.c_int
        perm, colptr = W.column_plan
        m = W.m_chunks * W.w2
        y = torch.empty(m, dtype=W.dtype, device=r.device)
        assert fn(W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(), W.k,
                  W.block, m, r.data_ptr(), y.data_ptr(),
                  torch.cuda.current_stream().cuda_stream) == 0
        return y

    def k11(A, St, Bk, dinv, tv, omega):
        suffix = "f32" if A.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_dia_zero_chain_k_{suffix}")
        fn.argtypes = [P, P, I, P, P, I, L, I, P, P, P,
                       _ctypes_scalar(A.dtype), P, P, P, P]
        fn.restype = ctypes.c_int
        w, w_dev = _omega_args(omega, A.dtype)
        X, Y = torch.empty_like(Bk), torch.empty_like(Bk)
        for k0 in range(0, Bk.shape[0], 16):
            k1 = min(Bk.shape[0], k0 + 16)
            assert fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                      St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags,
                      A.n_pad, k1 - k0, Bk[k0:k1].data_ptr(), dinv.data_ptr(),
                      tv.data_ptr(), w, w_dev, X[k0:k1].data_ptr(),
                      Y[k0:k1].data_ptr(),
                      torch.cuda.current_stream().cuda_stream) == 0
        return X, Y

    return k7, k11


def k7_with(W, r, budget, cols):
    """The package's K7 in its tile form over a tile table of ``budget``
    entries and ``cols`` columns (the wrapper's choice: window._K7_COLS
    columns, tile_budget's budget but at least window._K7_MIN_BUDGET)."""
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    perm, colptr = W.column_plan
    key = ("k7 sweep", budget, cols)
    if key not in W._tile_tables:
        W._tile_tables[key] = window.column_tile_table(
            colptr, perm.numel(), budget, cols)
    tiles = W._tile_tables[key]
    m = W.m_chunks * W.w2
    y = torch.empty(m, dtype=W.dtype, device=r.device)
    fn_name = (f"pyamg_windowed_rmatvec_tiles_"
               f"{window._KERNEL_SUFFIX[W.dtype]}")
    err = getattr(_build.library(), fn_name)(
        W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(),
        tiles.data_ptr(), tiles.numel() - 1, budget, cols, W.k, W.block,
        r.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(fn_name, err)
    return y


def k7_by_column(W, r):
    """The package's K7 in its one-thread-per-column form."""
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    perm, colptr = W.column_plan
    m = W.m_chunks * W.w2
    y = torch.empty(m, dtype=W.dtype, device=r.device)
    fn_name = f"pyamg_windowed_rmatvec_{window._KERNEL_SUFFIX[W.dtype]}"
    err = getattr(_build.library(), fn_name)(
        W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(), W.k, W.block,
        m, r.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(fn_name, err)
    return y


def k11_with(A, St, Bk, dinv, tv, omega, plan):
    from pyamg_tpu_torch.sparse import dia

    X, Y = torch.empty_like(Bk), torch.empty_like(Bk)
    dia._zero_chain_k_ring(A, St, Bk, dinv, tv, omega, X, Y, plan)
    return X, Y


def k11_rows(A, St, Bk, dinv, tv, omega):
    from pyamg_tpu_torch.sparse import dia

    X, Y = torch.empty_like(Bk), torch.empty_like(Bk)
    dia._zero_chain_k_rows(A, St, Bk, dinv, tv, omega, X, Y)
    return X, Y


# the one-off variants of scripts/zero_chain_k_variants.cu: id ->
# (threads per CTA, CTAs per SM at most, term loops unrolled for nd = 5)
K11_VARIANTS = {0: (1024, 1, False), 1: (1024, 1, True), 2: (512, 2, False),
                3: (512, 2, True), 4: (512, 1, False), 5: (256, 4, False),
                6: (256, 2, False)}
SMEM_SM = 233472                     # an H100 SM's 228 KB


def variants_library():
    """``scripts/zero_chain_k_variants.cu``, built once with the package's
    nvcc flags into the ignored ``pyamg_tpu_torch/_build/``."""
    from pyamg_tpu_torch import _build

    src = os.path.join(ROOT, "scripts", "zero_chain_k_variants.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            _build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"zero_chain_k_variants_{digest}.so"
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
    return ctypes.CDLL(str(out))


def k11_variants(lib):
    """The strip-march variants as a callable (variant, A, St, Bk, dinv,
    tv, omega, group, step, strips) -> (X, Y)."""
    fn = lib.sweep_zero_chain_k_ring_f32
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, I, P, P, I, L, I, I, I, L, I, I, P, P, P,
                   ctypes.c_float, P, P, P]
    fn.restype = ctypes.c_int

    def run(variant, A, St, Bk, dinv, tv, omega, group, step, strips):
        n = A.n_pad
        strip = -(-n // strips)
        hl, hr = max(0, -min(St.offsets)), max(0, max(St.offsets))
        X, Y = torch.empty_like(Bk), torch.empty_like(Bk)
        err = fn(variant, A.data.data_ptr(), A.offsets_t.data_ptr(),
                 A.ndiags, St.data.data_ptr(), St.offsets_t.data_ptr(),
                 St.ndiags, n, Bk.shape[0], group, step, strip, hl, hr,
                 Bk.data_ptr(), dinv.data_ptr(), tv.data_ptr(), float(omega),
                 X.data_ptr(), Y.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, (variant, group, step, strips, err)
        return X, Y

    return run


def k11_tile_variant(lib):
    """The 2-D tile schedule as a callable (tuned, A, St, Bk, dinv, tv,
    omega, group, TY, TX) -> (X, Y), tuned with the package's L2 hints and
    unrolled loops, with the grid stride s and St's reach in grid rows and
    columns taken from St's offsets."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.sweep_zero_chain_k_tile_f32
    fn.argtypes = [P, P, I, P, P, I, L, I, I, I, I, I, I, I, P, P, P,
                   ctypes.c_float, P, P, I, P]
    fn.restype = ctypes.c_int

    def split(offsets, s):
        dy = [(o + s // 2) // s if o >= 0 else -((-o + s // 2) // s)
              for o in offsets]
        return max(abs(d) for d in dy), max(abs(o - d * s)
                                           for o, d in zip(offsets, dy))

    def run(tuned, A, St, Bk, dinv, tv, omega, group, ty, tx):
        top = max(abs(o) for o in St.offsets)
        s = min(range(max(top - 2, 1), top + 1),
                key=lambda c: split(St.offsets, c)[::-1])
        dy, dx = split(St.offsets, s)
        X, Y = torch.empty_like(Bk), torch.empty_like(Bk)
        err = fn(A.data.data_ptr(), A.offsets_t.data_ptr(), A.ndiags,
                 St.data.data_ptr(), St.offsets_t.data_ptr(), St.ndiags,
                 A.n_pad, Bk.shape[0], group, s, ty, tx, dy, dx,
                 Bk.data_ptr(), dinv.data_ptr(), tv.data_ptr(), float(omega),
                 X.data_ptr(), Y.data_ptr(), int(tuned),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, (tuned, group, ty, tx, err)
        return X, Y

    return run


def k11_variant_configs(n, halo, K, nd, sms):
    """(variant, group, step, strips) settings that fit: each variant at 8,
    4 and 2 lanes per group and steps of 1 and 2 passes of its threads,
    with as many strips as the CTAs that fit on the card at once (by
    shared memory and the variant's CTAs per SM), none shorter than
    max(step, 2 * halo)."""
    out = []
    for v, (nt, minb, unroll) in K11_VARIANTS.items():
        if unroll and nd != 5:
            continue
        for group in (8, 4, 2):
            for step in (nt, 2 * nt):
                smem = (step + halo) * group * 4
                if smem > 232448:
                    continue
                per_sm = min(minb, 2048 // nt, SMEM_SM // (smem + 1024))
                groups = -(-K // group)
                strips = max(1, min(sms * per_sm // groups,
                                    -(-n // max(step, 2 * halo))))
                out.append((v, group, step, strips))
    return out


def turns(parent_fn, change_fn):
    """(change ms, parent ms): parent, change, change, parent."""
    t = [cs.time_ms(f) for f in (parent_fn, change_fn, change_fn, parent_fn)]
    return min(t[1], t[2]), min(t[0], t[3])


def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def k11_shapes(dev):
    from pyamg_tpu_torch import device_sa_setup, poisson

    A = poisson(cs.GRID, format="csr")
    kw = dict(grid=cs.GRID, dtype=torch.float32, device=dev, max_coarse=400,
              mixed_precision=True)
    hd = device_sa_setup(A, **kw).hierarchy
    hl = device_sa_setup(A, lane_align=True, **kw).hierarchy
    return [("device level0", hd.levels[0], (torch.float32, torch.float64)),
            ("device level1", hd.levels[1], (torch.float32, torch.float64)),
            ("lane-aligned level1", hl.levels[1], (torch.float32,))]


def k7_shapes(dev):
    from pyamg_tpu_torch import (as_device_solver, device_sa_setup,
                                 device_unstructured_sa_setup, poisson,
                                 smoothed_aggregation_solver)

    ml = smoothed_aggregation_solver(poisson(cs.GRID, format="csr"),
                                     **CONFIG1)
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    dus = device_unstructured_sa_setup(cs.fem_operator(cs.UNSTR_NX),
                                       device=dev,
                                       max_coarse=cs.UNSTR_MAX_COARSE)
    A0 = cs.fem_operator(cs.ROUTED_NX, jitter_seed=5)
    q = np.random.default_rng(11).permutation(A0.shape[0])
    rs = device_sa_setup(A0[q][:, q].tocsr(), dtype=torch.float64,
                         device=dev)
    u, r = dus.hierarchy.levels, rs.hierarchy.levels
    return [("host level0 Tt", dml.hierarchy.levels[0].P.ops[-1]),
            ("unstructured level0 At", u[0].A),
            ("unstructured level0 Pt", u[0].P),
            ("unstructured level1 At", u[1].A),
            ("routed level0 At", r[0].A), ("routed level0 Pt", r[0].P)]


def measure_k11(dev, rng, parent, ok, out):
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import DIAMatrix, dia

    def as_dtype(M, dtype):
        return DIAMatrix(data=M.data.to(dtype), offsets=M.offsets,
                         shape=M.shape, nnz=M.nnz)

    sms = _build.sm_count(dev)
    lib = variants_library()
    variants, tiles = k11_variants(lib), k11_tile_variant(lib)
    for name, lvl, dtypes in k11_shapes(dev):
        for dtype in dtypes:
            Ad, St = as_dtype(lvl.A, dtype), as_dtype(lvl.R.St, dtype)
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            tv = lvl.R.tv.to(dtype)
            n = Ad.n_pad
            Bk = torch.as_tensor(rng.random((LANES, n)), dtype=dtype,
                                 device=dev)
            args = (Ad, St, Bk, dinv, tv, omega)
            plan = dia.k11_plan(Ad.offsets, St.offsets, n, LANES, dtype, sms)
            change = lambda: dia.dia_zero_chain_k(*args)    # noqa: E731
            rows = lambda: k11_rows(*args)                   # noqa: E731

            def composed():
                X, R = dia.dia_jacobi_zero_res_k(Ad, Bk, dinv, omega)
                return X, dia.dia_spmm_scaled(St, R, tv)
            got = change()
            rec = dict(shape=name, dtype=str(dtype), n_pad=n,
                       offsets=list(Ad.offsets), soffsets=list(St.offsets),
                       plan=dataclasses.asdict(plan) if plan else None,
                       ring_equals_rows=same(got, rows()),
                       two_launches_equal=same(got, change()))
            want = dia.dia_zero_chain_k_ref(*args)
            rec["max_rel_err_twin"] = max(
                float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want))
            sz = Ad.data.element_size()
            rec["bound_ms"] = ((Ad.ndiags + St.ndiags + 2 + 3 * LANES) * n
                               * sz / cs.PEAK_BYTES * 1e3)
            if parent is not None:
                pk = lambda: parent[1](*args)               # noqa: E731
                rec["parent_bits"] = same(got, pk())
                rec["ms"], rec["parent_ms"] = turns(pk, change)
            else:
                rec["ms"] = min(cs.time_ms(change) for _ in range(2))
            rec["rows_ms"] = min(cs.time_ms(rows) for _ in range(2))
            rec["composed_ms"] = min(cs.time_ms(composed) for _ in range(2))
            ok &= (rec["ring_equals_rows"] and rec["two_launches_equal"]
                   and rec.get("parent_bits", True))
            if plan is not None and dtype == torch.float32:
                rec["variants"] = []
                halo = plan.hl + plan.hr
                for v, group, step, strips in k11_variant_configs(
                        n, halo, LANES, Ad.ndiags, sms):
                    fn = (lambda v=v, g=group, st=step, sp=strips:  # noqa
                          variants(v, *args, g, st, sp))
                    s = dict(variant=v, threads=K11_VARIANTS[v][0],
                             per_sm=K11_VARIANTS[v][1],
                             unrolled=K11_VARIANTS[v][2], group=group,
                             step=step, strips=strips,
                             same_bits=same(fn(), got),
                             ms=min(cs.time_ms(fn) for _ in range(2)))
                    ok &= s["same_bits"]
                    rec["variants"].append(s)
                rec["tiles"] = []
                for tuned, ty, tx in ((False, 16, 64), (False, 8, 128),
                                      (True, 16, 64), (True, 8, 128),
                                      (True, 32, 32)):
                    fn = (lambda t=tuned, a=ty, c=tx:      # noqa: E731
                          tiles(t, *args, 8, a, c))
                    s = dict(tuned=tuned, ty=ty, tx=tx,
                             same_bits=same(fn(), got),
                             ms=min(cs.time_ms(fn) for _ in range(2)))
                    ok &= s["same_bits"]
                    rec["tiles"].append(s)
                rec["sweep"] = []
                settings = [(plan.group, x) for x in sorted(
                    {max(plan.strips // 2, 1), plan.strips,
                     2 * plan.strips})]
                if plan.group > 4:         # 4 lanes, two CTAs per SM
                    settings += [(4, sms // 2), (4, sms)]
                for group, strips in settings:
                    strip = -(-n // strips)
                    p = dataclasses.replace(
                        plan, group=group, groups=-(-LANES // group),
                        strip=strip, strips=-(-n // strip))
                    if p.smem(sz) > dia._SMEM_BLOCK:
                        continue
                    fn = lambda p=p: k11_with(*args, p)   # noqa: E731
                    s = dict(group=group, strips=p.strips,
                             same_bits=same(fn(), got),
                             ms=min(cs.time_ms(fn) for _ in range(2)))
                    ok &= s["same_bits"]
                    rec["sweep"].append(s)
            print(f"K11 {json.dumps(rec)}", flush=True)
            out.append(rec)
    return ok


def measure_k7(dev, rng, parent, ok, out):
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    for name, W in k7_shapes(dev):
        r = torch.as_tensor(rng.random(W.n_pad), dtype=W.dtype, device=dev)
        W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                    starts=W.starts.cpu())
        change = lambda: window.windowed_rmatvec(W, r)      # noqa: E731
        k13 = lambda: window.windowed_rmatmat_k(W, r[None])  # noqa: E731
        Wt_csr = cs.windowed_to_csr(W, transpose=True)
        library = lambda: torch.mv(Wt_csr, r)               # noqa: E731
        got = change()
        budget = max(window.tile_budget(W.nnz, _build.sm_count(dev)),
                     window._K7_MIN_BUDGET)
        perm, colptr = W.column_plan
        lens = (colptr[1:] - colptr[:-1]).float()
        sz = W.data.element_size()
        meta = W.data.numel() * sz + (W.idx.numel() + W.starts.numel()) * 4
        m = W.m_chunks * W.w2
        by_column = lambda: k7_by_column(W, r)              # noqa: E731
        tiles = lambda: k7_with(W, r, budget, window._K7_COLS)  # noqa: E731
        rec = dict(shape=name, dtype=str(W.dtype), n=W.shape[0],
                   m=W.shape[1], k=W.k, live=int(colptr[-1]),
                   slots_per_column=W.data.numel() / m,
                   form=("tiles" if W.data.numel()
                         >= window._K7_TILE_SLOTS * m else "by column"),
                   by_column_bits=same(by_column(), got),
                   tiles_bits=same(tiles(), got),
                   columns=m, mean_column=float(lens.mean()),
                   max_column=int(lens.max()), budget=budget,
                   cols=window._K7_COLS,
                   cpu_twin_bits=same(got.cpu(), window.windowed_rmatvec_ref(
                       W_cpu, r.cpu())),
                   two_launches_equal=same(got, change()),
                   k13_one_lane_bits=same(k13()[0], got),
                   bound_ms=(meta + (m + W.n_pad) * sz) / cs.PEAK_BYTES
                   * 1e3)
        if parent is not None:
            pk = lambda: parent[0](W, r)                    # noqa: E731
            rec["parent_bits"] = same(pk(), got)
            rec["ms"], rec["parent_ms"] = turns(pk, change)
        else:
            rec["ms"] = min(cs.time_ms(change) for _ in range(2))
        rec["by_column_ms"] = min(cs.time_ms(by_column) for _ in range(2))
        rec["tiles_ms"] = min(cs.time_ms(tiles) for _ in range(2))
        rec["k13_one_lane_ms"] = min(cs.time_ms(k13) for _ in range(2))
        rec["library_ms"] = min(cs.time_ms(library) for _ in range(2))
        ok &= (rec["cpu_twin_bits"] and rec["two_launches_equal"]
               and rec["k13_one_lane_bits"] and rec["by_column_bits"]
               and rec["tiles_bits"] and rec.get("parent_bits", True))
        rec["sweep"] = []
        for b in sorted({budget // 2, budget, min(2 * budget, 4096)}):
            for cols in (128, 256, 512):
                fn = lambda b=b, c=cols: k7_with(W, r, b, c)   # noqa: E731
                s = dict(budget=b, cols=cols, same_bits=same(fn(), got),
                         ms=min(cs.time_ms(fn) for _ in range(2)))
                ok &= s["same_bits"]
                rec["sweep"].append(s)
        print(f"K7 {json.dumps(rec)}", flush=True)
        out.append(rec)
    return ok


def solves_of(tree):
    """Child process: the three solves on the package of ``tree``; one
    JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from pyamg_tpu_torch import (_build, device_sa_setup,
                                 device_unstructured_sa_setup, poisson)

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        _build.__file__)), tree)
    dev = torch.device("cuda", 0)
    A = poisson(cs.GRID, format="csr")
    kw = dict(grid=cs.GRID, dtype=torch.float32, device=dev, max_coarse=400,
              mixed_precision=True)
    dsa = device_sa_setup(A, **kw)
    dla = device_sa_setup(A, lane_align=True, **kw)
    dus = device_unstructured_sa_setup(cs.fem_operator(cs.UNSTR_NX),
                                       device=dev,
                                       max_coarse=cs.UNSTR_MAX_COARSE)
    Bt = torch.as_tensor(np.random.default_rng(3).random((A.shape[0], LANES)),
                         device=dev)
    bu = torch.as_tensor(np.random.default_rng(0).standard_normal(
        dus.hierarchy.levels[0].n), dtype=torch.float32, device=dev)
    runs = {
        "device-built batched native": lambda: dsa.solve(
            Bt, tol=1e-5, maxiter=100, accel="cg", precision="native"),
        "interleaved native": lambda: dla.solve(Bt, tol=1e-5, maxiter=100,
                                                accel="cg"),
        "640k unstructured f32": lambda: dus.solve(bu, tol=1e-6,
                                                   maxiter=100, accel="cg"),
    }
    out = {}
    for label, fn in runs.items():
        fn()
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
        busy = k7 = k11 = 0.0
        n7 = n11 = 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = e.device_time_total / 1e3
            busy += t
            if "windowed_rmatvec" in e.name:
                k7, n7 = k7 + t, n7 + 1
            elif "zero_chain_k_" in e.name:
                k11, n11 = k11 + t, n11 + 1
        out[label] = dict(wall_ms=float(np.median(walls)) * 1e3,
                          walls_ms=[w * 1e3 for w in walls],
                          profiled_wall_ms=wall * 1e3, kernel_ms=busy,
                          busy=busy / (wall * 1e3), k7_ms=k7, k7_launches=n7,
                          k11_ms=k11, k11_launches=n11)
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
    ap.add_argument("--parent", help="a checkout whose K7 / K11 bits the "
                    "kernels must equal, timed beside them")
    ap.add_argument("--solves", action="store_true", help="also time whole "
                    "solves, parent and change (needs --parent)")
    ap.add_argument("--solves-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_k7_k11: torch sees no CUDA device")
    if args.solves_of:
        solves_of(os.path.abspath(args.solves_of))
        return
    if args.solves and not args.parent:
        sys.exit("measure_k7_k11: --solves needs --parent")
    from pyamg_tpu_torch import _build

    dev = torch.device("cuda", 0)
    _build.library()
    for line in _build.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    parent = parent_kernels(os.path.abspath(args.parent)) if args.parent \
        else None
    rng = np.random.default_rng(0)
    k11, k7 = [], []
    ok = measure_k11(dev, rng, parent, True, k11)
    ok = measure_k7(dev, rng, parent, ok, k7)
    solves = measure_solves(os.path.abspath(args.parent)) if args.solves \
        else None
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), k11=k11,
                          k7=k7, solves=solves)))
    if not ok:
        sys.exit("measure_k7_k11: a kernel or a launch choice changed the "
                 "bits")


if __name__ == "__main__":
    main()

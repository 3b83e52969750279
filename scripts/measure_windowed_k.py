"""K12's and K13's thread mapping, measured on the card at the paths' shapes.

A K12 thread owns a row and 4 lanes (``kK12Lanes`` in csrc/window.cu),
rows fastest in a warp, ``window._K12_PAIRS`` (row, lane group) pairs to
a CTA.  A K13 thread owns a column and ``lt`` lanes (about
``window._K13_PAIR_BYTES`` of gathers down its column, see
``window._k13_mapping``), ``window._K13_PAIRS`` pairs to a tile,
consecutive columns of one lane group in a warp.  Two passes:

- the package's kernels under other values of the wrapper's constants
  (``_K12_PAIRS``, ``_K13_PAIR_BYTES``, ``_K13_PAIRS``);
- the one-off variants in ``scripts/windowed_k_variants.cu`` (built here
  by nvcc into the ignored ``pyamg_tpu_torch/_build/``): K12 at 2, 4 and 8
  lanes per thread, and K13 with ``group`` 1, 2 and 64 lane groups of one
  column consecutive in a warp (group 1 is the package's mapping), each
  at the wrapper's other choices.

For each setting this script times the kernel (CUDA events, the best of
two turns of 30 calls, as ``chip_smoke.py`` times) on:

- the 640k unstructured hierarchy's level-0 P and A at K = 64 (float32;
  the 800^2 P1 mesh plus 1e-2 I, max_coarse=1000, chip_smoke.py's case);
- the routed float64 hierarchy's level-0 P and A at K = 64 (the scrambled
  200^2 jittered mesh, RCM-reordered by device_sa_setup);
- the host-built config-1 hierarchy's level-0 T at K = 8 (float32, the
  batched solve's);

checks that every setting and variant gives the same bits (and, with ``--parent
DIR``, the bits of the kernels built from the checkout DIR, launched in
16-lane chunks through their own C interface, timed beside the chosen
setting in the order parent, change, change, parent), and prints the
sectors per request of the gathers as a model of the memory system's
coalescing: the distinct 32-byte sectors that the active threads of a
warp touch in one load (one lane of the t-th entry of their column or
slot), averaged over the warps, entries and lanes of 256 evenly spaced
CTAs.  The card's name and power limit, then one JSON line, end the
output.

    python scripts/measure_windowed_k.py [--parent DIR]   # one GPU
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SAMPLE_TILES = 256
# config 1's smoothers (the host-built hierarchy's T, at K = 8)
CONFIG1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
               postsmoother=("jacobi", {"omega": 4.0 / 3.0}))


def _warp_sectors(warp, addr, sz):
    """(distinct sectors, requests) of one load over the active threads."""
    key = warp * (1 << 40) + addr * sz // 32
    return np.unique(key).size, np.unique(warp).size


def k13_sectors(W, K, lt, group, cols):
    """Mean distinct 32-byte sectors per warp request of K13's r gathers
    (model: lane jj of the t-th entry of each active thread's column is
    one request)."""
    perm, colptr = (t.cpu().numpy().astype(np.int64) for t in W.column_plan)
    budget, tiles = W.column_tiles(cols)
    tiles = tiles.cpu().numpy().astype(np.int64)
    per_block = W.k * W.block
    sz = W.data.element_size()
    nonempty = np.flatnonzero(tiles[1:] > tiles[:-1])
    pick = nonempty[np.linspace(0, nonempty.size - 1,
                                min(SAMPLE_TILES, nonempty.size)).astype(int)]
    n_lg = -(-K // lt)
    sectors = requests = 0
    for t in pick:
        c0, c1 = tiles[t], tiles[t + 1]
        starts, ends = colptr[c0:c1], colptr[c0 + 1:c1 + 1]
        e = perm[starts[0]:ends[-1]]
        rows = (e // per_block) * W.block + e % W.block
        n_cols = c1 - c0
        if ends[-1] - starts[0] > budget:        # one long column
            cols, lanes0, width = np.zeros(K, dtype=np.int64), np.arange(K), 1
        else:
            p = np.arange(n_cols * group * (-(-n_lg // group)))
            q = p // group
            lg = (q // n_cols) * group + (p - q * group)
            keep = lg < n_lg
            cols, lanes0, width = (q % n_cols)[keep], lt * lg[keep], lt
        warp = np.arange(cols.size) // 32
        lens = ends[cols] - starts[cols]
        first = starts[cols] - starts[0]
        for step in range(int(lens.max())):
            for jj in range(width):
                on = (lens > step) & (lanes0 + jj < K)
                if on.any():
                    addr = ((lanes0[on] + jj) * W.n_pad
                            + rows[first[on] + step])
                    s_, r_ = _warp_sectors(warp[on], addr, sz)
                    sectors, requests = sectors + s_, requests + r_
    return sectors / requests


def k12_rows(W, K, lt):
    """Rows per K12 CTA at ``lt`` lanes per thread, as
    ``window._k12_rows`` chooses them for its 4."""
    from pyamg_tpu_torch.sparse import window

    groups = -(-min(K, window._LANE_TILE) // lt)
    rows = max(window._K12_PAIRS // groups, 1)
    rows = min(rows, max(window._SMEM_DEFAULT
                         // (W.k * (W.data.element_size() + 4)), 1))
    return math.gcd(1 << (rows.bit_length() - 1), W.block)


def k12_sectors(W, K, lt, rows):
    """The same model for K12's x gathers: a CTA's rows fastest, lane jj
    of one slot one request."""
    sz = W.data.element_size()
    idx = W.idx.cpu().numpy().astype(np.int64)
    starts = W.starts.cpu().numpy().astype(np.int64)
    m = W.m_chunks * W.w2
    n_ctas = W.n_pad // rows
    n_lg = -(-min(K, 64) // lt)
    sectors = requests = 0
    for c in np.linspace(0, n_ctas - 1, min(SAMPLE_TILES, n_ctas)).astype(int):
        blk, r0 = divmod(c * rows, W.block)
        p = np.arange(rows * n_lg)
        lanes0, rr, warp = lt * (p // rows), p % rows, p // 32
        for s in range(W.k):
            col = starts[blk] * W.w2 + idx[blk, s, r0 + rr]
            for jj in range(lt):
                on = lanes0 + jj < K
                s_, r_ = _warp_sectors(warp[on], (lanes0[on] + jj) * m
                                       + col[on], sz)
                sectors, requests = sectors + s_, requests + r_
    return sectors / requests


def parent_kernels(parent):
    """K12 and K13 of the checkout ``parent`` (its 16-lane-chunk C
    interface), built by its own _build.py, as callables (W, V) -> Y."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "pyamg_tpu_torch", "_build.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = ctypes.CDLL(str(pb.build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = {"matmat_k": [P, P, P, I, I, I, L, L, I, P, P, P],
           "rmatmat_k": [P, P, P, I, I, L, L, I, P, P, P]}

    def run(kind, W, V):
        suffix = "f32" if W.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"pyamg_windowed_{kind}_{suffix}")
        fn.argtypes, fn.restype = sig[kind], ctypes.c_int
        m = W.m_chunks * W.w2
        if kind == "matmat_k":
            head = (W.data.data_ptr(), W.idx.data_ptr(), W.starts.data_ptr(),
                    W.k, W.block, W.w2)
            Y = torch.empty(V.shape[0], W.n_pad, dtype=W.dtype,
                            device=V.device)
        else:
            perm, colptr = W.column_plan
            head = (W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(),
                    W.k, W.block)
            Y = torch.empty(V.shape[0], m, dtype=W.dtype, device=V.device)
        stream = torch.cuda.current_stream().cuda_stream
        for k0 in range(0, V.shape[0], 16):
            k1 = min(V.shape[0], k0 + 16)
            assert fn(*head, W.n_pad, m, k1 - k0, V[k0:k1].data_ptr(),
                      Y[k0:k1].data_ptr(), stream) == 0
        return Y

    return run


def variant_kernels():
    """The one-off K12 / K13 variants of ``windowed_k_variants.cu``,
    built with the package's nvcc flags, as callables
    (kind, W, V, lt, group) -> Y."""
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    src = os.path.join(ROOT, "scripts", "windowed_k_variants.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            _build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"windowed_k_variants_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(tmp), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = {"matmat_k": [P, P, P, I, I, I, L, L, I, I, I, P, P, P],
           "rmatmat_k": [P, P, P, P, I, I, I, I, I, L, L, I, I, I, P, P,
                         P]}

    def run(kind, W, V, lt, group=1):
        suffix = "f32" if W.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"sweep_windowed_{kind}_{suffix}")
        fn.argtypes, fn.restype = sig[kind], ctypes.c_int
        m, K = W.m_chunks * W.w2, V.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "matmat_k":
            Y = torch.empty(K, W.n_pad, dtype=W.dtype, device=V.device)
            err = fn(W.data.data_ptr(), W.idx.data_ptr(),
                     W.starts.data_ptr(), W.k, W.block, W.w2, W.n_pad, m, K,
                     k12_rows(W, K, lt), lt, V.data_ptr(), Y.data_ptr(),
                     stream)
        else:
            perm, colptr = W.column_plan
            _, cols = window._k13_mapping(W, K)
            budget, tiles = W.column_tiles(cols)
            Y = torch.empty(K, m, dtype=W.dtype, device=V.device)
            err = fn(W.data.data_ptr(), perm.data_ptr(), colptr.data_ptr(),
                     tiles.data_ptr(), tiles.numel() - 1, budget, cols, W.k,
                     W.block, W.n_pad, m, K, group, lt, V.data_ptr(),
                     Y.data_ptr(), stream)
        assert err == 0, (kind, err)
        return Y

    return run


class settings:
    """Set module attributes of ``window`` for a block, and rebuild the
    operator's tile table when its knobs change."""

    def __init__(self, W, **kv):
        self.W, self.kv = W, kv

    def __enter__(self):
        from pyamg_tpu_torch.sparse import window

        self.old = {k: getattr(window, k) for k in self.kv}
        for k, v in self.kv.items():
            setattr(window, k, v)
        self.W.__dict__.pop("_tile_tables", None)

    def __exit__(self, *exc):
        from pyamg_tpu_torch.sparse import window

        for k, v in self.old.items():
            setattr(window, k, v)
        self.W.__dict__.pop("_tile_tables", None)


def main():
    from pyamg_tpu_torch import (as_device_solver, device_sa_setup,
                                 device_unstructured_sa_setup, poisson,
                                 smoothed_aggregation_solver)
    from pyamg_tpu_torch.sparse import window

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose K12/K13 bits the "
                    "kernels must equal")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("measure_windowed_k: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    parent = parent_kernels(args.parent) if args.parent else None
    variant = variant_kernels()
    dus = device_unstructured_sa_setup(cs.fem_operator(cs.UNSTR_NX),
                                       device=dev,
                                       max_coarse=cs.UNSTR_MAX_COARSE)
    A0 = cs.fem_operator(cs.ROUTED_NX, jitter_seed=5)
    q = np.random.default_rng(11).permutation(A0.shape[0])
    rs = device_sa_setup(A0[q][:, q].tocsr(), dtype=torch.float64,
                         device=dev)
    shapes = []
    for where, h in (("unstructured", dus.hierarchy),
                     ("routed", rs.hierarchy)):
        lv0 = h.levels[0]
        for label, W in (("level0 P", lv0.P), ("level0 A", lv0.A)):
            shapes.append((f"{where} {label}", W, cs.PROBE_LANES))
    ml = smoothed_aggregation_solver(poisson(cs.GRID, format="csr"),
                                     **CONFIG1)
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=cs.COARSE_CUTOFF)
    shapes.append(("host level0 T", dml.hierarchy.levels[0].P.ops[-1],
                   cs.LANES))
    out = []
    ok = True
    for name, W, K in shapes:
        Rk = torch.as_tensor(rng.random((K, W.n_pad)), dtype=W.dtype,
                             device=dev)
        Xk = torch.as_tensor(rng.random((K, W.m_chunks * W.w2)),
                             dtype=W.dtype, device=dev)
        run12 = lambda: window.windowed_matmat_k(W, Xk)    # noqa: E731
        run13 = lambda: window.windowed_rmatmat_k(W, Rk)   # noqa: E731
        want12, want13 = run12(), run13()
        lt, cols = window._k13_mapping(W, K)
        budget, tiles = W.column_tiles(cols)
        row = dict(shape=name, n=W.shape[0], m=W.shape[1], k=W.k, K=K,
                   dtype=str(W.dtype), budget=budget, lt=lt, cols=cols,
                   tiles=tiles.numel() - 1,
                   nonempty_tiles=int((tiles[1:] > tiles[:-1]).sum()),
                   k12=[], k13=[], k12_lanes=[], k13_group=[])
        if parent is not None:
            row["k12_parent_bits"] = torch.equal(
                parent("matmat_k", W, Xk), want12)
            row["k13_parent_bits"] = torch.equal(
                parent("rmatmat_k", W, Rk), want13)
            ok &= row["k12_parent_bits"] and row["k13_parent_bits"]
            # parent, change, change, parent on this card
            t12, t13 = [], []
            for run in ("parent", "change", "change", "parent"):
                for kind, V, ts in (("matmat_k", Xk, t12),
                                    ("rmatmat_k", Rk, t13)):
                    fn = ((lambda kind=kind, V=V: parent(kind, W, V))
                          if run == "parent" else
                          (run12 if kind == "matmat_k" else run13))
                    ts.append(cs.time_ms(fn))
            row.update(k12_parent_ms=min(t12[0], t12[3]),
                       k12_ms=min(t12[1], t12[2]),
                       k13_parent_ms=min(t13[0], t13[3]),
                       k13_ms=min(t13[1], t13[2]))
            print(f"{name}: bits equal the parent's: K12 "
                  f"{row['k12_parent_bits']}, K13 {row['k13_parent_bits']}; "
                  f"K12 {row['k12_ms']:.4f} ms (parent "
                  f"{row['k12_parent_ms']:.4f}), K13 {row['k13_ms']:.4f} ms "
                  f"(parent {row['k13_parent_ms']:.4f})", flush=True)

        def measure(kind, want, run, knobs, sectors=None):
            with settings(W, **knobs):
                same = torch.equal(run(), want)
                ms = min(cs.time_ms(run) for _ in range(2))
                if kind == "k12":
                    extra = dict(rows=window._k12_rows(W, K))
                else:
                    lt, cols = window._k13_mapping(W, K)
                    b, t = W.column_tiles(cols)
                    extra = dict(lt=lt, cols=cols, budget=b,
                                 tiles=t.numel() - 1)
                if sectors is not None:
                    extra["sectors_per_request"] = sectors(**extra)
            rec = dict(knobs, ms=ms, same_bits=same, **extra)
            row[kind].append(rec)
            print(f"{name}: {kind.upper()} {json.dumps(rec)}", flush=True)
            return same

        for pairs in (512, 1024, 2048):
            ok &= measure("k12", want12, run12, dict(_K12_PAIRS=pairs),
                          (lambda rows: k12_sectors(W, K, 4, rows))
                          if pairs == 1024 else None)
        for pair_bytes, pairs in ((32, 1024), (64, 1024), (128, 1024),
                                  (256, 1024), (512, 1024), (128, 512),
                                  (128, 2048)):
            ok &= measure("k13", want13, run13, dict(
                _K13_PAIR_BYTES=pair_bytes, _K13_PAIRS=pairs),
                (lambda lt, cols, budget, tiles: k13_sectors(
                    W, K, lt, 1, cols)) if pairs == 1024 else None)

        # the one-off variants: K12's lanes per thread, K13's in-warp
        # mapping, each beside the package's choice
        def measure_variant(kind, want, run, **rec):
            same = torch.equal(run(), want)
            rec.update(ms=min(cs.time_ms(run) for _ in range(2)),
                       same_bits=same)
            row[kind].append(rec)
            print(f"{name}: {kind} {json.dumps(rec)}", flush=True)
            return same

        for vlt in (2, 4, 8):
            rows = k12_rows(W, K, vlt)
            ok &= measure_variant(
                "k12_lanes", want12,
                lambda vlt=vlt: variant("matmat_k", W, Xk, vlt),
                lt=vlt, rows=rows,
                sectors_per_request=k12_sectors(W, K, vlt, rows))
        for g in (1, 2, 64):
            ok &= measure_variant(
                "k13_group", want13,
                lambda g=g: variant("rmatmat_k", W, Rk, lt, g),
                group=g, lt=lt,
                sectors_per_request=k13_sectors(W, K, lt, g, cols))
        out.append(row)
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          shapes=out)))
    if not ok:
        sys.exit("measure_windowed_k: a mapping changed the bits")


if __name__ == "__main__":
    main()

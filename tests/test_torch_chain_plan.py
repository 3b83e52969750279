"""K4 and K5's strip-march plan and schedule, on the CPU.

K5 (``dia_zero_chain``) and K4 (``dia_jacobi_res``) march strips of rows
through three stages with two rings in shared memory
(csrc/dia_chain.cu::chain_ring_kernel), so each inner value is computed
once; the launch is a host function of A's and the outer operator's
offsets, n_pad, the dtype and the card's SM count
(``sparse/dia.py::chain_plan``).  These tests hold the plan to the
kernel's needs at the device-built 2048^2 hierarchy's real offsets (levels
0 and 1, plain and lane-aligned, float32 and float64): the strips cover
the rows once, each ring holds two steps plus its reach on both sides,
shared memory stays within a block's 227 KB, and the per-row kernel is
taken exactly when the rings do not fit.  An emulation of the kernel's
passes in numpy (its anchors, clipping, ring slots and one barrier a
pass, every ring read checked to find the row it wants, written in an
earlier pass) is held against the plain twins bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import DIAMatrix, dia  # noqa: E402

SMEM_BLOCK = 232448          # 227 KB, a block's shared memory on an H100
SMEM_OFFSETS = 2 * 32 * 4    # the kernel's static offset arrays
DTYPES = [torch.float32, torch.float64]

# the offsets (and n_pad) of the device-built 2048^2 hierarchy (A and St
# have the same ones on these levels), read from
# device_sa_setup(max_coarse=400) on the CPU: levels 0 and 1, plain and
# lane-aligned; and its coarse levels' odd n_pad
LEVELS = {
    "level0": (4227072, (-2049, -1, 0, 1, 2049)),
    "level1": (475136, (-685, -684, -683, -1, 0, 1, 683, 684, 685)),
    "lane-aligned level0": (4784128, (-2304, -1, 0, 1, 2304)),
    "lane-aligned level1": (540672, (-769, -768, -767, -1, 0, 1, 767, 768,
                                     769)),
    "n_pad 729": (729, (-28, -27, -26, -1, 0, 1, 26, 27, 28)),
    "n_pad 990": (990, (-34, -33, -32, -1, 0, 1, 32, 33, 34)),
}


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", list(LEVELS))
def test_chain_plan_at_the_path_shapes(level, dtype):
    n_pad, offsets = LEVELS[level]
    h = max(abs(o) for o in offsets)
    for sms in (132, 66):
        plan = dia.chain_plan(offsets, offsets, n_pad, dtype, sms)
        assert plan is not None
        # 16 bytes of rows a thread (4 float32, 2 float64) where n_pad
        # allows, else 1
        per16 = 16 // _itemsize(dtype)
        assert plan.vec == (per16 if n_pad % per16 == 0 else 1)
        assert dia.chain_plan(offsets, offsets, n_pad, dtype, sms,
                              False).vec == 1
        # 1024 threads where that gives half the SMs a strip (levels 0 and
        # 1), smaller CTAs for the coarse levels
        assert plan.threads == (1024 if n_pad > 400_000 else 256)
        # the strips cover [0, n_pad) once, in whole vec groups, at most
        # one an SM
        assert plan.strip % plan.vec == 0
        assert plan.strips * plan.strip >= n_pad
        assert (plan.strips - 1) * plan.strip < n_pad
        assert plan.strips <= sms
        assert plan.strip >= min(n_pad, max(plan.step, 4 * h))
        # each ring holds two steps plus its reach on both sides, and the
        # stages lag by a step plus the reach above
        assert (plan.al, plan.ar, plan.hl, plan.hr) == (h, h, h, h)
        cap1, cap2 = plan.caps
        assert cap1 >= 2 * plan.step + 2 * h and cap2 >= 2 * plan.step + 2 * h
        assert cap1 % plan.vec == 0 and cap2 % plan.vec == 0
        a1, a2, a3 = plan.anchors
        assert a1 <= -2 * h and a2 <= a1 - plan.step - h
        assert a3 <= a2 - plan.step - h
        assert all(a % plan.vec == 0 for a in (a1, a2, a3))
        assert plan.smem(_itemsize(dtype)) + SMEM_OFFSETS <= SMEM_BLOCK


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_per_row_exactly_when_the_rings_do_not_fit(dtype):
    sz = _itemsize(dtype)
    for reach in list(range(0, 40001, 997)) + [5000, 12000, 13000, 26000]:
        for below in (reach, reach // 3):
            soffsets = (-below, 0, reach)
            plan = dia.chain_plan((-1, 0, 1), soffsets, 200_000, dtype,
                                  132)
            threads, vec = dia._CHAIN_THREADS[0], dia._CHAIN_VEC[dtype]
            up = lambda r: -(-r // vec) * vec  # noqa: E731
            rings = 4 * threads * vec + 2 * up(1) + up(below) + up(reach)
            fits = rings * sz + SMEM_OFFSETS <= SMEM_BLOCK
            assert (plan is not None) == fits, (below, reach)
            if plan is not None:
                assert (plan.hl, plan.hr) == (below, reach)
                assert plan.smem(sz) + SMEM_OFFSETS <= SMEM_BLOCK
    # the 3-D 7-point pattern of a 100 x 180 x 180 grid (reach 32 400)
    o3 = (-32400, -180, -1, 0, 1, 180, 32400)
    assert dia.chain_plan(o3, o3, 100 * 180 * 180, dtype, 132) is None
    # more than 32 diagonals, and rows near 2^31
    wide = tuple(range(-20, 21))
    assert dia.chain_plan(wide, (0,), 100_000, dtype, 132) is None
    assert dia.chain_plan((-1, 0, 1), (-1, 0, 1), 2 ** 31, dtype,
                          132) is None


def _random_dia(n_pad, offsets, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n_pad))
    i = np.arange(n_pad)
    for d, off in enumerate(offsets):
        data[d, (i + off < 0) | (i + off >= n_pad)] = 0.0
    return DIAMatrix(data=torch.as_tensor(data), offsets=tuple(offsets),
                     shape=(n_pad, n_pad), nnz=int((data != 0).sum()))


class _Ring:
    """A ring of ``cap`` slots from row ``base``, each slot remembering the
    row and the pass that wrote it, so a read of a row that is not there
    (or that this pass wrote) fails."""

    def __init__(self, cap, base):
        self.cap, self.base = cap, base
        self.val = np.full(cap, np.nan)
        self.row = np.full(cap, -(2 ** 40), dtype=np.int64)
        self.when = np.full(cap, -1, dtype=np.int64)

    def write(self, rows, vals, p):
        s = (rows - self.base) % self.cap
        self.val[s], self.row[s], self.when[s] = vals, rows, p

    def read(self, rows, p):
        s = (rows - self.base) % self.cap
        assert (self.row[s] == rows).all(), "a ring slot holds another row"
        assert (self.when[s] < p).all(), "a ring row read in its own pass"
        return self.val[s]


def _march(plan, mode, A, Out, x, b, dinv, tv, w):
    """The ring kernel's passes in numpy: per strip, pass by pass, the
    three stages on the kernel's rows (anchors, clipping), each stage's
    sums in the kernel's order, ring reads checked; returns (out0, out1)."""
    n = A.n_pad
    a, so = A.data.numpy(), Out.data.numpy()
    out0, out1 = np.full(n, np.nan), np.full(n, np.nan)
    S = plan.step
    AL, AR, HL, HR = plan.reaches
    a1, a2, a3 = plan.anchors
    cap1, cap2 = plan.caps

    def ring_sum(data, offsets, rows, ring, p):
        acc = np.zeros(rows.size)
        for e, off in enumerate(offsets):
            m = rows + off
            ok = (m >= 0) & (m < n)
            acc[ok] = acc[ok] + data[e, rows[ok]] * ring.read(m[ok], p)
        return acc

    for blk in range(plan.strips):
        s0 = blk * plan.strip
        s1 = min(s0 + plan.strip, n)
        A1, A2, A3 = s0 + a1, s0 + a2, s0 + a3
        ring1, ring2 = _Ring(cap1, A2 - AL), _Ring(cap2, A3 - HL)
        lo1, hi1 = max(A1, 0), min(s1 + HR + AR, n)
        lo2, hi2 = max(s0 - HL, 0), min(s1 + HR, n)
        for p in range(plan.passes(s0, s1)):
            q = np.arange(A1 + p * S, A1 + (p + 1) * S)
            q = q[(q >= lo1) & (q < hi1)]
            u = w * (dinv[q] * b[q]) if mode == "K5" else x[q]
            if mode == "K5":
                own = (q >= s0) & (q < s1)
                out0[q[own]] = u[own]
            j = np.arange(A2 + p * S, A2 + (p + 1) * S)
            j = j[(j >= lo2) & (j < hi2)]
            i = np.arange(A3 + p * S, A3 + (p + 1) * S)
            i = i[(i >= s0) & (i < s1)]
            # one pass, no barrier inside: each ring is written before it
            # is read, so a read of a row this pass writes, or of a slot it
            # overwrites, fails the ring's checks
            ring1.write(q, u, p)
            acc = ring_sum(a, A.offsets, j, ring1, p)
            if mode == "K5":
                v = b[j] - acc
            else:
                v = ring1.read(j, p) + w * (dinv[j] * (b[j] - acc))
                own = (j >= s0) & (j < s1)
                out0[j[own]] = v[own]
            ring2.write(j, v, p)
            acc3 = ring_sum(so, Out.offsets, i, ring2, p)
            out1[i] = tv[i] * acc3 if mode == "K5" else b[i] - acc3
    return out0, out1


CASES = {
    # several strips of several passes, the last partial, both ends
    # reaching past the matrix, an asymmetric outer reach (K5)
    "float32 form, asymmetric St": (30008, (-1203, -1, 0, 1, 1203),
                                    (-2405, -1203, 0, 1, 700),
                                    torch.float32, 132),
    "float64 form, few SMs": (30011, (-1203, -1, 0, 1, 1203),
                              (-2405, -1203, 0, 1, 700), torch.float64, 4),
    # an n_pad no multiple of 4 (one row a thread) and odd reaches
    "odd n_pad, odd reaches": (2998, (-57, -3, 0, 5, 61),
                               (-61, -5, 0, 3, 57), torch.float32, 2),
    # one strip shorter than a step, every row with a neighbour past an end
    "reach past the matrix": (1204, (-1203, 0, 1203), (-900, 0, 1100),
                              torch.float32, 132),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["K5", "K4"])
def test_strip_march_emulation_matches_twin(case, mode):
    """The kernel's strip march equals the plain twins bit for bit (the
    same products and sums in the same order; an out-of-range term is
    left out where the twin adds 0 * 0)."""
    n, offs, soffs, dtype, sms = CASES[case]
    A = _random_dia(n, offs, 0)
    St = _random_dia(n, soffs, 1) if mode == "K5" else A
    rng = np.random.default_rng(n)
    x, b = rng.standard_normal(n), rng.standard_normal(n)
    dinv, tv = rng.random(n), rng.random(n)
    plan = dia.chain_plan(A.offsets, St.offsets, n, dtype, sms)
    assert plan.strip % plan.step != 0
    if case != "reach past the matrix":     # there: one strip, one step
        assert plan.strips >= 2 and plan.strip > plan.step
    w = 0.7
    got = _march(plan, mode, A, St, x, b, dinv, tv, w)
    t = torch.as_tensor
    if mode == "K5":
        want = dia.dia_zero_chain_ref(A, St, t(b), t(dinv), t(tv), w)
    else:
        want = dia.dia_jacobi_res_ref(A, t(x), t(b), t(dinv), w)
    for g, r in zip(got, want):
        assert np.array_equal(g, r.numpy())


def test_strip_march_emulation_at_other_forms():
    """Other threads, rows a thread and strip counts (the measurement's
    sweep) keep the schedule right."""
    n = 20000
    A = _random_dia(n, (-801, -1, 0, 1, 801), 2)
    St = _random_dia(n, (-801, -800, 0, 800, 801), 3)
    rng = np.random.default_rng(5)
    b, dinv, tv = rng.standard_normal(n), rng.random(n), rng.random(n)
    want = dia.dia_zero_chain_ref(A, St, torch.as_tensor(b),
                                  torch.as_tensor(dinv), torch.as_tensor(tv),
                                  0.9)
    base = dia.chain_plan(A.offsets, St.offsets, n, torch.float32, 132)
    for threads, vec, strips in ((128, 4, 7), (256, 1, 3), (64, 2, 40)):
        strip = -(-(-(-n // strips)) // vec) * vec
        plan = dataclasses.replace(base, threads=threads, vec=vec,
                                   strip=strip, strips=-(-n // strip))
        got = _march(plan, "K5", A, St, None, b, dinv, tv, 0.9)
        for g, r in zip(got, want):
            assert np.array_equal(g, r.numpy()), (threads, vec, strips)

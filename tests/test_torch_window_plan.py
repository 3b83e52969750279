"""K6 and K14's launch plan and indexing, on the CPU.

K6 (``windowed_matvec``) and K14 (``windowed_select``) are one kernel
template with two epilogues (csrc/window.cu::windowed_gather_kernel): a
CTA works inside one row block, a thread moves 16 bytes of each stream (or
one value), and the launch is a host function of the operator's shape, the
payload's width and the card's SM count (``sparse/window.py::
gather_plan``).  These tests hold the plan to the kernel's needs at the
paths' real shapes (the host-built 2048^2 T, the 640k unstructured A and
P, the routed float64 40k A and P, and a float64 operator with 16384-wide
windows, whose 256 KB window no CTA could stage): the CTAs cover every
row block's items once, at least one wave of the card where the blocks
allow, 16-byte items only on aligned pack operands and blocks of whole
items, offsets inside a row block within 32 bits.  An emulation of the
kernel's index arithmetic in numpy (per CTA, thread and item) is held
against the plain twins on integer-valued operands, where every summation
order gives the same value.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from pyamg_tpu_torch.sparse import window, windowed_from_scipy  # noqa: E402

SMS = 132

# (n_pad, k, block, w2, source length, itemsize) of the paths' operators,
# read from chip_smoke.py's log of the H100 (tags of its kernel checks)
SHAPES = {
    "host level0 T": (4194304, 1, 8192, 2048, 700416, 4),
    "host level1 T": (700416, 1, 4096, 1024, 79872, 4),
    "640k level0 A": (640000, 5, 1024, 2048, 641024, 4),
    "640k level0 P": (640000, 4, 1024, 2048, 210944, 4),
    "640k level1 A": (208896, 25, 1024, 4096, 212992, 4),
    "routed level0 A": (40960, 7, 1024, 2048, 43008, 8),
    "routed level0 P": (40960, 6, 1024, 1024, 10240, 8),
    "float64 w2 16384": (1048576, 9, 1024, 16384, 1081344, 8),
}


def _per_block(plan, k, block):
    return (k * block if plan.select else block) // plan.vec


def _check_cover(plan, n_pad, k, block, sms=SMS):
    """The invariants every plan must keep."""
    assert plan.n_blocks * block == n_pad
    per_block = _per_block(plan, k, block)
    assert block % plan.vec == 0
    # the chunks cover the block's items once, none of them empty
    assert plan.ctas_per_block * plan.items >= per_block
    assert (plan.ctas_per_block - 1) * plan.items < per_block
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.grid < 2 ** 31
    # the kernel's 32-bit offsets inside a row block
    assert k * block < 2 ** 31
    assert plan.ctas_per_block * plan.items < 2 ** 31


@pytest.mark.parametrize("select", [False, True], ids=["K6", "K14"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gather_plan_at_the_path_shapes(shape, select):
    n_pad, k, block, w2, m, itemsize = SHAPES[shape]
    plan = window.gather_plan(select, n_pad, k, block, itemsize, SMS)
    assert plan.select == select
    _check_cover(plan, n_pad, k, block)
    per16 = 16 // itemsize
    # 16 bytes a thread, except K6 where that would leave under 1024
    # threads an SM (the 640k level 1 A: 25 slots a row; the routed 40k)
    few_rows = n_pad // per16 < window._GATHER_FULL * SMS
    assert plan.vec == (1 if not select and few_rows else per16)
    # one wave at least, and the routed 40k shapes keep it
    assert plan.grid >= SMS
    per_block = _per_block(plan, k, block)
    if select:
        # up to 8 items a thread, fewer where the card would not fill
        # (the routed 40k: one), and the CTAs of a row block no more than
        # that and the wave need
        per_thread = min(max(n_pad * k // plan.vec // (
            window._GATHER_FULL * SMS), 1), window._SELECT_ITEMS)
        assert plan.items <= plan.threads * per_thread
        assert plan.threads <= window._SELECT_THREADS
        assert plan.ctas_per_block <= max(
            -(-per_block // (window._SELECT_THREADS * per_thread)),
            -(-SMS // plan.n_blocks)) + 1
    else:
        # one item a thread
        assert plan.items <= plan.threads


def test_gather_plan_keeps_a_wave_on_small_operators():
    """Threads halve (down to the least) while the grid would not give
    every SM a CTA; K14 adds CTAs a block instead."""
    for n_blocks in (1, 3, 10, 40, 66, 131, 132, 500):
        for k in (1, 6, 25):
            for itemsize in (4, 8):
                n_pad = 1024 * n_blocks
                for select in (False, True):
                    plan = window.gather_plan(select, n_pad, k, 1024,
                                              itemsize, SMS)
                    _check_cover(plan, n_pad, k, 1024)
                    per_block = _per_block(plan, k, 1024)
                    if plan.grid < SMS:
                        # fewer CTAs only where the items run out
                        assert (plan.threads == window._GATHER_MIN_THREADS
                                or plan.ctas_per_block == per_block)
                    if not select:
                        assert plan.items == plan.threads      # one a thread
    for sms in (1, 16, 132, 264):
        plan = window.gather_plan(False, 40960, 7, 1024, 8, sms)
        assert plan.grid >= min(sms, 40 * 1024 // 128)


def test_gather_plan_bounds_and_alignment():
    # rows that are not whole blocks: no plan
    with pytest.raises(ValueError):
        window.gather_plan(False, 1000, 3, 256, 4, SMS)
    # operators whose entries reach 2^31 still get a plan: only the
    # offsets inside one row block are 32-bit
    for select, n_pad, k in ((False, 2 ** 28, 8), (True, 2 ** 27, 16)):
        plan = window.gather_plan(select, n_pad, k, 8192, 4, SMS)
        _check_cover(plan, n_pad, k, 8192)
    # unaligned operands or a block of no whole 16-byte items: 1 value a
    # thread
    for select in (False, True):
        args = (select, 4194304, 1, 8192, 4, SMS)
        assert window.gather_plan(*args).vec == 4
        assert window.gather_plan(*args, aligned=False).vec == 1
        # (one SM, so that K6's rows fill it at 16 bytes a thread)
        whole = window.gather_plan(select, 6 * 1000, 3, 1000, 4, 1)
        assert whole.vec == 4
        odd = window.gather_plan(select, 6 * 1002, 3, 1002, 4, 1)
        assert odd.vec == 1
        _check_cover(odd, 6 * 1002, 3, 1002, sms=1)


def _rect(n, m, per_row, spread, seed):
    """A random banded n x m operator with small integer entries."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    vals = rng.integers(-8, 9, len(rows)).astype(np.float64)
    vals[vals == 0] = 3.0
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _emulate(plan, W, x):
    """The kernel's index arithmetic in numpy, CTA by CTA and thread by
    thread: b = blockIdx / ctas_per_block, the chunk's items [i0, i1),
    thread t's items i0 + t, i0 + t + threads, ...; K6 item i sums rows
    i * vec .. + vec over slots s in order at e = b k block + s block +
    i vec + u, K14 item i copies entries e = b k block + i vec + u; every
    gather reads the row block's window x[w(b), w(b) + 2 w2).  The 32-bit
    offsets from the block's base eb are checked, and every output is
    written once."""
    data = W.data.numpy().reshape(-1)
    idx = W.idx.numpy().reshape(-1).astype(np.int64)
    starts = W.starts.numpy().astype(np.int64)
    k, block, w2, V = W.k, W.block, W.w2, plan.vec
    per_block = (k * block if plan.select else block) // V
    n_out = idx.size if plan.select else W.n_pad
    out = np.zeros(n_out, dtype=x.dtype)
    writes = np.zeros(n_out, dtype=np.int64)
    u = np.arange(V)
    for g in range(plan.grid):
        b = g // plan.ctas_per_block
        i0 = (g - b * plan.ctas_per_block) * plan.items
        i1 = min(i0 + plan.items, per_block)
        src = x[starts[b] * w2:][: 2 * w2]
        eb = b * k * block
        for t in range(plan.threads):
            for i in range(i0 + t, i1, plan.threads):
                if plan.select:
                    e = eb + i * V + u
                    assert (e - eb).max() < 2 ** 31
                    out[e] = src[idx[e]]
                    writes[e] += 1
                    continue
                acc = np.zeros(V, dtype=x.dtype)
                for s in range(k):
                    e = eb + s * block + i * V + u
                    assert (e - eb).max() < 2 ** 31
                    assert idx[e].max() < 2 * w2
                    acc = acc + data[e].astype(x.dtype) * src[idx[e]]
                rows = b * block + i * V + u
                out[rows] = acc
                writes[rows] += 1
    assert (writes == 1).all()
    return out


# the forms the sweep on the card took, at a small operator: 16 bytes or
# one value, CTA sizes (32 to 96 threads, at this size), items a thread,
# one CTA a row block
FORMS = [dict(vec=v, threads=t, per_thread=p)
         for v in (1, "16B") for t in (32, 64, 96) for p in (1, 3, "all")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("select", [False, True], ids=["K6", "K14"])
def test_kernel_indexing_equals_the_twins(select, dtype):
    """Every form of the plan, emulated, equals the twin on integer data
    (so any summation order gives the same value), at the plan's own form
    and at each form of the sweep; the last row block reads the last
    window (starts at m_chunks - 2)."""
    P = _rect(2048, 2048, per_row=5, spread=40, seed=7)
    W = windowed_from_scipy(P, dtype=dtype, device="cpu", block=256)
    assert int(W.starts.max()) == W.m_chunks - 2
    m = W.m_chunks * W.w2
    x = torch.as_tensor(np.random.default_rng(8).integers(-50, 51, m),
                        dtype=dtype)
    twin = (window.windowed_select_ref(W, x) if select
            else window.windowed_matvec_ref(W, x)).numpy().reshape(-1)
    sz = x.element_size()
    base = window.gather_plan(select, W.n_pad, W.k, W.block, sz, SMS)
    plans = [base]
    for f in FORMS:
        vec = 16 // sz if f["vec"] == "16B" else 1
        per_block = (W.k * W.block if select else W.block) // vec
        cpb = 1 if f["per_thread"] == "all" else max(
            1, -(-per_block // (f["threads"] * f["per_thread"])))
        plans.append(dataclasses.replace(
            base, vec=vec, threads=f["threads"], ctas_per_block=cpb,
            items=-(-per_block // cpb)))
    for plan in plans:
        _check_cover(plan, W.n_pad, W.k, W.block)
        got = _emulate(plan, W, x.numpy())
        np.testing.assert_array_equal(got, twin)


def test_wrapper_plan_follows_the_operands():
    """The wrapper's plan: the payload's width (K14 selects float32 from a
    float64 operator), the alignment of the pack operands (data, idx and
    the output; x is only gathered), and no launch counted for CPU tensors
    (the twins run)."""
    from pyamg_tpu_torch import _build

    P = _rect(4096, 4096, per_row=5, spread=40, seed=3)
    W = windowed_from_scipy(P, dtype=torch.float64, device="cpu", block=256)
    m = W.m_chunks * W.w2
    x32 = torch.ones(m, dtype=torch.float32)
    x64 = torch.ones(m, dtype=torch.float64)
    out = torch.empty(W.idx.shape, dtype=torch.float32)
    assert window._gather_plan_for(W, x32, out, True).vec == 4
    assert window._gather_plan_for(W, x64, out, True).vec == 2
    y = torch.empty(W.n_pad, dtype=torch.float64)
    assert window._gather_plan_for(W, x64, y, False).vec == 1   # few rows
    # a payload 8 bytes off 16 keeps 16 bytes a thread; an output 4
    # bytes off 16 takes one value a thread
    buf = torch.ones(m + 1, dtype=torch.float64)
    assert window._gather_plan_for(W, buf[1:], out, True).vec == 2
    odd = torch.empty(out.numel() + 1, dtype=torch.float32)[1:]
    odd = odd.view(out.shape)
    assert window._gather_plan_for(W, x32, odd, True).vec == 1
    assert window._gather_plan_for(W, x64, odd, True).vec == 1
    _build.reset_launches()
    window.windowed_matvec(W, x64)
    window.windowed_select(W, x32)
    assert _build.launches == {}


def test_per_row_reference_runs_on_the_card_only():
    """K6's per-row kernel (the card's bit reference) has no CPU form: CPU
    operands raise before any launch."""
    from pyamg_tpu_torch import _build

    P = _rect(1024, 1024, per_row=3, spread=20, seed=5)
    W = windowed_from_scipy(P, dtype=torch.float32, device="cpu", block=256)
    x = torch.ones(W.m_chunks * W.w2, dtype=torch.float32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        window._windowed_matvec_rows(W, x)
    assert _build.launches == {}
    assert "windowed_matvec_rows" not in window.__all__

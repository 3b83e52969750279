"""Device setup-phase graph primitives (counterpart of
``pyamg_tpu/engine/setup.py``).

Every primitive reads a vertex's neighbours through the DIA slots of the
operator: the neighbour across diagonal ``d`` of vertex i is
``torch.roll(x, -offsets[d])[i]``, and the slot takes part only where
``data[d, i] != 0``.  The roll wraps around, as the reference's
``jnp.roll`` does; the wrapped positions are out-of-range slots, which
hold structural zeros, so they never count as neighbours.

- :func:`device_strength_mask`: the classical strength test per slot;
- :func:`device_luby_mis`, :func:`device_jp_coloring`,
  :func:`device_pmis_splitting`: rounds of "beat every undecided
  neighbour" over :func:`neighbor_reduce_max`, each round one host read
  of "anything left, anything changed", at most ``n_pad`` rounds; a round
  that decides nothing raises :class:`UndecidedVertices`, since none
  after it would (two undecided neighbours whose hash weights tie in
  float32 never beat each other, and the reference's loop then never
  ends);
- :func:`device_bellman_ford`: min-plus rounds over
  :func:`neighbor_reduce_min_plus` until no distance drops, at most
  ``maxiter`` (default ``n_pad``) rounds, one host read a round.

The tie-breaking weights are the reference's uint32 avalanche hash of the
vertex index (:func:`_hash_weights`, bit for bit), so the MIS, the
colours and the splitting are the reference's, array for array.
"""

from __future__ import annotations

import torch

from ..sparse.dia import DIAMatrix

__all__ = ["neighbor_reduce_max", "neighbor_reduce_min_plus",
           "device_strength_mask", "device_luby_mis", "device_jp_coloring",
           "device_pmis_splitting", "device_bellman_ford",
           "UndecidedVertices", "_hash_weights"]

_MASK32 = 0xFFFFFFFF


def _mul32(z, c):
    """(z * c) mod 2^32 for int64 tensors 0 <= z < 2^32 and a 32-bit
    constant c, with every intermediate below 2^49 (int64 never wraps)."""
    lo = (z * (c & 0xFFFF)) & _MASK32
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_weights(n_pad, seed, device=None, start=0):
    """Deterministic pseudo-random weights in [0, 1): the reference's
    uint32 avalanche hash of the index, bit for bit, computed in int64
    with the wrap-around made explicit (PyTorch's uint32 lacks the
    operators).  ``start`` gives the weights of the indices [start, start
    + n_pad), a row block of the longer vector's (each weight depends on
    its index alone)."""
    i = torch.arange(start, start + n_pad, dtype=torch.int64, device=device)
    z = (i + (int(seed) * 0x9E3779B9 & _MASK32)) & _MASK32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z.to(torch.float32) / 2.0 ** 32


def _adjacency_masks(dia: DIAMatrix):
    """Per-diagonal off-diagonal adjacency masks (data != 0; None for the
    main diagonal)."""
    return [None if off == 0 else dia.data[d] != 0
            for d, off in enumerate(dia.offsets)]


def neighbor_reduce_max(dia: DIAMatrix, x, fill=float("-inf")):
    """max over the neighbours j of vertex i of x[j] (``fill`` where i has
    none)."""
    out = torch.full((dia.n_pad,), fill, dtype=x.dtype, device=x.device)
    for mask, off in zip(_adjacency_masks(dia), dia.offsets):
        if mask is None:
            continue
        out = torch.maximum(out, torch.where(mask, torch.roll(x, -off),
                                             fill))
    return out


def neighbor_reduce_min_plus(dia: DIAMatrix, dist, weights=None):
    """One Bellman-Ford round: min(dist[i], min over neighbours j of
    dist[j] + w(i, j)), w = |a_ij| unless ``weights`` (per diagonal)."""
    out = dist
    for d, off in enumerate(dia.offsets):
        if off == 0:
            continue
        w = torch.abs(dia.data[d]) if weights is None else weights[d]
        cand = torch.where(dia.data[d] != 0, torch.roll(dist, -off) + w,
                           float("inf"))
        out = torch.minimum(out, cand)
    return out


def device_strength_mask(dia: DIAMatrix, theta=0.25, norm="abs"):
    """Classical strength of connection over the DIA slots: slot (d, i) is
    strong iff its measure (|a| off the diagonal, or max(-a, 0) with
    ``norm="min"``) is positive and at least ``theta`` times the row's
    largest.  A bool tensor shaped like ``dia.data``."""
    offd = torch.tensor([o != 0 for o in dia.offsets],
                        device=dia.device)[:, None]
    if norm == "min":
        measure = torch.clamp_min(torch.where(offd, -dia.data, 0), 0)
    else:
        measure = torch.where(offd, torch.abs(dia.data), 0)
    rowmax = torch.max(measure, dim=0).values
    return (measure >= theta * rowmax[None, :]) & (measure > 0)


class UndecidedVertices(RuntimeError):
    """A round-based primitive reached a state that no round changes, with
    vertices still undecided (-1); ``state`` holds that state and
    ``rounds`` the rounds it took."""

    def __init__(self, what, state, rounds):
        super().__init__(
            f"{what}: {int((state == -1).sum())} vertices can never be "
            f"decided after {rounds} rounds (undecided neighbours tie on "
            "their float32 weights; the reference's loop would not end)")
        self.state = state
        self.rounds = rounds


def _rounds(state, body, what, n_pad):
    """Apply ``body`` until no vertex is undecided (-1), at most ``n_pad``
    rounds, one host read a round.  A round that changes nothing raises
    :class:`UndecidedVertices`: ``body`` depends on the state alone, so
    no later round would change anything either (two undecided
    neighbours whose float32 weights tie never beat each other; the
    reference's ``lax.while_loop`` then never ends)."""
    if not bool((state == -1).any()):
        return state
    for rounds in range(1, n_pad + 1):
        new = body(state)
        left, changed = torch.stack([(new == -1).any(),
                                     (new != state).any()]).tolist()
        if not left:
            return new
        if not changed:
            raise UndecidedVertices(what, new, rounds)
        state = new
    raise UndecidedVertices(what, state, n_pad)


def device_luby_mis(dia: DIAMatrix, seed=0, valid=None):
    """Luby's maximal independent set over the DIA adjacency: int8
    (n_pad,), 1 in the set, 0 out (rows where ``valid`` is False, by
    default the rows with a zero diagonal, start out)."""
    n_pad = dia.n_pad
    w = _hash_weights(n_pad, seed, device=dia.device)
    if valid is None:
        valid = dia.diagonal() != 0
    minus1 = torch.tensor(-1, dtype=torch.int8, device=dia.device)
    zero = torch.zeros((), dtype=torch.int8, device=dia.device)
    one = torch.ones((), dtype=torch.int8, device=dia.device)
    state0 = torch.where(valid, minus1, zero)

    def body(state):
        undecided = state == -1
        wv = torch.where(undecided, w, float("-inf"))
        winners = undecided & (wv > neighbor_reduce_max(dia, wv))
        state = torch.where(winners, one, state)
        # a vertex with a winning neighbour is out
        excl = neighbor_reduce_max(dia, winners.to(torch.float32)) > 0.5
        return torch.where((state == -1) & excl, zero, state)

    return _rounds(state0, body, "device_luby_mis", n_pad)


def device_jp_coloring(dia: DIAMatrix, seed=0, max_colors=32):
    """Jones-Plassmann vertex colouring: each round the undecided
    vertices that beat their undecided neighbours take the smallest colour
    no decided neighbour has.  int32 (n_pad,), -2 on rows with a zero
    diagonal."""
    n_pad = dia.n_pad
    dev = dia.device
    w = _hash_weights(n_pad, seed, device=dev)
    valid = dia.diagonal() != 0
    colors0 = torch.where(valid, torch.tensor(-1, dtype=torch.int32,
                                              device=dev),
                          torch.tensor(-2, dtype=torch.int32, device=dev))
    masks = _adjacency_masks(dia)

    def body(colors):
        undecided = colors == -1
        wv = torch.where(undecided, w, float("-inf"))
        winners = undecided & (wv > neighbor_reduce_max(dia, wv))
        # the colours the decided neighbours use, as a bit mask (int64
        # holds the reference's uint32 bits)
        used = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        for mask, off in zip(masks, dia.offsets):
            if mask is None:
                continue
            nbr_c = torch.roll(colors, -off)
            has = mask & (nbr_c >= 0)
            shift = nbr_c.clamp(0, max_colors - 1).to(torch.int64)
            used = used | torch.where(has, torch.ones_like(used) << shift, 0)
        # the first colour not used
        free = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        taken = torch.ones(n_pad, dtype=torch.bool, device=dev)
        for c in range(max_colors):
            hit = taken & (((used >> c) & 1) == 0)
            free = torch.where(hit, c, free)
            taken = taken & ~hit
        return torch.where(winners, free, colors)

    return _rounds(colors0, body, "device_jp_coloring", n_pad)


def device_pmis_splitting(dia: DIAMatrix, strength_mask=None, seed=0):
    """PMIS C/F splitting over the strength graph: weights = the number of
    strong dependents plus the hash; each round the undecided vertices
    that beat their undecided strong neighbours (both directions) become
    C, their strong neighbours F.  int8 (n_pad,): 1 = C, 0 = F (rows with
    a zero diagonal F)."""
    if strength_mask is None:
        strength_mask = device_strength_mask(dia)
    n_pad = dia.n_pad
    dev = dia.device
    sd = torch.where(strength_mask, dia.data, 0)
    # lambda_j = the number of i with (i, j) strong: each strong slot of
    # row i rolled onto its column j = i + off
    lam = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for d, off in enumerate(dia.offsets):
        if off == 0:
            continue
        lam = lam + torch.roll((sd[d] != 0).to(torch.float32), off)
    w = lam + _hash_weights(n_pad, seed, device=dev)
    valid = dia.diagonal() != 0
    minus1 = torch.tensor(-1, dtype=torch.int8, device=dev)
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    one = torch.ones((), dtype=torch.int8, device=dev)
    state0 = torch.where(valid, minus1, zero)
    sym_masks = [sd[d] != 0 for d in range(len(dia.offsets))]
    ninf = float("-inf")

    def nbr_max_sym(x):
        """max over the strong neighbours in either direction (S and
        S^T)."""
        out = torch.full((n_pad,), ninf, dtype=x.dtype, device=dev)
        for m, off in zip(sym_masks, dia.offsets):
            if off == 0:
                continue
            out = torch.maximum(out, torch.where(m, torch.roll(x, -off),
                                                 ninf))
            out = torch.maximum(out, torch.roll(torch.where(m, x, ninf),
                                                off))
        return out

    def body(state):
        undecided = state == -1
        wv = torch.where(undecided, w, ninf)
        winners = undecided & (wv > nbr_max_sym(wv))
        state = torch.where(winners, one, state)
        winf = winners.to(torch.float32)
        excl = nbr_max_sym(torch.where(winners, winf, ninf)) > 0.5
        return torch.where((state == -1) & excl, zero, state)

    state = _rounds(state0, body, "device_pmis_splitting", n_pad)
    return torch.where(state == 1, one, zero)


def device_bellman_ford(dia: DIAMatrix, seed_mask, maxiter=None):
    """Multi-seed shortest-path distances (|a_ij| as edge lengths) by
    min-plus rounds until no distance drops, at most ``maxiter`` (default
    ``n_pad``) rounds; inf where no seed is reachable.  In the operator's
    dtype."""
    n_pad = dia.n_pad
    dist = torch.where(seed_mask,
                       torch.zeros((), dtype=dia.dtype, device=dia.device),
                       float("inf"))
    if maxiter is None:
        maxiter = n_pad
    for _ in range(int(maxiter)):
        new = neighbor_reduce_min_plus(dia, dist)
        changed = bool((new < dist).any())
        dist = new
        if not changed:
            break
    return dist

"""Host graph algorithms of the port: maximal independent sets and vertex
colorings (a copy of ``pyamg_tpu/graph.py``'s ``asgraph``,
``maximal_independent_set`` and ``vertex_coloring``).

The device compile colors each level's connectivity graph for multicolor
Gauss-Seidel (Jones-Plassmann, seeded weights).  Each round of the
parallel algorithms is vectorised where that cannot change the result: a
node wins when its weight beats every undecided neighbour's, so on a
structurally symmetric pattern the winners of one round form an
independent set (the weights are a permutation) and the order in which
they take their colours does not matter.  On a pattern that is not
symmetric two winners can be joined by a one-sided edge, and the winners
then take their colours one after another in index order, as in the
reference.  The colours equal the reference's array for array either way.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["asgraph", "maximal_independent_set", "vertex_coloring"]


def asgraph(G):
    """Return a CSR adjacency matrix with sorted indices."""
    G = sp.csr_matrix(G)
    G.sort_indices()
    return G


def _random_weights(n, seed):
    rng = np.random.default_rng(seed)
    # unique tie-breaking weights (a random permutation keeps them distinct)
    return rng.permutation(n).astype(np.float64) + 1.0


def _row_max(vals, indptr):
    """The max of ``vals`` over each CSR row; -inf for an empty row."""
    n = indptr.shape[0] - 1
    out = np.full(n, -np.inf)
    rows = np.flatnonzero(np.diff(indptr) > 0)
    if rows.size:
        out[rows] = np.maximum.reduceat(vals, indptr[rows])
    return out


def _off_diagonal(G):
    Gp = G.copy()
    Gp.setdiag(0)
    Gp.eliminate_zeros()
    return Gp


def maximal_independent_set(G, algo="serial", k=None, weights=None, seed=0):
    """Maximal independent set of the graph of G: 1 = in the set, 0 = not.

    ``algo='serial'``: greedy in natural order.  ``algo='parallel'``:
    Luby's rounds, a node joining when its weight beats every undecided
    neighbour's.  ``k``: distance-k MIS, by MIS on G^k's pattern."""
    G = asgraph(G)
    n = G.shape[0]
    if k is not None and k > 1:
        Gk = G.copy()
        Gk.data = np.ones_like(Gk.data)
        P = Gk
        for _ in range(k - 1):
            P = sp.csr_matrix((P @ Gk) + P)
            P.data = np.ones_like(P.data)
        G = asgraph(P)

    if algo == "serial":
        state = np.full(n, -1, dtype=np.int8)  # -1 undecided, 1 MIS, 0 out
        indptr, indices = G.indptr, G.indices
        for i in range(n):
            if state[i] == -1:
                state[i] = 1
                nbrs = indices[indptr[i]: indptr[i + 1]]
                state[nbrs[nbrs != i]] = 0
        return (state == 1).astype(np.int32)

    if algo == "parallel":
        if weights is None:
            weights = _random_weights(n, seed)
        state = np.full(n, -1, dtype=np.int8)
        Gp = _off_diagonal(G)
        indptr, indices = Gp.indptr, Gp.indices
        rows = np.repeat(np.arange(n), np.diff(indptr))
        while True:
            undecided = state == -1
            if not undecided.any():
                break
            w = np.where(undecided, weights, -np.inf)
            nbr_max = _row_max(w[indices], indptr)
            winners = undecided & (w > nbr_max)
            if not winners.any():
                # isolated ties can only happen with duplicate weights
                winners = undecided & (w >= nbr_max)
            state[winners] = 1
            excluded = np.zeros(n, dtype=bool)
            excluded[indices[winners[rows]]] = True
            state[excluded & (state == -1)] = 0
        return (state == 1).astype(np.int32)

    raise ValueError(f"unknown algo {algo}")


def _structurally_symmetric(G):
    P = G.copy()
    P.data = np.ones_like(P.data)
    return (P != P.T).nnz == 0


def _smallest_free_colors(colors, win, indptr, indices):
    """For each node of ``win`` (an independent set), the smallest colour
    that none of its coloured neighbours holds."""
    starts = indptr[win]
    lens = indptr[win + 1] - starts
    total = int(lens.sum())
    owner = np.repeat(np.arange(win.size), lens)
    pos = (np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
           + np.repeat(starts, lens))
    nbr = colors[indices[pos]]
    keep = nbr >= 0
    used = np.zeros((win.size, int(colors.max()) + 2), dtype=bool)
    used[owner[keep], nbr[keep]] = True
    return np.argmin(used, axis=1)


def vertex_coloring(G, method="JP", seed=0):
    """Vertex colouring of the graph of G (int32 colours from 0).

    ``method='MIS'``: repeated maximal independent sets, one colour each.
    ``'JP'``: Jones-Plassmann, random priorities and greedy rounds.
    ``'LDF'``: largest-degree-first priorities and JP rounds."""
    G = asgraph(G)
    n = G.shape[0]
    Gp = _off_diagonal(G)
    indptr, indices = Gp.indptr, Gp.indices

    if method == "MIS":
        colors = np.full(n, -1, dtype=np.int32)
        color = 0
        remaining = np.arange(n)
        Gcur = Gp
        while remaining.size:
            mis = maximal_independent_set(Gcur, algo="parallel",
                                          seed=seed + color)
            chosen = remaining[mis.astype(bool)]
            colors[chosen] = color
            color += 1
            keep = ~mis.astype(bool)
            remaining = remaining[keep]
            Gcur = Gcur[keep][:, keep].tocsr()
        return colors

    if method in ("JP", "LDF"):
        if method == "LDF":
            degrees = np.diff(indptr).astype(np.float64)
            weights = degrees * n + _random_weights(n, seed)  # degree-major
        else:
            weights = _random_weights(n, seed)
        symmetric = _structurally_symmetric(Gp)
        colors = np.full(n, -1, dtype=np.int32)
        while (colors == -1).any():
            undecided = colors == -1
            w = np.where(undecided, weights, -np.inf)
            nbr_max = _row_max(w[indices], indptr)
            winners = undecided & (w > nbr_max)
            if winners.any() and symmetric:
                win = np.flatnonzero(winners)
                colors[win] = _smallest_free_colors(colors, win, indptr,
                                                    indices)
                continue
            if not winners.any():
                winners = undecided & (w >= nbr_max)
            # ties (duplicate weights) or a one-sided edge between two
            # winners: the winners colour one after another, in index order
            for i in np.flatnonzero(winners):
                used = set(colors[indices[indptr[i]: indptr[i + 1]]].tolist())
                c = 0
                while c in used:
                    c += 1
                colors[i] = c
        return colors

    raise ValueError(f"unknown method {method}")

"""Test problems: Poisson on regular grids and the P1 finite-element
stiffness matrix on a triangle mesh (copies of
``pyamg_tpu/gallery/laplacian.py::poisson``,
``pyamg_tpu/gallery/stencil.py::stencil_grid``,
``pyamg_tpu/gallery/mesh.py::regular_triangle_mesh`` and
``pyamg_tpu/gallery/fem.py::gradgradform``, which the port carries so that
it imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["gradgradform", "poisson", "regular_triangle_mesh",
           "stencil_grid"]


def stencil_grid(S, grid, dtype=None, format=None):
    """Sparse matrix of the local stencil ``S`` (odd shape, centre couples
    a node to itself) on a regular ``grid``; connections that reach
    outside the grid are dropped (homogeneous Dirichlet)."""
    S = np.asarray(S, dtype=dtype)
    grid = tuple(int(g) for g in grid)
    if S.ndim != len(grid):
        raise ValueError("stencil dimension must equal number of grid dimensions")
    if min(grid) < 1:
        raise ValueError("grid dimensions must be positive")
    if any(s % 2 == 0 for s in S.shape):
        raise ValueError("all stencil dimensions must be odd")

    n = int(np.prod(grid))
    center = tuple(s // 2 for s in S.shape)
    strides = np.array(
        [int(np.prod(grid[d + 1:])) for d in range(len(grid))], dtype=np.int64
    )
    grid_arr = np.array(grid, dtype=np.int64)
    coords = np.stack(
        np.meshgrid(*[np.arange(g) for g in grid], indexing="ij"), axis=-1
    ).reshape(n, len(grid))

    rows_list, cols_list, vals_list = [], [], []
    for offset in np.ndindex(S.shape):
        v = S[offset]
        if v == 0:
            continue
        off = np.array(offset, dtype=np.int64) - np.array(center, dtype=np.int64)
        nbr = coords + off[None, :]
        ok = np.all((nbr >= 0) & (nbr < grid_arr[None, :]), axis=1)
        rows = np.flatnonzero(ok)
        rows_list.append(rows)
        cols_list.append(nbr[ok] @ strides)
        vals_list.append(np.full(rows.shape[0], v, dtype=S.dtype))

    rows = np.concatenate(rows_list) if rows_list else np.array([], dtype=np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.array([], dtype=np.int64)
    vals = np.concatenate(vals_list) if vals_list else np.array([], dtype=S.dtype)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    if format in (None, "csr"):
        return A
    return A.asformat(format)


def poisson(grid, dtype=float, format=None, type="FD"):
    """Finite-difference/element Poisson problem on a regular grid.

    1D: [-1, 2, -1]; 2D FD: 5-point; 2D FE: 9-point; 3D FD: 7-point;
    3D FE: 27-point.  Homogeneous Dirichlet boundaries."""
    grid = tuple(int(g) for g in grid)
    ndim = len(grid)
    if min(grid) < 1:
        raise ValueError("invalid grid shape")
    if type not in ("FD", "FE"):
        raise ValueError("type must be 'FD' or 'FE'")

    if type == "FD" and ndim in (1, 2, 3):
        # separable FD Laplacian: Kronecker-sum assembly (the stencil_grid
        # path below produces the identical matrix)
        def lap1d(m):
            return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m),
                            format="csr", dtype=dtype)

        eyes = [sp.identity(g, format="csr", dtype=dtype) for g in grid]
        A = None
        for d in range(ndim):
            ops = [eyes[j] if j != d else lap1d(grid[d]) for j in range(ndim)]
            term = ops[0]
            for op in ops[1:]:
                term = sp.kron(term, op, format="csr")
            A = term if A is None else A + term
        A = A.tocsr()
        A.sum_duplicates()
        A.sort_indices()
        if format not in (None, "csr"):
            A = A.asformat(format)
        return A

    if ndim == 1:
        S = np.array([-1.0, 2.0, -1.0], dtype=dtype)
    elif ndim == 2:
        S = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]],
                     dtype=dtype) / 3.0
    elif ndim == 3:
        S = -np.ones((3, 3, 3), dtype=dtype)
        S[1, 1, 1] = 26.0
        S /= 3.0
    else:
        raise ValueError("only 1D/2D/3D Poisson supported")
    return stencil_grid(S, grid, dtype=dtype, format=format)


def regular_triangle_mesh(nx, ny):
    """Triangulated regular grid on the unit square: (vertices (n, 2)
    float, elements (ne, 3) int)."""
    nx, ny = int(nx), int(ny)
    if nx < 2 or ny < 2:
        raise ValueError("minimum mesh dimension is 2: %s" % ((nx, ny),))
    x = np.linspace(0.0, 1.0, nx)
    y = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(x, y, indexing="xy")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    node = np.arange(nx * ny).reshape(ny, nx)
    n00 = node[:-1, :-1].ravel()
    n10 = node[:-1, 1:].ravel()
    n01 = node[1:, :-1].ravel()
    n11 = node[1:, 1:].ravel()
    lower = np.stack([n00, n10, n01], axis=1)
    upper = np.stack([n10, n11, n01], axis=1)
    elements = np.vstack([lower, upper]).astype(np.int64)
    return vertices, elements


def gradgradform(vertices, elements, kappa=None):
    """P1 stiffness matrix of int kappa grad(u).grad(v) on a triangle mesh
    (CSR); ``kappa`` is None (1), a constant or a function of the element
    centre."""
    V = np.asarray(vertices, dtype=float)
    E = np.asarray(elements, dtype=np.int64)
    n = V.shape[0]
    ne = E.shape[0]

    p0, p1, p2 = V[E[:, 0]], V[E[:, 1]], V[E[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(detJ)

    grads = np.empty((ne, 3, 2))
    inv_det = 1.0 / detJ
    grads[:, 1, 0] = d2[:, 1] * inv_det
    grads[:, 1, 1] = -d2[:, 0] * inv_det
    grads[:, 2, 0] = -d1[:, 1] * inv_det
    grads[:, 2, 1] = d1[:, 0] * inv_det
    grads[:, 0, :] = -(grads[:, 1, :] + grads[:, 2, :])

    if kappa is None:
        k = np.ones(ne)
    elif callable(kappa):
        centers = (p0 + p1 + p2) / 3.0
        k = np.asarray([kappa(c) for c in centers], dtype=float)
    else:
        k = np.full(ne, float(kappa))

    Ke = np.einsum("eid,ejd,e,e->eij", grads, grads, area, k)  # (ne, 3, 3)
    rows = np.repeat(E, 3, axis=1).ravel()
    cols = np.tile(E, (1, 3)).ravel()
    A = sp.coo_matrix((Ke.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A

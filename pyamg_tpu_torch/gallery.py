"""Test problems: Poisson on regular grids, the rotated anisotropic
diffusion stencil, upwind advection and recirculating advection-diffusion,
and the P1 finite-element stiffness matrix on a triangle mesh (copies of
``pyamg_tpu/gallery/laplacian.py::poisson``,
``pyamg_tpu/gallery/stencil.py::stencil_grid``,
``pyamg_tpu/gallery/diffusion.py::diffusion_stencil_2d``,
``pyamg_tpu/gallery/advection.py::advection_2d`` and ``recirc_flow``,
``pyamg_tpu/gallery/mesh.py::regular_triangle_mesh``,
``pyamg_tpu/gallery/fem.py::gradgradform`` and
``pyamg_tpu/gallery/elasticity.py::linear_elasticity``, which the port
carries so that it imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["advection_2d", "diffusion_stencil_2d", "gradgradform",
           "linear_elasticity", "poisson", "recirc_flow",
           "regular_triangle_mesh", "stencil_grid"]


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


def diffusion_stencil_2d(epsilon=1.0, theta=0.0, type="FE"):
    """The 3x3 stencil of rotated anisotropic diffusion,
    -div(Q^T diag(1, eps) Q grad(u)) with Q the rotation by ``theta``:
    finite elements ("FE") or second-order finite differences with a
    centred four-corner cross term ("FD")."""
    eps = float(epsilon)
    c = np.cos(theta)
    s = np.sin(theta)
    cc = c * c
    ss = s * s
    cs = c * s

    if type == "FE":
        a = (-1 * eps - 1) * cc + (-1 * eps - 1) * ss + (3 * eps - 3) * cs
        b = (2 * eps - 4) * cc + (-4 * eps + 2) * ss
        cpt = (-1 * eps - 1) * cc + (-1 * eps - 1) * ss + (-3 * eps + 3) * cs
        d = (-4 * eps + 2) * cc + (2 * eps - 4) * ss
        e = (8 * eps + 8) * cc + (8 * eps + 8) * ss
        stencil = np.array(
            [[a, d, cpt],
             [b, e, b],
             [cpt, d, a]]
        ) / 6.0
    elif type == "FD":
        a = 0.5 * (eps - 1) * cs
        b = -(eps * ss + cc)
        cpt = -a
        d = -(eps * cc + ss)
        e = 2.0 * (eps + 1)
        stencil = np.array(
            [[a, d, cpt],
             [b, e, b],
             [cpt, d, a]]
        )
    else:
        raise ValueError("type must be 'FE' or 'FD'")
    return stencil


def advection_2d(grid, theta=np.pi / 4.0, l_bdry=1.0, b_bdry=1.0):
    """First-order upwind finite differences for (cos t, sin t) . grad(u)
    on a regular (ny, nx) grid, the inflow boundary values (left and
    bottom edges) moved to the right-hand side.  Returns (A, rhs), A CSR
    and nonsymmetric."""
    ny, nx = int(grid[0]), int(grid[1])
    n = nx * ny
    c = np.cos(theta)
    s = np.sin(theta)
    if c < 0 or s < 0:
        raise ValueError("theta must lie in [0, pi/2]")
    hx = 1.0 / nx
    hy = 1.0 / ny

    idx = np.arange(n).reshape(ny, nx)
    rows, cols, vals = [], [], []
    rhs = np.zeros(n)

    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(np.full(n, c / hx + s / hy))

    # left neighbour (x-upwind), the left-boundary inflow to the rhs
    has_left = idx[:, 1:]
    left = idx[:, :-1]
    rows.append(has_left.ravel())
    cols.append(left.ravel())
    vals.append(np.full(has_left.size, -c / hx))
    rhs[idx[:, 0]] += (c / hx) * l_bdry

    # bottom neighbour (y-upwind; row 0 is the bottom boundary row)
    has_down = idx[1:, :]
    down = idx[:-1, :]
    rows.append(has_down.ravel())
    cols.append(down.ravel())
    vals.append(np.full(has_down.size, -s / hy))
    rhs[idx[0, :]] += (s / hy) * b_bdry

    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    return A, rhs


def recirc_flow(grid, epsilon=1e-2, format=None):
    """Recirculating advection-diffusion -eps lap(u) + b . grad(u) on the
    unit square, b = 2 pi (y - 0.5, -(x - 0.5)): first-order upwind
    advection, centred diffusion, Dirichlet boundaries.  Nonsymmetric."""
    ny, nx = int(grid[0]), int(grid[1])
    n = nx * ny
    h = 1.0 / (nx + 1)
    x = (np.arange(nx) + 1) * (1.0 / (nx + 1))
    y = (np.arange(ny) + 1) * (1.0 / (ny + 1))
    X, Y = np.meshgrid(x, y, indexing="xy")  # shape (ny, nx)
    bx = 2.0 * np.pi * (Y - 0.5)
    by = -2.0 * np.pi * (X - 0.5)

    idx = np.arange(n).reshape(ny, nx)
    rows, cols, vals = [], [], []

    diag = np.full((ny, nx), 4.0 * epsilon / h ** 2)

    def add(rsel, csel, v):
        rows.append(rsel.ravel())
        cols.append(csel.ravel())
        vals.append(v.ravel())

    # diffusion off-diagonals
    add(idx[:, 1:], idx[:, :-1], np.full((ny, nx - 1), -epsilon / h ** 2))
    add(idx[:, :-1], idx[:, 1:], np.full((ny, nx - 1), -epsilon / h ** 2))
    add(idx[1:, :], idx[:-1, :], np.full((ny - 1, nx), -epsilon / h ** 2))
    add(idx[:-1, :], idx[1:, :], np.full((ny - 1, nx), -epsilon / h ** 2))

    # upwind advection in x: bx >= 0 takes the left neighbour, else the
    # right one
    pos = bx >= 0
    diag += np.abs(bx) / h
    m = pos[:, 1:]
    add(idx[:, 1:][m], idx[:, :-1][m], (-bx[:, 1:][m]) / h)
    m = (~pos)[:, :-1]
    add(idx[:, :-1][m], idx[:, 1:][m], bx[:, :-1][m] / h)

    # upwind advection in y
    posy = by >= 0
    diag += np.abs(by) / h
    m = posy[1:, :]
    add(idx[1:, :][m], idx[:-1, :][m], (-by[1:, :][m]) / h)
    m = (~posy)[:-1, :]
    add(idx[:-1, :][m], idx[1:, :][m], (by[:-1, :][m]) / h)

    add(idx, idx, diag)
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    if format is not None:
        A = A.asformat(format)
    return A


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


def _q1_element_stiffness(E, nu, hx, hy):
    """8x8 plane-strain Q1 element stiffness by 2x2 Gauss quadrature."""
    D = (E / ((1 + nu) * (1 - 2 * nu))) * np.array(
        [[1 - nu, nu, 0],
         [nu, 1 - nu, 0],
         [0, 0, (1 - 2 * nu) / 2.0]]
    )
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    K = np.zeros((8, 8))
    # local nodes (0,0), (1,0), (1,1), (0,1) on the reference square
    xi_sign = np.array([-1, 1, 1, -1], dtype=float)
    eta_sign = np.array([-1, -1, 1, 1], dtype=float)
    for xi in gp:
        for eta in gp:
            dN_dxi = 0.25 * xi_sign * (1 + eta_sign * eta)
            dN_deta = 0.25 * eta_sign * (1 + xi_sign * xi)
            dN_dx = dN_dxi * (2.0 / hx)
            dN_dy = dN_deta * (2.0 / hy)
            B = np.zeros((3, 8))
            B[0, 0::2] = dN_dx
            B[1, 1::2] = dN_dy
            B[2, 0::2] = dN_dy
            B[2, 1::2] = dN_dx
            detJ = (hx / 2.0) * (hy / 2.0)
            K += (B.T @ D @ B) * detJ
    return K


def linear_elasticity(grid, spacing=None, E=1e5, nu=0.3, format="bsr"):
    """Q1 plane-strain linear elasticity on a regular ``grid`` = (ny, nx)
    of nodes, the left edge (x = 0) clamped: (A, B) with A BSR of 2x2
    blocks (``format='bsr'``) on the free nodes, node-major on the
    row-major (ny, nx - 1) grid, and B the (2n, 3) rigid-body modes
    [(1, 0), (0, 1), (-y, x)] about the free nodes' centroid."""
    ny, nx = int(grid[0]), int(grid[1])
    if nx < 2 or ny < 2:
        raise ValueError("grid must be at least 2x2")
    if spacing is None:
        hx = hy = 1.0
    else:
        hy, hx = float(spacing[0]), float(spacing[1])
    n_nodes = nx * ny
    Ke = _q1_element_stiffness(E, nu, hx, hy)

    node = np.arange(n_nodes).reshape(ny, nx)
    n00 = node[:-1, :-1].ravel()
    n10 = node[:-1, 1:].ravel()
    n11 = node[1:, 1:].ravel()
    n01 = node[1:, :-1].ravel()
    elems = np.stack([n00, n10, n11, n01], axis=1)
    ne = elems.shape[0]

    dofs = np.empty((ne, 8), dtype=np.int64)
    dofs[:, 0::2] = 2 * elems
    dofs[:, 1::2] = 2 * elems + 1

    rows = np.repeat(dofs, 8, axis=1).ravel()
    cols = np.tile(dofs, (1, 8)).ravel()
    vals = np.tile(Ke.ravel(), ne)
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(2 * n_nodes, 2 * n_nodes)).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()

    clamped = node[:, 0]
    clamped_dofs = np.concatenate([2 * clamped, 2 * clamped + 1])
    keep = np.ones(2 * n_nodes, dtype=bool)
    keep[clamped_dofs] = False
    A = A[keep][:, keep].tocsr()

    X, Y = np.meshgrid(np.arange(nx) * hx, np.arange(ny) * hy, indexing="xy")
    X = X.ravel()
    Y = Y.ravel()
    free_nodes = np.flatnonzero(np.isin(np.arange(n_nodes), clamped,
                                        invert=True))
    Xf = X[free_nodes] - X[free_nodes].mean()
    Yf = Y[free_nodes] - Y[free_nodes].mean()
    nf = len(free_nodes)
    B = np.zeros((2 * nf, 3))
    B[0::2, 0] = 1.0
    B[1::2, 1] = 1.0
    B[0::2, 2] = -Yf
    B[1::2, 2] = Xf

    if format == "bsr":
        A = A.tobsr(blocksize=(2, 2))
    elif format is not None:
        A = A.asformat(format)
    return A, B

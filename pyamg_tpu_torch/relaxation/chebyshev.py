"""Chebyshev and MLS polynomial smoother coefficients (a copy of
``pyamg_tpu/relaxation/chebyshev.py``): NumPy polynomial arithmetic that
the device compile turns into the polynomial smoother's Horner steps."""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_polynomial_coefficients", "mls_polynomial_coefficients"]


def chebyshev_polynomial_coefficients(a, b, degree):
    """Coefficients (descending, constant term last) of the polynomial p
    for which the error propagator of ``x <- x + p(A) r`` is the scaled and
    shifted Chebyshev polynomial on [a, b] with q(0) = 1, q(t) = 1 - t p(t).
    """
    if a >= b:
        raise ValueError("expected a < b")
    degree = int(degree)
    if degree < 1:
        raise ValueError("expected degree >= 1")
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    roots = 0.5 * (b - a) * (std_roots + 1.0) + a
    monic = np.poly(roots)              # descending, monic, degree + 1
    q = monic / monic[-1]               # constant term 1
    return -q[:-1]                      # p(t) = (1 - q(t)) / t


def mls_polynomial_coefficients(rho, degree):
    """(descending coefficients, roots) of the degree-``degree`` MLS
    smoother polynomial for spectral radius ``rho``: Chebyshev roots over
    [rho / 9, rho]."""
    degree = int(degree)
    a = rho / 9.0
    b = rho
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    roots = 0.5 * (b - a) * (std_roots + 1.0) + a
    monic = np.poly(roots)
    q = monic / monic[-1]
    return -q[:-1], roots

"""Host relaxation of the port's SA setup (copies from
``pyamg_tpu/relaxation``): the Gauss-Seidel sweeps of the candidate
improvement, the smoother spec resolution and the Chebyshev / MLS
polynomial coefficients."""

from . import relaxation
from .chebyshev import (chebyshev_polynomial_coefficients,
                        mls_polynomial_coefficients)
from .smoothing import change_smoothers

__all__ = ["relaxation", "chebyshev_polynomial_coefficients",
           "mls_polynomial_coefficients", "change_smoothers"]

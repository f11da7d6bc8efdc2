"""Polynomial-basis transform matrices, derived from first principles.

Port of ``miniweatherml_tpu/ops/transforms.py`` (numpy only).  The reference
ships 6763 lines of symbolically pre-generated constant tables
(model/modules/helpers/TransformMatrices.h: sten_to_coefs, coefs_to_gll,
coefs_to_deriv, gll_to_coefs, sten_to_gll, cells-equal transforms, ...).
Here every matrix is *derived* on first use with exact rational arithmetic
(Fraction-based Vandermonde inversions, ``ops/weno.py``) and cached.

Conventions match the reference: polynomials are monomial-coefficient
vectors a_j of p(x) = sum_j a_j x^j on the unit cell x in [-1/2, 1/2];
stencils are cell averages of the ord cells centered on the target cell.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .gll import gll_points
from .weno import _cell_average_matrix, sten_to_coefs_matrix

__all__ = [
    "sten_to_coefs", "coefs_to_gll", "gll_to_coefs", "sten_to_gll",
    "coefs_to_deriv", "coefs_to_prim", "cell_avg_of_monomials",
]


@lru_cache(maxsize=None)
def sten_to_coefs(ord: int) -> np.ndarray:
    """(ord, ord): centered cell-average stencil -> monomial coefficients
    (reference TransformMatrices::sten_to_coefs)."""
    hs = (ord - 1) // 2
    return sten_to_coefs_matrix(tuple(range(-hs, hs + 1)))


@lru_cache(maxsize=None)
def coefs_to_gll(ord: int, npts: int | None = None) -> np.ndarray:
    """(npts, ord): monomial coefficients -> values at npts GLL points of
    the unit cell (reference TransformMatrices::coefs_to_gll /
    coefs_to_gll_lower for npts < ord)."""
    npts = ord if npts is None else npts
    return np.array([[x ** j for j in range(ord)] for x in gll_points(npts)])


@lru_cache(maxsize=None)
def gll_to_coefs(ord: int) -> np.ndarray:
    """(ord, ord): values at ord GLL points -> monomial coefficients
    (reference TransformMatrices::gll_to_coefs), the float inverse of the
    Vandermonde: GLL nodes are irrational."""
    return np.linalg.inv(coefs_to_gll(ord))


@lru_cache(maxsize=None)
def sten_to_gll(ord: int, npts: int | None = None) -> np.ndarray:
    """(npts, ord): stencil -> GLL point values, the composition the
    reference tabulates as sten_to_gll_lower."""
    return coefs_to_gll(ord, npts) @ sten_to_coefs(ord)


@lru_cache(maxsize=None)
def coefs_to_deriv(ord: int) -> np.ndarray:
    """(ord, ord): monomial coefficients of p -> coefficients of dp/dx
    (reference TransformMatrices::coefs_to_deriv): D[j-1, j] = j."""
    D = np.zeros((ord, ord))
    for j in range(1, ord):
        D[j - 1, j] = j
    return D


@lru_cache(maxsize=None)
def coefs_to_prim(ord: int) -> np.ndarray:
    """((ord+1), ord): coefficients of p -> coefficients of its
    antiderivative with P(0) = 0 (inverse operation of coefs_to_deriv)."""
    P = np.zeros((ord + 1, ord))
    for j in range(ord):
        P[j + 1, j] = 1.0 / (j + 1)
    return P


@lru_cache(maxsize=None)
def cell_avg_of_monomials(offsets: tuple[int, ...]) -> np.ndarray:
    """A[m][j] = average of x^j over the unit cell centered at offsets[m]
    (the forward operator whose exact inverse is sten_to_coefs; reference
    cells_equal_to_coefs family)."""
    return np.array([[float(v) for v in row]
                     for row in _cell_average_matrix(offsets)])

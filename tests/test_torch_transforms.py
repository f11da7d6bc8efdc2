"""The port's transform matrices (``ops/transforms.py``) against the JAX
package's, bit for bit, and the JAX suite's polynomial checks
(tests/test_transforms.py) on the port's matrices."""

import numpy as np
import pytest

from miniweatherml_tpu.ops import transforms as JT
from miniweatherml_tpu_torch.ops import transforms as PT
from miniweatherml_tpu_torch.ops.gll import gll_points


def _offsets(ord_):
    hs = (ord_ - 1) // 2
    return tuple(range(-hs, hs + 1))


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_matrices_equal_jax(ord_):
    pairs = [(PT.sten_to_coefs(ord_), JT.sten_to_coefs(ord_)),
             (PT.coefs_to_gll(ord_), JT.coefs_to_gll(ord_)),
             (PT.gll_to_coefs(ord_), JT.gll_to_coefs(ord_)),
             (PT.sten_to_gll(ord_), JT.sten_to_gll(ord_)),
             (PT.coefs_to_deriv(ord_), JT.coefs_to_deriv(ord_)),
             (PT.coefs_to_prim(ord_), JT.coefs_to_prim(ord_)),
             (PT.cell_avg_of_monomials(_offsets(ord_)),
              JT.cell_avg_of_monomials(_offsets(ord_)))]
    for npts in range(2, ord_ + 1):
        pairs += [(PT.coefs_to_gll(ord_, npts), JT.coefs_to_gll(ord_, npts)),
                  (PT.sten_to_gll(ord_, npts), JT.sten_to_gll(ord_, npts))]
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape and got.dtype == want.dtype, i
        assert np.array_equal(got, want), i


@pytest.mark.parametrize("ord_", [3, 5, 7, 9])
def test_sten_to_coefs_reconstructs_polynomials(ord_):
    """Cell averages of any polynomial of degree < ord map back to its
    coefficients."""
    rng = np.random.default_rng(ord_)
    coefs = rng.normal(size=ord_)
    sten = PT.cell_avg_of_monomials(_offsets(ord_)) @ coefs
    np.testing.assert_allclose(PT.sten_to_coefs(ord_) @ sten, coefs,
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("ord_", [2, 3, 5, 7])
def test_gll_roundtrip(ord_):
    rng = np.random.default_rng(ord_)
    coefs = rng.normal(size=ord_)
    vals = PT.coefs_to_gll(ord_) @ coefs
    x = gll_points(ord_)
    expect = sum(c * x ** j for j, c in enumerate(coefs))
    np.testing.assert_allclose(vals, expect, rtol=1e-12)
    np.testing.assert_allclose(PT.gll_to_coefs(ord_) @ vals, coefs,
                               rtol=1e-8, atol=1e-10)


def test_sten_to_gll_composition():
    rng = np.random.default_rng(0)
    coefs = rng.normal(size=5)
    sten = PT.cell_avg_of_monomials(_offsets(5)) @ coefs
    edge_vals = PT.sten_to_gll(5, 2) @ sten   # values at x = -1/2, +1/2
    expect = [sum(c * x ** j for j, c in enumerate(coefs))
              for x in (-0.5, 0.5)]
    np.testing.assert_allclose(edge_vals, expect, rtol=1e-9, atol=1e-10)


def test_deriv_and_prim_are_inverse():
    rng = np.random.default_rng(1)
    coefs = rng.normal(size=6)
    d = PT.coefs_to_deriv(6) @ coefs
    expect = np.array([(j + 1) * coefs[j + 1] for j in range(5)] + [0.0])
    np.testing.assert_allclose(d, expect, rtol=1e-12)
    p = PT.coefs_to_prim(6) @ d
    np.testing.assert_allclose(p[1:6], coefs[1:], rtol=1e-12)

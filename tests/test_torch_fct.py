"""The port's FCT functions (``ops/fct.py``) against the JAX package, on the
CPU in float64.

``fct_scale_div_plain`` is held to the JAX package's own Pallas kernels,
``fct_scale_div_pallas`` (lane axis, x) and ``fct_scale_div_pallas_sub``
(sublane axis, y and z), run in interpret mode as the JAX suite runs them
on the CPU, in each form the dycore uses: the first direction, an
accumulating one, and the last one with the SSPRK3 tracer stage update with
and without the second base; mixed positive flags.  ``fct_mult_plain`` is
held to ``Dycore._fct_mult``.  Both compute the same IEEE operations in the
same order, so the bound is rel 1e-12 with bitwise equality expected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.core.coupler import Grid as JGrid
from miniweatherml_tpu.dycore.euler import Dycore as JDycore
from miniweatherml_tpu.ops.pallas_recon import (fct_scale_div_pallas,
                                                fct_scale_div_pallas_sub)
from miniweatherml_tpu_torch.ops.fct import (fct_mult, fct_scale_div,
                                             fct_scale_div_plain)

torch.set_num_threads(1)

SHAPE = (3, 1, 4, 12, 16)            # (ntr, nens, nz, ny, nx)
POSITIVE = (True, False, True)
RK = (0.75, 0.25, 0.1)               # c0, c1, cdt of an SSPRK3 stage
DIRS = {"x": -1, "y": -2, "z": -3}
FORMS = ("first", "accumulate", "rk_tr1", "rk_no_tr1")


def _inputs(axis, seed):
    """Faces of both signs with zeros, multipliers in (0, 1] with ones, a
    running tendency and stage bases that go negative after the update."""
    rng = np.random.default_rng(seed)
    fshape = list(SHAPE)
    fshape[axis] += 1
    F = rng.standard_normal(fshape)
    F[rng.random(fshape) < 0.1] = 0.0
    mult = rng.uniform(0.05, 1.0, SHAPE)
    mult[rng.random(SHAPE) < 0.3] = 1.0
    t_prev = rng.standard_normal(SHAPE)
    tr0 = rng.uniform(-0.2, 1.0, SHAPE)
    tr1 = rng.uniform(-0.2, 1.0, SHAPE)
    return F, mult, t_prev, tr0, tr1


def _jax(direction, F, mult, t_prev, n, dxi, rk):
    """The JAX kernel of ``direction`` on the layout the JAX dycore hands
    it (``Dycore._fct_div_pallas``), reshaped back to 5-D."""
    ntr, nens, nz, ny, nx = SHAPE
    if direction == "x":
        lead, tail = (ntr, nens * nz * ny), ()
        call = fct_scale_div_pallas
    elif direction == "y":
        lead, tail = (ntr, nens * nz), (nx,)
        call = fct_scale_div_pallas_sub
    else:
        lead, tail = (ntr, nens), (ny * nx,)
        call = fct_scale_div_pallas_sub

    def view(a, m):
        return None if a is None else jnp.asarray(a.reshape(lead + (m,) + tail))
    jrk = None
    if rk is not None:
        c0, c1, cdt, tr0, tr1 = rk
        jrk = (np.array([c0, c1, cdt]), view(tr0, n),
               view(tr1, n), POSITIVE)
    out = call(view(F, n + 1), view(mult, n), view(t_prev, n), n, dxi,
               rk=jrk)
    return np.asarray(out).reshape(SHAPE)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("direction", list(DIRS))
def test_fct_scale_div_matches_jax_kernel(direction, form):
    axis = DIRS[direction]
    n = SHAPE[axis]
    dxi = 1.0 / (250.0 + 50.0 * abs(axis))
    F, mult, t_prev, tr0, tr1 = _inputs(axis, seed=abs(axis) * 10
                                        + FORMS.index(form))
    if form == "first":
        t_prev = None
    rk = None
    if form.startswith("rk"):
        rk = (*RK, tr0, tr1 if form == "rk_tr1" else None)
    want = _jax(direction, F, mult, t_prev, n, dxi, rk)

    t = (lambda a: None if a is None else torch.from_numpy(a.copy()))
    prev = t(t_prev)
    got = fct_scale_div(t(F), t(mult), prev, axis, n, dxi,
                        rk=None if rk is None
                        else (*rk[:3], t(rk[3]), t(rk[4]), POSITIVE))
    if prev is not None:
        assert got is prev   # written in place, as the JAX kernel donates
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    if rk is not None:
        # the positive tracers were clamped, the other one went negative
        assert got[0].min() == 0.0 and got[2].min() == 0.0
        assert got[1].min() < 0.0


def test_fct_scale_div_plain_is_the_reference_formulation():
    """The fused form equals today's two-step form: scale all n + 1 faces
    from the upwind side, then -(F[f+1] - F[f]) * dxi, bit for bit."""
    F, mult, _, _, _ = _inputs(-2, seed=5)
    F, mult = torch.from_numpy(F), torch.from_numpy(mult)
    ones = torch.ones(SHAPE[:3] + (1,) + SHAPE[4:], dtype=torch.float64)
    left = torch.cat([ones, mult], dim=-2)
    right = torch.cat([mult, ones], dim=-2)
    Fs = F * torch.where(F > 0, left, torch.where(F < 0, right, 1.0))
    two_step = -(Fs[..., 1:, :] - Fs[..., :-1, :]) * (1.0 / 300.0)
    fused = fct_scale_div_plain(F, mult, None, -2, SHAPE[-2], 1.0 / 300.0)
    assert torch.equal(fused, two_step)


@pytest.mark.parametrize("dims", [3, 2])
def test_fct_mult_matches_jax(dims):
    """Masses that some cells would overdraw (the multiplier < 1 there)."""
    rng = np.random.default_rng(dims)
    ntr, nens, nz, ny, nx = SHAPE
    if dims == 2:
        ny = 1
    shape = (ntr, nens, nz, ny, nx)
    tr = rng.uniform(-1e-4, 1e-2, shape)
    Fx = rng.standard_normal((ntr, nens, nz, ny, nx + 1))
    Fz = rng.standard_normal((ntr, nens, nz + 1, ny, nx))
    Fy = (rng.standard_normal((ntr, nens, nz, ny + 1, nx)) if dims == 3
          else None)
    g = JGrid(nx=nx, ny=ny, nz=nz, nens=nens, xlen=4000.0, ylen=3000.0,
              zlen=1000.0)
    dt = 0.9
    want = np.asarray(JDycore(ord=5)._fct_mult(
        g, jnp.asarray(tr), POSITIVE, jnp.asarray(Fx),
        None if Fy is None else jnp.asarray(Fy), jnp.asarray(Fz), dt))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = fct_mult(t(tr), POSITIVE, t(Fx), t(Fy), t(Fz), dt, g.dx, g.dy,
                   g.dz).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    assert (got < 1.0).any() and (got[1] == 1.0).all()
    assert got.min() >= 0.0


def test_fct_wrappers_reject_bad_input():
    F, mult, _, _, _ = _inputs(-1, seed=1)
    F, mult = torch.from_numpy(F), torch.from_numpy(mult)
    with pytest.raises(ValueError, match="device"):
        fct_scale_div(F.to("meta"), mult.to("meta"), None, -1, SHAPE[-1],
                      1.0)
    with pytest.raises(ValueError, match="device"):
        fct_mult(mult.to("meta"), POSITIVE, F, None, F, 1.0, 1.0, 1.0, 1.0)

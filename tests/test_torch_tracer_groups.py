"""The tracer groups the card's wrappers form above one launch's tracer
count (``ops/direction_fluxes.py::in_tracer_groups`` above 9 tracers,
``ops/fct.py::fct_mult_groups`` / ``fct_scale_div_groups`` above 64),
driven here by the plain versions: equal to one plain call bit for bit."""

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.ops.direction_fluxes import (
    MAX_TRACERS, NUM_STATE, direction_fluxes_plain, in_tracer_groups)
from miniweatherml_tpu_torch.ops.fct import (MAX_TRACERS as FCT_MAX,
                                             fct_mult_groups, fct_mult_plain,
                                             fct_scale_div_groups,
                                             fct_scale_div_plain)
from miniweatherml_tpu_torch.ops.weno import weno_matrices

torch.set_num_threads(1)

NTR_FLUX, NTR_FCT = 12, 70
NENS, NZ, NY, NX = 1, 10, 8, 12
C0, GAMMA = 27.5629410929725921310572974482, 1004.64 / (1004.64 - 287.042)
DIRS = {"x": (-1, NX, 1), "y": (-2, NY, 2), "z": (-3, NZ, 3)}


def _prim(rng, ntr):
    """De-densitized variables: small density and (rho theta)
    perturbations, winds of both signs, positive tracer concentrations."""
    shape = (NENS, NZ, NY, NX)
    rows = [0.01 * rng.standard_normal(shape)]
    rows += [5.0 * rng.standard_normal(shape) for _ in range(3)]
    rows += [rng.standard_normal(shape)]
    rows += [rng.uniform(0.0, 1e-3, shape) for _ in range(ntr)]
    return torch.as_tensor(np.stack(rows))


def _hy(nlev):
    z = np.linspace(0.0, 1.0, nlev)[None, :]
    return (torch.as_tensor(1.2 - 0.5 * z), torch.as_tensor(360.0 - 100 * z))


@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_flux_groups_equal_one_call(direction):
    assert NTR_FLUX > MAX_TRACERS
    rng = np.random.default_rng(7)
    prim = _prim(rng, NTR_FLUX)
    axis, n, nid = DIRS[direction]
    hy_r, hy_t = _hy(NZ + 1 if axis == -3 else NZ)
    args = (axis, n, 2, nid, C0, GAMMA, hy_r, hy_t, weno_matrices(5), 0.0,
            1.0 / 400.0)
    launches = []

    def launch(p, *a, strips=None):
        launches.append(p.shape[0] - NUM_STATE)
        return direction_fluxes_plain(p, *a, strips=strips)
    want = direction_fluxes_plain(prim, *args)
    got = in_tracer_groups(launch, prim, *args)
    assert launches == [MAX_TRACERS, NTR_FLUX - MAX_TRACERS]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flux_groups_equal_one_call_with_strips():
    """The halo-strip form: lo / hi strips grouped like ``prim``."""
    rng = np.random.default_rng(8)
    prim = _prim(rng, NTR_FLUX)
    hp = 4  # (ord - 1) // 2 + 1 at ord 5
    lo = _prim(rng, NTR_FLUX)[..., :hp].contiguous()
    hi = _prim(rng, NTR_FLUX)[..., :hp].contiguous()
    hy_r, hy_t = _hy(NZ)
    args = (-1, NX, 2, 1, C0, GAMMA, hy_r, hy_t, weno_matrices(5), 0.0,
            1.0 / 400.0)
    for ends in ((0, 0), (2, 0)):
        strips = (lo, hi, *ends)
        want = direction_fluxes_plain(prim, *args, strips=strips)
        got = in_tracer_groups(direction_fluxes_plain, prim, *args,
                               strips=strips)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fct_inputs(rng, ntr, ny=NY):
    shape = (ntr, NENS, NZ, ny, NX)

    def faces(axis):
        s = list(shape)
        s[axis] += 1
        return torch.as_tensor(rng.standard_normal(s))
    tr = torch.as_tensor(rng.uniform(-1e-4, 1e-2, shape))
    positive = [bool(v) for v in rng.random(ntr) < 0.8]
    return tr, positive, faces(-1), faces(-2), faces(-3)


@pytest.mark.parametrize("dims", [3, 2])
def test_fct_mult_groups_equal_one_call(dims):
    assert NTR_FCT > FCT_MAX
    rng = np.random.default_rng(dims)
    tr, positive, Fx, Fy, Fz = _fct_inputs(rng, NTR_FCT,
                                           NY if dims == 3 else 1)
    Fy = Fy if dims == 3 else None
    args = (0.9, 400.0, 400.0, 250.0)
    want = fct_mult_plain(tr, positive, Fx, Fy, Fz, *args)
    got = fct_mult_groups(fct_mult_plain, tr, positive, Fx, Fy, Fz, *args)
    assert torch.equal(got, want)
    assert (want < 1.0).any() and not all(positive)


@pytest.mark.parametrize("form", ["first", "accumulate", "rk_tr1",
                                  "rk_no_tr1", "edges"])
@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_fct_scale_div_groups_equal_one_call(direction, form):
    rng = np.random.default_rng(11)
    axis, n, _ = DIRS[direction]
    tr, positive, Fx, Fy, Fz = _fct_inputs(rng, NTR_FCT)
    F = {-1: Fx, -2: Fy, -3: Fz}[axis]
    mult = torch.as_tensor(rng.uniform(0.05, 1.0, tuple(tr.shape)))
    t_prev = torch.as_tensor(rng.standard_normal(tuple(tr.shape)))
    tr1 = torch.as_tensor(rng.uniform(-0.2, 1.0, tuple(tr.shape)))
    rk = edges = None
    if form.startswith("rk"):
        rk = (0.75, 0.25, 0.1, tr, tr1 if form == "rk_tr1" else None,
              positive)
    if form == "edges":
        eshape = list(tr.shape)
        eshape[axis] = 1
        edges = tuple(torch.as_tensor(rng.uniform(0.05, 1.0, eshape))
                      for _ in range(2))
    prev = None if form == "first" else t_prev
    want = fct_scale_div_plain(F, mult, None if prev is None else
                               prev.clone(), axis, n, 1.0 / 400.0, rk, edges)
    got_prev = None if prev is None else prev.clone()
    got = fct_scale_div_groups(fct_scale_div_plain, F, mult, got_prev, axis,
                               n, 1.0 / 400.0, rk, edges)
    assert torch.equal(got, want)
    if got_prev is not None:
        assert got is got_prev  # written in place, as one call does

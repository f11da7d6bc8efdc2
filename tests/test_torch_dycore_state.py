"""The dycore's state transforms (``ops/dycore_state.py``) on the CPU: the
plain versions that the CUDA kernels are held to, against the eager
expressions the dycore ran before them.

The plain versions change two things in those expressions: a division by
a number goes through a 0-d tensor, and the tracers that add mass are
summed left to right in registry order instead of by ``torch.sum`` over the
stack with the others zeroed.  On the CPU both give the same bits (PyTorch
divides by a number exactly there, and its sum over the leading axis adds
the rows in order), so every case here is held bit for bit.  The round trip
coupler -> dynamics -> coupler is held to the port's kernel tolerances
(1e-5 of scale in f32, 1e-12 in f64).
"""

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.ops import dycore_state as ds
from miniweatherml_tpu_torch.ops.direction_fluxes import (IDR, IDT, IDU, IDV,
                                                          IDW)
from miniweatherml_tpu_torch.ops.fct import MAX_TRACERS, per_tracer
from miniweatherml_tpu_torch.utils.profiling import counter

KESSLER = ((True, True, True), 0)
# microphysics_p3.h:103-112: the masses of cloud, rain and ice and vapor
P3 = ((True, False, True, False, True, False, False, False, True), 8)
CITY = ((True,), 0)

# name: (registry (adds_mass, idWV), (nens, nz, ny, nx))
CASES = {
    "kessler": (KESSLER, (1, 12, 6, 10)),
    "p3": (P3, (1, 12, 6, 10)),
    "city": (CITY, (2, 12, 5, 9)),
    "slab": (KESSLER, (1, 12, 1, 16)),
}
DTYPES = (torch.float32, torch.float64)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

R_D, R_V, CP_D = 287.0, 461.0, 1003.0
GAMMA = CP_D / (CP_D - R_D)
C0 = (R_D * 1.0e5 ** (-R_D / CP_D)) ** GAMMA


def _thermo(adds_mass, idWV):
    return dict(idWV=idWV, adds_mass=list(adds_mass), R_d=R_D, R_v=R_V,
                gamma=GAMMA, C0=C0)


def _coupler(case, dtype, seed=7):
    """A coupler's fields of ``case``: a stratified column with winds,
    temperature noise, vapor everywhere and the other tracers in about
    half of the cells (zeros elsewhere), and its hydrostatic profiles."""
    (adds, idWV), shape = CASES[case]
    rng = np.random.default_rng(seed)
    nens, nz = shape[:2]
    z = np.linspace(0.0, 1.0, nz)[None, :, None, None]
    rho_d = 1.2 * np.exp(-z) * (1 + 0.01 * rng.standard_normal(shape))
    temp = 300.0 - 60.0 * z + rng.standard_normal(shape)
    u, v, w = (10.0 * rng.standard_normal(shape) for _ in range(3))
    trs = []
    for i in range(len(adds)):
        t = 1e-3 * rng.random(shape) * rho_d
        if i != idWV:
            t = np.where(rng.random(shape) < 0.5, 0.0, t)
        trs.append(t)
    hyc = 1.2 * np.exp(-np.linspace(0.0, 1.0, nz))[None].repeat(nens, 0)
    hyt = 300.0 * hyc
    as_t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return (tuple(as_t(a) for a in (rho_d, u, v, w, temp)),
            [as_t(t) for t in trs], as_t(hyc), as_t(hyt), adds, idWV)


# The expressions the dycore ran before ops/dycore_state.py
# (dycore/euler.py: _tracer_mass, convert_coupler_to_dynamics,
# _dyn_to_coupler_fields and the prim concatenation of _tendencies).

def _old_mass(adds, tr):
    if all(adds):
        return torch.sum(tr, dim=0)
    return torch.sum(per_tracer(tr, [not a for a in adds], torch.zeros_like),
                     dim=0)


def _old_to_dynamics(fields, tracers, hyc, hyt, adds, idWV):
    rho_d, u, v, w, temp = fields
    hyc = hyc[:, :, None, None]
    hyt = hyt[:, :, None, None]
    tr = torch.stack(tracers)
    rho_v = tr[idWV]
    press = rho_d * R_D * temp + rho_v * R_V * temp
    rho = rho_d + _old_mass(adds, tr)
    theta = (press / C0) ** (1.0 / GAMMA) / rho
    s = torch.stack([rho - hyc, rho * u, rho * v, rho * w, rho * theta - hyt])
    return s, tr


def _old_to_coupler(s, tr, hyc, hyt, adds, idWV):
    hyc = hyc[:, :, None, None]
    hyt = hyt[:, :, None, None]
    rho = s[IDR] + hyc
    u, v, w = s[IDU] / rho, s[IDV] / rho, s[IDW] / rho
    theta = (s[IDT] + hyt) / rho
    press = C0 * (rho * theta) ** GAMMA
    rho_d = rho - _old_mass(adds, tr)
    rho_v = tr[idWV]
    temp = press / (rho_d * R_D + rho_v * R_V)
    return rho_d, u, v, w, temp


def _old_prim(s, tr, hyc):
    full_r = s[IDR] + hyc[:, :, None, None]
    return torch.cat([s[IDR:IDU], s[IDU:IDT] / full_r, s[IDT:IDT + 1],
                      tr / full_r])


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert torch.equal(g, w), (
            f"{what} output {i}: max diff {(g - w).abs().max().item()}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_to_dynamics_plain_is_the_old_expression(case, dtype):
    fields, trs, hyc, hyt, adds, idWV = _coupler(case, dtype)
    got = ds.coupler_to_dynamics_plain(*fields, trs, hyc, hyt,
                                       **_thermo(adds, idWV))
    _assert_equal(got, _old_to_dynamics(fields, trs, hyc, hyt, adds, idWV),
                  "to dynamics")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_to_coupler_plain_is_the_old_expression(case, dtype):
    fields, trs, hyc, hyt, adds, idWV = _coupler(case, dtype)
    s, tr = _old_to_dynamics(fields, trs, hyc, hyt, adds, idWV)
    got = ds.dynamics_to_coupler_plain(s, tr, hyc, hyt,
                                       **_thermo(adds, idWV))
    _assert_equal(got, _old_to_coupler(s, tr, hyc, hyt, adds, idWV),
                  "to coupler")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_dedensitize_plain_is_the_old_expression(case, dtype):
    fields, trs, hyc, hyt, adds, idWV = _coupler(case, dtype)
    s, tr = _old_to_dynamics(fields, trs, hyc, hyt, adds, idWV)
    got = ds.dedensitize_plain(s, tr, hyc)
    assert got.is_contiguous()
    _assert_equal((got,), (_old_prim(s, tr, hyc),), "prim")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_returns_the_coupler_fields(case, dtype):
    fields, trs, hyc, hyt, adds, idWV = _coupler(case, dtype)
    th = _thermo(adds, idWV)
    s, tr = ds.coupler_to_dynamics_plain(*fields, trs, hyc, hyt, **th)
    back = ds.dynamics_to_coupler_plain(s, tr, hyc, hyt, **th)
    for name, a, b in zip(("rho_d", "u", "v", "w", "temp"), fields, back):
        scale = a.abs().max().item()
        assert (a - b).abs().max().item() <= TOL[dtype] * scale, name
    _assert_equal(tuple(tr), tuple(trs), "tracers")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_cpu_tensors_take_the_plain_versions(case, dtype):
    """The wrappers given CPU tensors run their plain versions and launch
    nothing."""
    fields, trs, hyc, hyt, adds, idWV = _coupler(case, dtype)
    th = _thermo(adds, idWV)
    n0 = counter("dycore_state.launches")
    s, tr = ds.coupler_to_dynamics(*fields, trs, hyc, hyt, **th)
    _assert_equal((s, tr), ds.coupler_to_dynamics_plain(
        *fields, trs, hyc, hyt, **th), "to dynamics")
    _assert_equal((ds.dedensitize(s, tr, hyc),),
                  (ds.dedensitize_plain(s, tr, hyc),), "prim")
    _assert_equal(ds.dynamics_to_coupler(s, tr, hyc, hyt, **th),
                  ds.dynamics_to_coupler_plain(s, tr, hyc, hyt, **th),
                  "to coupler")
    assert counter("dycore_state.launches") == n0 == 0


def test_dedensitize_plain_takes_no_tracers():
    fields, trs, hyc, hyt, adds, idWV = _coupler("kessler", torch.float64)
    s, _ = _old_to_dynamics(fields, trs, hyc, hyt, adds, idWV)
    tr = s.new_empty((0,) + s.shape[1:])
    _assert_equal((ds.dedensitize_plain(s, tr, hyc),),
                  (_old_prim(s, tr, hyc),), "prim")


@pytest.mark.parametrize("ntr,idWV,nflags,exponent", [
    (0, 0, 0, 1.4),                        # no tracer
    (MAX_TRACERS + 1, 0, MAX_TRACERS + 1, 1.4),  # beyond the mask
    (3, 3, 3, 1.4),                        # vapor index outside
    (3, 0, 2, 1.4),                        # a flag missing
    (3, 0, 3, 2.0),                        # pow's special cases
    (3, 0, 3, 0.5),
    (3, 0, 3, 1.0 + 2.0 ** -30),           # 1 once rounded to f32
])
def test_conversion_kernels_refuse_what_they_do_not_take(ntr, idWV, nflags,
                                                         exponent):
    """The checks the wrappers make before a launch, on the host."""
    with pytest.raises(ValueError):
        ds._registry(ntr, idWV, [True] * nflags, exponent,
                     dtype=torch.float32)


def test_registry_mask_has_the_mass_flags():
    adds, idWV = P3
    assert ds._registry(len(adds), idWV, adds, GAMMA, 1.0 / GAMMA,
                        dtype=torch.float32) == 0b100010101

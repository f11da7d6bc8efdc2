"""P3 sedimentation as one pass plus a rerun, against the pair it replaced,
on the CPU.

``p3_scheme`` takes its sedimentation as ``sed_step`` (every cell's fall
speeds once, their maximum and one sub-step at dts = dt), the sub-step count
made of that maximum, and ``sed_columns`` handed ``sed_step``'s outputs as
``rerun``: kept where the count is 1, the whole sub-cycle from the inputs
where it is above.  Before, it took ``sed_vmax`` (the maximum alone), the
count, and ``sed_columns`` from the inputs.  Here the plain versions of the
two compositions are held to each other bit for bit (``torch.equal``) on
what one step of a 16x2x12 f64 and f32 supercell hands the sedimentation:
smooth layers (``seed_layers``) and white-noise mixed regimes
(``seed_mixed_regimes``), both tiers, ``do_predict_nc`` both ways, at a dt
of one sub-step and at one of several; and the whole scheme (with part3's
diagnostics too) through either composition.  The scheme against JAX's is
tests/test_torch_p3_phases.py::test_state_after_sedimentation_matches_jax.
"""

from functools import lru_cache

import pytest
import torch

from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED
from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables
from miniweatherml_tpu_torch.utils.profiling import counter

torch.set_num_threads(1)

# one sub-step at 2 s on the seeded states; several at 400 s
DT_ONE, DT_MANY = 2.0, 400.0


@lru_cache(maxsize=None)
def _inputs(seed, dtype):
    """(the scheme's positional arguments, qv_prev, t_prev) of the seeded
    16x2x12 state."""
    raw = dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=2, nz=12,
               xlen=40000.0, ylen=40000.0, zlen=16000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0, dtype=dtype)
    state = supercell_p3.build(config_from_dict(raw), "cpu")[0]
    state = getattr(supercell_p3, seed)(state)
    ins = PP.p3_wrapper_inputs(state)
    return (*ins[:12], state["density_dry"], ins[12]), ins[13], ins[14]


@lru_cache(maxsize=None)
def _tables():
    return load_p3_tables()


def _scheme(seed, dtype, dt, tier, pnc, **kw):
    args, qv_prev, t_prev = _inputs(seed, dtype)
    return PP.p3_scheme(*args, dt, tables=_tables() if tier == "tables"
                        else None, qv_prev=qv_prev, t_prev=t_prev,
                        do_predict_nc=pnc, **kw)


@lru_cache(maxsize=None)
def _sed_args(seed, dtype, tier, pnc):
    """The (positional, keyword) arguments p3_scheme hands sed_step."""
    seen = {}
    step = SED.sed_step

    def spy(*a, **k):
        seen["args"] = (a, k)
        return step(*a, **k)
    SED.sed_step = spy
    try:
        _scheme(seed, dtype, DT_ONE, tier, pnc)
    finally:
        SED.sed_step = step
    return seen["args"]


def _count(dt, vmax, dz):
    """p3_scheme's sub-step count on one device."""
    return PP._max(torch.ceil(dt * vmax / (0.9 * dz.min())), 1.0)


CASES = [(seed, dtype, tier, pnc)
         for seed in ("seed_layers", "seed_mixed_regimes")
         for dtype in ("float64", "float32")
         for tier in ("tables", "approx")
         for pnc in (False, True)]


@pytest.mark.parametrize("dt", [DT_ONE, DT_MANY])
@pytest.mark.parametrize("seed,dtype,tier,pnc", CASES)
def test_step_and_rerun_equal_the_former_pair(seed, dtype, tier, pnc, dt):
    """_p3_sed_step -> count -> _p3_sed_columns(rerun) against
    _p3_sed_vmax -> count -> _p3_sed_columns: the maximum, the count and
    all ten outputs bit for bit; at DT_ONE one sub-step (the step's outputs
    kept as they are), at DT_MANY several."""
    a, k = _sed_args(seed, dtype, tier, pnc)
    q, (rho, temp, dz), dtab = a[:8], a[8:11], a[12]
    vmax, one = PP._p3_sed_step(*q, rho, temp, dz, dt, dtab, pnc)
    n_new = _count(dt, vmax, dz)
    got = PP._p3_sed_columns(*q, rho, temp, dz, dt, n_new, dtab, pnc,
                             rerun=one)
    vmax_old = PP._p3_sed_vmax(*q, rho, temp, dtab)
    n_old = _count(dt, vmax_old, dz)
    want = PP._p3_sed_columns(*q, rho, temp, dz, dt, n_old, dtab, pnc)
    assert torch.equal(vmax, vmax_old) and torch.equal(n_new, n_old)
    assert (int(n_new) == 1) == (dt == DT_ONE), int(n_new)
    if dt == DT_ONE:
        assert all(g is o for g, o in zip(got, one))
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, int(n_new))
    assert float(vmax) > 0.0


@pytest.mark.parametrize("diagnostics", [False, True])
@pytest.mark.parametrize("dt", [DT_ONE, DT_MANY])
def test_scheme_through_step_and_rerun_equals_the_former_pair(dt,
                                                              diagnostics):
    """The whole f64 P3 scheme on the mixed regimes, table tier: the
    outputs through sed_step + rerun equal those through the former pair
    (sed_step's maximum alone, sed_columns from the inputs) bit for bit."""
    got = _scheme("seed_mixed_regimes", "float64", dt, "tables", False,
                  diagnostics=diagnostics)
    step, columns = SED.sed_step, SED.sed_columns

    def vmax_only(*a, **k):
        return SED.vmax_plain(*a[:10], a[12], z_axis=k["z_axis"]), None

    def from_inputs(*a, rerun=None, **k):
        return columns(*a, **k)
    SED.sed_step, SED.sed_columns = vmax_only, from_inputs
    try:
        want = _scheme("seed_mixed_regimes", "float64", dt, "tables", False,
                       diagnostics=diagnostics)
    finally:
        SED.sed_step, SED.sed_columns = step, columns
    assert len(got) == len(want) == (13 if diagnostics else 12)
    for g, w in zip(got[:12], want[:12]):
        assert torch.equal(g, w)
    if diagnostics:
        assert got[12].keys() == want[12].keys()
        for name in got[12]:
            assert torch.equal(got[12][name], want[12][name]), name


def test_rerun_wrapper_on_the_cpu():
    """Given CPU tensors sed_step and sed_columns(rerun=...) run their plain
    versions and count no launch; the rerun at a count of 1 hands back
    sed_step's tensors, at 3 the whole sub-cycle."""
    a, _ = _sed_args("seed_layers", "float64", "tables", True)
    q, (rho, temp, dz), dtab = a[:8], a[8:11], a[12]
    before = (counter("sed_step.launches"), counter("sed_columns.launches"))
    vmax, one = SED.sed_step(*q, rho, temp, dz, 60.0, dtab,
                             do_predict_nc=True)
    for n, same in ((1.0, True), (3.0, False)):
        nsub = torch.tensor(n, dtype=torch.float64)
        got = SED.sed_columns(*q, rho, temp, dz, 60.0, nsub, dtab,
                              do_predict_nc=True, rerun=one)
        want = SED.columns_plain(*q, rho, temp, dz, 60.0, nsub, dtab, True)
        assert all((g is o) == same for g, o in zip(got, one))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (counter("sed_step.launches"), counter("sed_columns.launches")) == before

"""The P3 scheme's rates and sedimentation phases of the port against the
JAX package, on the CPU.

On a CUDA device ``p3_scheme`` runs its table-tier rates as two per-cell
kernels around the table lookups (``p3_cellwise_cuda.p3_rates_pre`` /
``p3_rates_post``) and its sedimentation as two kernels
(``p3_sed_cuda.sed_step``, the speeds once with their maximum and one
sub-step, then ``sed_columns``, which reruns the sub-cycle where the count,
read on the device, is above 1).  Here, on the CPU, the same entry points
run their plain versions, and this file holds them to the JAX scheme:

  * the state after the prognostic update and after sedimentation, against
    JAX's ``p3_scheme(..., profile_stop="update")`` and ``"sed"``, at the
    port's P3 chain bar, rtol 1e-9 plus 1e-7 of each field's scale
    (tests/test_torch_p3.py), for the table and the [approx] tier, with
    predicted and prescribed droplet number, and at a step with one
    sedimentation sub-step and one with at least three;
  * the index sets ``p3_rates_pre`` hands the lookups, against JAX's index
    finders: indices equal, fractions 1e-12 of their scale.

Inputs: the wrapper's outputs on a 16x2x12 f64 supercell with the seeded
hydrometeors of ``supercell_p3.seed_layers``, ``seed_all_active`` and
``seed_mixed_regimes``, handed to both packages as numpy arrays.  JAX runs
its scheme eagerly (a few seconds a call), so each JAX result is computed
once.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.physics import p3 as JP
from miniweatherml_tpu.physics import p3_tables as JT
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW
from miniweatherml_tpu_torch.physics import p3_sed_cuda as SED
from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables
from miniweatherml_tpu_torch.utils.profiling import counter

import chip_smoke as cs

torch.set_num_threads(1)

PROG = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta")
SEDIMENTED = PROG + ("precip_liq", "precip_ice")
RTOL, ATOL_OF_SCALE = 1e-9, 1e-7
# one sedimentation sub-step at dt = 2 s on every seeded state; 4 to 9 at
# 400 s (dt vmax / (0.9 dz_min) from 3.03 to 8.15)
DT_ONE, DT_MANY = 2.0, 400.0


@lru_cache(maxsize=None)
def _inputs(seed):
    """(the 15 wrapper outputs, rho_d) of the seeded state, as numpy."""
    raw = dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=2, nz=12,
               xlen=40000.0, ylen=40000.0, zlen=16000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0, dtype="float64")
    state = supercell_p3.build(config_from_dict(raw), "cpu")[0]
    state = getattr(supercell_p3, seed)(state)
    return (tuple(a.numpy() for a in PP.p3_wrapper_inputs(state)),
            state["density_dry"].numpy())


@lru_cache(maxsize=None)
def _tables(pkg):
    return JT.load_p3_tables() if pkg == "jax" else load_p3_tables()


def _scheme_args(seed, to):
    ins, rho_d = _inputs(seed)
    return ([to(a) for a in ins[:12]] + [to(rho_d), to(ins[12])],
            to(ins[13]), to(ins[14]))


@lru_cache(maxsize=None)
def _jax(seed, dt, tier, pnc, stop):
    args, qv_prev, t_prev = _scheme_args(seed, jnp.asarray)
    out = JP.p3_scheme(*args, dt, tables=_tables("jax") if tier == "tables"
                       else None, qv_prev=qv_prev, t_prev=t_prev,
                       do_predict_nc=pnc, profile_stop=stop)
    return tuple(np.asarray(a) for a in out)


@lru_cache(maxsize=None)
def _port(seed, dt, tier, pnc):
    """The port's p3_scheme, with the state its update hands
    sedimentation, sedimentation's outputs and its sub-step count (and
    dt vmax / (0.9 dz_min)) captured at the wrappers."""
    args, qv_prev, t_prev = _scheme_args(seed, torch.as_tensor)
    seen = {}
    update, step, columns = CW.p3_update, SED.sed_step, SED.sed_columns

    def spy_update(*a, **k):
        seen["update"] = update(*a, **k)
        return seen["update"]

    def spy_step(*a, **k):
        out = step(*a, **k)
        seen["vmax"] = out[0]
        return out

    def spy_columns(*a, **k):
        seen["nsub"] = a[12]
        seen["sed"] = columns(*a, **k)
        return seen["sed"]
    CW.p3_update, SED.sed_step, SED.sed_columns = (spy_update, spy_step,
                                                   spy_columns)
    try:
        PP.p3_scheme(*args, dt, tables=_tables("port") if tier == "tables"
                     else None, qv_prev=qv_prev, t_prev=t_prev,
                     do_predict_nc=pnc)
    finally:
        CW.p3_update, SED.sed_step, SED.sed_columns = update, step, columns
    after_update = tuple(a.numpy() for a in seen["update"])
    after_sed = tuple(a.numpy() for a in seen["sed"][:8]) + after_update[8:] \
        + tuple(a.numpy() for a in seen["sed"][8:])
    ratio = dt * float(seen["vmax"]) / (0.9 * float(args[13].min()))
    return after_update, after_sed, int(seen["nsub"]), ratio


def _assert_close(got, want, names, where):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (where, name)
        scale = max(np.abs(w).max(), 1e-300)
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_OF_SCALE * scale,
                                   err_msg=f"{where}: {name}")


# (tier, do_predict_nc, seeded state): each tier both ways, the three
# states spread over the cases
UPDATE_CASES = [("tables", False, "seed_layers"),
                ("tables", True, "seed_mixed_regimes"),
                ("approx", False, "seed_all_active"),
                ("approx", True, "seed_layers")]


@pytest.mark.parametrize("tier,pnc,seed", UPDATE_CASES)
def test_state_after_update_matches_jax(tier, pnc, seed):
    """part1 -> rates (rates_pre -> lookups -> rates_post at the table
    tier) -> update: the rates show through the update's result (JAX's
    "rates" stop returns only a probe sum)."""
    got = _port(seed, DT_ONE, tier, pnc)[0]
    want = _jax(seed, DT_ONE, tier, pnc, "update")
    _assert_close(got, want, PROG, (tier, pnc, seed))
    assert float(np.max(want[4])) > 0.0  # ice present


# (tier, do_predict_nc, seeded state, dt): one sub-step and several, in
# each tier, with both droplet-number forms
SED_CASES = [("tables", True, "seed_layers", DT_ONE),
             ("tables", False, "seed_all_active", DT_MANY),
             ("approx", False, "seed_mixed_regimes", DT_ONE),
             ("approx", True, "seed_all_active", DT_MANY)]


@pytest.mark.parametrize("tier,pnc,seed,dt", SED_CASES)
def test_state_after_sedimentation_matches_jax(tier, pnc, seed, dt):
    """The sub-cycled fall (sed_step -> nsub -> sed_columns) with its
    write-backs and the surface rates; the sub-step count is the expected
    one and the state does not sit near one of its ceil boundaries."""
    _, got, nsub, ratio = _port(seed, dt, tier, pnc)
    assert nsub == max(int(np.ceil(ratio)), 1)
    assert (nsub == 1) if dt == DT_ONE else (nsub >= 3), (nsub, ratio)
    assert abs(ratio - round(ratio)) > 1e-3, ratio
    want = _jax(seed, dt, tier, pnc, "sed")
    _assert_close(got, want, SEDIMENTED, (tier, pnc, seed, dt))
    assert float(np.max(want[10])) > 0.0  # rain reaches the ground


@pytest.mark.parametrize("seed", ["seed_layers", "seed_all_active",
                                  "seed_mixed_regimes"])
def test_rates_pre_index_sets_match_jax(seed):
    """The index sets and re-bounds p3_rates_pre hands the lookups, from
    part1's outputs, against JAX's calc_bulkRhoRime and index finders on
    the same inputs; the presence flags against the fields."""
    ins, rho_d = _inputs(seed)
    rho = rho_d * (1.0 + ins[8] + ins[0] + ins[2] + ins[4])
    p1 = [a.numpy() for a in CW.p3_part1(
        *(torch.as_tensor(a) for a in (*ins[:12], rho)),
        do_predict_nc=False)]
    qi, qr, qm, bm = p1[4], p1[2], p1[6], p1[7]
    qi_in, qr_in = p1[14], p1[13]
    qm_in, bm_in, nr_in, ni_in = p1[15], p1[16], p1[18], p1[19]
    got = CW.p3_rates_pre(*(torch.as_tensor(a) for a in (
        qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in, nr_in)))
    _assert_rates_pre_matches_jax(
        got, (qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in, nr_in))
    has_qi, has_qr = qi >= PP.QSMALL, qr >= PP.QSMALL
    assert got[-1].tolist() == [bool(has_qi.any()),
                                bool((has_qi & has_qr).any()),
                                bool(has_qr.any())]


def _assert_rates_pre_matches_jax(got, fields):
    """p3_rates_pre's outputs ``got`` against JAX's calc_bulkRhoRime and
    index finders on the same inputs (numpy ``fields``): indices equal,
    fields and fractions within 1e-12 of their scale."""
    qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in, nr_in = fields
    j = jnp.asarray
    qm_reb, bm_reb, rr = JP._bulk_rho_rime(j(qi_in), j(qm_in), j(bm_in))
    has_qi = qi >= PP.QSMALL
    lamr = jnp.cbrt(np.pi / 6.0 * PP.RHO_H2O * 24.0
                   * jnp.maximum(j(nr_in), PP.NSMALL)
                   / jnp.maximum(j(qr_in), PP.QSMALL))
    want = (np.where(has_qi, qm_reb, qm), np.where(has_qi, bm_reb, bm),
            *JT.ice_table_indices(j(qi_in), jnp.maximum(j(ni_in), PP.NSMALL),
                                  qm_reb, rr),
            *JT.rain_collection_index(j(qr_in),
                                      jnp.maximum(j(nr_in), PP.NSMALL)),
            *JT.rain_size_index((JT.MU_R + 1.0) / lamr))
    assert len(got) == len(want) + 1
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"out {i}")
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * max(
                np.abs(w).max(), 1.0), err_msg=f"out {i}")


@pytest.mark.parametrize("kind,at", cs.RATES_PRE_FLAG_CASES)
def test_rates_pre_flags_match_jax_gates(kind, at):
    """p3_rates_pre's presence flags on 963 f64 cells in which no cell, or
    exactly one (the first, the middle or the last), holds ice, rain or
    both, against the JAX scheme's lookup gates on the same inputs (the
    jnp.any of each lax.cond in its table tier); its re-bounds and index
    sets against JAX's index finders.  This is what the kernel's per-block
    reduction of the flags must give (tests/test_torch_cuda.py runs the
    same cases through it)."""
    fields = cs._rates_pre_flag_fields(kind, at, torch.float64, "cpu")
    got = CW.p3_rates_pre(*fields)
    arrays = [f.numpy() for f in fields]
    _assert_rates_pre_matches_jax(got, arrays)
    qi, qr = jnp.asarray(arrays[0]), jnp.asarray(arrays[1])
    gates = [jnp.any(qi >= JP.QSMALL),
             jnp.any((qi >= JP.QSMALL) & (qr >= JP.QSMALL)),
             jnp.any(qr >= JP.QSMALL)]
    assert got[-1].tolist() == [bool(g) for g in gates]
    assert got[-1].tolist() == ["ice" in kind, kind == "ice and rain",
                                "rain" in kind]


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """Given CPU tensors the four new wrappers run their plain versions and
    count no launch; a scheme step launches nothing either."""
    counters = ("p3_rates_pre.launches", "p3_rates_post.launches",
                "sed_step.launches", "sed_columns.launches")
    before = [counter(c) for c in counters]
    _port.cache_clear()
    _port("seed_all_active", DT_MANY, "tables", False)
    assert [counter(c) for c in counters] == before
    ins, rho_d = _inputs("seed_layers")
    args = [torch.as_tensor(a) for a in ins]
    rho = torch.as_tensor(rho_d) * 1.01
    dtab = _tables("port").to("cpu", torch.float64)
    vmax, one = SED.sed_step(*args[:8], rho, args[10], args[12], 60.0,
                             dtab, do_predict_nc=True)
    assert torch.equal(vmax, SED.vmax_plain(*args[:8], rho, args[10], dtab))
    for a, b in zip(one, SED.step_plain(*args[:8], rho, args[10], args[12],
                                        60.0, dtab, True)[1]):
        assert torch.equal(a, b)
    nsub = torch.tensor(3.0, dtype=torch.float64)
    for a, b in zip(SED.sed_columns(*args[:8], rho, args[10], args[12], 60.0,
                                    nsub, dtab, do_predict_nc=True),
                    SED.columns_plain(*args[:8], rho, args[10], args[12],
                                      60.0, nsub, dtab, True)):
        assert torch.equal(a, b)
    assert [counter(c) for c in counters] == before
    assert CW.plain_phase("rates_pre", False, args[:10])[0].shape == \
        args[0].shape

"""The port's P3 microphysics against the JAX package's, on the CPU.

Inputs are made once with numpy (or by the JAX package's own seeded state
functions) and handed to both packages.  Tolerances, f64 unless stated:
  * saturation functions 1e-13 relative, compute_adjusted_state (guarded
    Newton and 60-halving bisection) 1e-12;
  * each per-cell phase (part1, update, wrapper inputs; the kernels' plain
    versions) 1e-12 of each output's scale;
  * p3_scheme at the table tier and the [approx] tier, with diagnostics and
    predicted droplet number, rtol 1e-9 plus 1e-9 of scale (the JAX suite's
    oracle bar), and against tests/oracle_p3.py on its six canned columns
    as tests/test_p3_oracle.py holds the JAX scheme;
  * MicrophysicsP3.time_step 1e-12 of scale in f64; in f32 2e-4 of scale,
    the JAX suite's bound for the collect lookup (tests/test_p3_tables.py),
    because under x64 JAX's lookups run in f64 and the port's in f32;
  * the 2-step supercell_p3 chain with seeded hydrometeor layers, rtol 1e-9
    plus 1e-7 of scale (WENO weight switching, see test_torch_dycore.py).
The JAX references are computed once per module (JAX runs them eagerly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments.supercell_p3 import build as jax_build
from miniweatherml_tpu.physics import p3 as JP
from miniweatherml_tpu.physics.p3_tables import load_p3_tables as jax_tables
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.core.coupler import state_to_numpy
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.experiments.community_benchmark import \
    run_benchmark
from miniweatherml_tpu_torch.ops.exact_div import exact_div
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW
from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables
from tests import oracle_p3 as O
from tests.test_p3 import _seeded_mixed_state
from tests.test_p3_oracle import NZ_FULL, _column_profile
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, to_port)

import chip_smoke as cs

torch.set_num_threads(1)

SCHEME_OUT = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta",
              "precip_liq", "precip_ice")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close_of_scale(got, want, tol, name="", rtol=0.0):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=tol * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def ptab():
    return load_p3_tables()


@pytest.fixture(scope="module")
def mixed64():
    """The JAX suite's seeded mixed-regime state (f64) with a partial
    qv_prev/t_prev history, and the scheme inputs both packages derive
    from it."""
    st, micro = _seeded_mixed_state("float64")
    rng = np.random.default_rng(11)
    temp = np.asarray(st["temp"])
    hist = rng.random(temp.shape) < 0.5
    st = st.replace_fields(
        t_prev=jnp.asarray(np.where(hist, temp - 0.3, 0.0)),
        qv_prev=jnp.asarray(np.where(hist, 0.9 * np.asarray(
            st["water_vapor"]) / np.asarray(st["density_dry"]), 0.0)))
    return st, micro


def test_saturation_functions_match_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(180.0, 330.0, 5000)
    p = rng.uniform(1.0e4, 1.05e5, 5000)
    for name in ("saturation_vapor_pressure", "saturation_vapor_pressure_ice",
                 "_murphy_koop_svp_liq", "_murphy_koop_svp_ice",
                 "latent_heat_condensation"):
        np.testing.assert_allclose(getattr(PP, name)(_t(t)).numpy(),
                                   getattr(JP, name)(jnp.asarray(t)),
                                   rtol=1e-13, err_msg=name)
    for name in ("p3_qv_sat_liq", "p3_qv_sat_ice"):
        np.testing.assert_allclose(
            getattr(PP, name)(_t(t), _t(p)).numpy(),
            getattr(JP, name)(jnp.asarray(t), jnp.asarray(p)), rtol=1e-13,
            err_msg=name)


@pytest.mark.parametrize("iters", [None, 60])
def test_compute_adjusted_state_matches_jax(iters):
    """Both solver forms, over condensing / evaporating / inactive cells
    (the recipe of tests/test_p3.py's Newton-vs-bisection test)."""
    args = _recipe_inputs()
    want = JP.compute_adjusted_state(*(jnp.asarray(a) for a in args),
                                     iters=iters)
    got = PP.compute_adjusted_state(*(_t(a) for a in args), iters=iters)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(w)).max())


def _wrapper_args(st):
    names = [t[0] for t in JP.MicrophysicsP3.TRACERS]
    return [np.asarray(st[k]) for k in
            ["density_dry", "temp", *names, "qv_prev", "t_prev"]]


def _update_args(n=6000, seed=5):
    """Random inputs of the update phase: sparse process rates spanning
    several decades, a mixed state, 0/1 wet-growth and level-skip masks."""
    rng = np.random.default_rng(seed)

    def rate(lo, hi):
        return np.where(rng.random(n) < 0.6, 10.0 ** rng.uniform(lo, hi, n),
                        0.0)
    rates = [rate(-9, -3) for _ in range(21)]
    rates[3], rates[5], rates[15] = (rate(2, 7) for _ in range(3))  # numbers
    rates[17], rates[18], rates[19] = (rate(1, 5) for _ in range(3))
    rates[8], rates[20] = rate(0, 4), rate(0, 4)
    rho_rime = rng.uniform(50.0, 900.0, n)
    wg = (rng.random(n) < 0.2).astype(float)
    q = [np.where(rng.random(n) < 0.7, 10.0 ** rng.uniform(-8, -2.2, n), 0.0)
         for _ in range(6)]   # qc_in nc_in qr_in nr_in qi_in ni_rate
    q[1] *= 1e10
    q[3] *= 1e8
    q[5] *= 1e8
    st = [np.where(rng.random(n) < 0.7, 10.0 ** rng.uniform(-9, -2.5, n),
                   0.0) for _ in range(9)]  # qc nc qr nr qi ni qm bm qv
    st[1] *= 1e10
    st[3] *= 1e8
    st[5] *= 1e8
    st[7] *= 1e-3
    st[8] = rng.uniform(1e-4, 2e-2, n)
    theta = rng.uniform(290.0, 360.0, n)
    exner = rng.uniform(0.6, 1.0, n)
    inv_rho = 1.0 / rng.uniform(0.3, 1.3, n)
    temp = theta * exner
    qv_si = rng.uniform(1e-5, 2e-2, n)
    pres = rng.uniform(2e4, 1.05e5, n)
    skip = (rng.random(n) < 0.1).astype(float)
    return [*rates, rho_rime, wg, *q, *st, theta, exner, inv_rho, temp,
            qv_si, pres, skip]


@pytest.mark.parametrize("phase,pnc", [("wrapper", False), ("part1", False),
                                       ("part1", True), ("update", False),
                                       ("update", True)])
def test_cellwise_phase_matches_jax(phase, pnc, mixed64):
    """Each per-cell phase (the plain version the CUDA kernel is held to)
    against the JAX function of the same name."""
    st, _ = mixed64
    if phase == "wrapper":
        args = _wrapper_args(st)
        want = JP._p3_wrapper_inputs_cellwise(*(jnp.asarray(a)
                                                for a in args))
        got = CW.p3_wrapper(*(_t(a) for a in args))
    elif phase == "part1":
        w = [np.asarray(a) for a in
             JP._p3_wrapper_inputs_cellwise(*(jnp.asarray(a)
                                              for a in _wrapper_args(st)))]
        rho = np.asarray(st["density_dry"]) * (1.0 + w[8] + w[0] + w[2]
                                               + w[4])
        args = [*w[:12], rho]
        want = JP._p3_part1_cellwise(*(jnp.asarray(a) for a in args),
                                     do_predict_nc=pnc)
        got = CW.p3_part1(*(_t(a) for a in args), do_predict_nc=pnc)
    else:
        args = _update_args()
        want = JP._p3_update_cellwise(jnp.asarray(2.0),
                                      *(jnp.asarray(a) for a in args),
                                      do_predict_nc=pnc)
        got = CW.p3_update(2.0, *(_t(a) for a in args), do_predict_nc=pnc)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_of_scale(g, w, 1e-12, f"{phase} output {i}")


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _newton_model(rho, rho_d, rho_v, rho_c, temp):
    """The wrapper kernel's control flow of the saturation adjustment
    (csrc/p3_cellwise.cu adjust_state, saturation_newton) in torch, on the
    plain version's arithmetic: the Newton only in cells that condense or
    evaporate and whose boundary root does not hold, and each cell's trips
    ended by a ``done`` mask after the first trip that leaves x with the
    bits it had.  Returns (rho_v, rho_c, temp, trips per cell)."""
    svp = PP.saturation_vapor_pressure(temp)
    pv = rho_v * PP.R_V * temp
    condensing = pv > svp
    evaporating = (pv < svp) & (rho_c > 0.0)
    lv = PP.latent_heat_condensation(temp)
    rho_t = rho_d + rho_v + rho_c
    cp0 = (rho_d * PP.CP_D + rho_v * PP.CP_V + rho_c * PP.CP_L) / rho_t
    dcp = exact_div(PP.CP_L - PP.CP_V, rho_t)
    cp_lo = cp0 - rho_c * dcp
    t_lo = temp - rho_c * lv / (rho * cp_lo)
    boundary = evaporating & ((rho_v + rho_c) * PP.R_V * t_lo
                              - PP.saturation_vapor_pressure(t_lo) <= 0.0)
    newton = (condensing | evaporating) & ~boundary
    lo = torch.where(condensing, 0.0, -rho_c)
    hi = torch.where(condensing, rho_v, 0.0)
    dtdx0 = lv / (rho * cp0)
    fp0 = (-PP.R_V * temp + rho_v * PP.R_V * dtdx0
           - PP._magnus_dsvp_dT(svp, temp) * dtdx0)
    x1 = -(pv - svp) / PP._min(fp0, -1e-30)
    x = torch.where((fp0 < 0.0) & (x1 >= lo) & (x1 <= hi), x1,
                    0.5 * (lo + hi))
    xb, fb = x, torch.full_like(x, float("inf"))
    done = ~newton
    trips = torch.zeros(x.shape, dtype=torch.int64)
    for _ in range(11 if x.dtype == torch.float64 else 8):
        live = ~done
        rv = rho_v - x
        cp = cp0 + x * dcp
        dtdx_lin = lv / (rho * cp)
        t_loc = temp + x * dtdx_lin
        svp_loc = PP.saturation_vapor_pressure(t_loc)
        f = rv * PP.R_V * t_loc - svp_loc
        better = live & (f.abs() < fb)
        xb = torch.where(better, x, xb)
        fb = torch.where(better, f.abs(), fb)
        lo = torch.where(live & (f > 0.0), x, lo)
        hi = torch.where(live & ~(f > 0.0), x, hi)
        dtdx = dtdx_lin * (1.0 - x * dcp / cp)
        fp = (-PP.R_V * t_loc + rv * PP.R_V * dtdx
              - PP._magnus_dsvp_dT(svp_loc, t_loc) * dtdx)
        xn = x - f / fp
        nxt = torch.where((xn >= lo) & (xn <= hi), xn, 0.5 * (lo + hi))
        trips += live.long()
        done = done | (live & (_bits(nxt) == _bits(x)))
        x = torch.where(live, nxt, x)
    x = torch.where(boundary, -rho_c, torch.where(newton, xb, 0.0))
    rv = PP._max(rho_v - x, 0.0)
    rc = PP._max(rho_c + x, 0.0)
    cp = PP._cp_moist(rho_d, rv, rc)
    return rv, rc, temp + x * lv / (rho * cp), trips


def _recipe_inputs():
    """(rho, rho_d, rho_v, rho_c, temp) of 8192 condensing, evaporating and
    inactive cells (the recipe of tests/test_p3.py's Newton-vs-bisection
    test)."""
    rng = np.random.default_rng(17)
    n = 8192
    rho_d = 0.3 + 1.0 * rng.random(n)
    rho_v = 0.03 * rng.random(n)
    rho_c = np.where(rng.random(n) < 0.5, 0.01 * rng.random(n), 0.0)
    temp = 200.0 + 120.0 * rng.random(n)
    return rho_d + rho_v + rho_c, rho_d, rho_v, rho_c, temp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cells", ["recipe", "mixed64"])
def test_newton_early_end_matches_compute_adjusted_state(cells, dtype,
                                                         mixed64):
    """The kernel's Newton control flow (_newton_model: skipped where its
    result is thrown away, each cell's loop ended at repeated bits) equals
    the fixed-trip compute_adjusted_state bit for bit, on the 8192-cell
    recipe and on the seeded mixed-regime state, f32 and f64; some cells
    skip the Newton, some end it early and some run every trip; and
    chip_smoke's trip count (the phase 31 histogram) is the model's."""
    if cells == "recipe":  # as the wrapper's inputs, without hydrometeors
        _, rho_d, rho_v, rho_c, temp = (torch.as_tensor(a, dtype=dtype)
                                        for a in _recipe_inputs())
        zero = torch.zeros_like(temp)
        wargs = [rho_d, temp, rho_c, *[zero] * 7, rho_v, zero, zero]
    else:
        wargs = [torch.as_tensor(np.array(a), dtype=dtype)
                 for a in _wrapper_args(mixed64[0])]
    rho_d, temp, rho_c, rho_v = wargs[0], wargs[1], wargs[2], wargs[10]
    rho = rho_d + rho_c + wargs[4] + wargs[6] + rho_v  # the wrapper's rho
    want = PP.compute_adjusted_state(rho, rho_d, rho_v, rho_c, temp)
    *got, trips = _newton_model(rho, rho_d, rho_v, rho_c, temp)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), (cells, dtype)
    full = 11 if dtype == torch.float64 else 8
    assert int((trips == 0).sum()) > 0
    assert int(((trips > 0) & (trips < full)).sum()) > 0
    assert int((trips == full).sum()) > 0
    assert torch.equal(cs._newton_trips(wargs), trips)


# RatesPost's gated groups (chip_smoke._rates_post_gates) and what the
# kernel writes where a gate fails: output index -> value (None: +0)
RP_SKIP = {"autoconversion": {0: None}, "accretion": {1: None},
           "rain_size": {18: None}, "nucleation": {14: None, 15: None},
           "bigg_cloud": {2: None, 3: None}, "bigg_rain": {4: None, 5: None},
           "ice": {**{k: None for k in (6, 7, 8, 9, 13, 16, 17, 19, 20, 22)},
                   21: 400.0, 23: "ni_in"},
           "rime": {21: 400.0}, "evaporation": {12: None},
           "ice and rain": {16: None, 17: None},
           "ice and rain at or below 0 C": {16: None}}


@pytest.mark.parametrize("gate", list(RP_SKIP))
def test_rates_post_gates_give_the_skip_constants(gate):
    """Where a RatesPost gate fails, the plain version gives exactly the
    value the kernel's skip path writes there (+0 with its sign, rho_rime
    400, ni_rate = ni_in), f32 and f64, on cells of every regime of
    chip_smoke._rates_post_fields; each gate holds in some cells and fails
    in others."""
    rng = np.random.default_rng(23)
    regimes = list(rng.choice(list(cs.RP_REGIMES), 4096))
    for dtype in (torch.float64, torch.float32):
        fields = cs._rates_post_fields(regimes, dtype, "cpu")
        off = ~cs._rates_post_gates(fields)[gate]
        assert 0 < int(off.sum()) < off.numel(), (gate, dtype)
        out = CW.rates_post_plain(2.0, *fields)
        for k, value in RP_SKIP[gate].items():
            if value is None:
                want = torch.zeros_like(out[k])
            elif value == "ni_in":
                want = fields[16]
            else:
                want = torch.full_like(out[k], value)
            assert torch.equal(_bits(out[k][off]), _bits(want[off])), (
                gate, dtype, k)


def _scheme_inputs(st):
    """(wrapper outputs, rho_d, dz) of the JAX state, as numpy."""
    out = [np.asarray(a) for a in JP.p3_wrapper_inputs(st)]
    return out, np.asarray(st["density_dry"])


@pytest.mark.parametrize("tier", ["tables", "approx"])
def test_scheme_matches_jax(tier, mixed64, ptab):
    """p3_scheme on the mixed state with diagnostics and predicted
    droplet number (the update kernel's and part3's optional branches)."""
    st, _ = mixed64
    (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, dz, qv_prev,
     t_prev), rho_d = _scheme_inputs(st)
    args = (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, rho_d,
            dz)
    kw = dict(qv_prev=qv_prev, t_prev=t_prev, do_predict_nc=True,
              diagnostics=True)
    want = JP.p3_scheme(*(jnp.asarray(a) for a in args), 2.0,
                        tables=jax_tables() if tier == "tables" else None,
                        **{k: (jnp.asarray(v) if k in ("qv_prev", "t_prev")
                               else v) for k, v in kw.items()})
    got = PP.p3_scheme(*(_t(a) for a in args), 2.0,
                       tables=ptab if tier == "tables" else None,
                       **{k: (_t(v) if k in ("qv_prev", "t_prev") else v)
                          for k, v in kw.items()})
    assert len(got) == len(want) == 13
    for name, g, w in zip(SCHEME_OUT, got, want):
        _close_of_scale(g, w, 1e-9, name, rtol=1e-9)
    assert set(got[12]) == set(want[12]) == set(PP.MicrophysicsP3.DIAG_FIELDS)
    for name in want[12]:
        _close_of_scale(got[12][name], want[12][name], 1e-9, name, rtol=1e-9)
    assert float(np.asarray(want[4]).max()) > 0.0  # ice present


@pytest.mark.parametrize("kind", ["warm", "cold", "mixed", "wetgrowth",
                                  "capped", "clearsky"])
def test_scheme_matches_oracle(kind, ptab):
    """One p3_main step on the oracle suite's canned columns against the
    NumPy transliteration (tests/oracle_p3.py), as tests/test_p3_oracle.py
    holds the JAX scheme: rtol 1e-9, atol 1e-9 of each field's scale."""
    c = _column_profile(kind)
    shape = (1, NZ_FULL, 1, 1)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float64)).reshape(shape)
    theta = c["temp"] / c["exner"]
    qv_prev, t_prev = 0.98 * c["qv"], c["temp"] - 0.1
    dz = np.full(NZ_FULL, 500.0)
    out = PP.p3_scheme(
        qc=col(c["qc"]), nc=col(np.zeros(NZ_FULL)), qr=col(c["qr"]),
        nr=col(c["nr"]), qi=col(c["qi"]), ni=col(c["ni"]), qm=col(c["qm"]),
        bm=col(c["bm"]), qv=col(c["qv"]), theta=col(theta),
        exner=col(c["exner"]), pres=col(c["pres"]), rho_d=col(c["rho_d"]),
        dz=col(dz), dt=10.0, tables=ptab, qv_prev=col(qv_prev),
        t_prev=col(t_prev))
    ora = O.p3_main_step(ptab, c["qc"], np.zeros(NZ_FULL), c["qr"], c["nr"],
                         c["qi"], c["ni"], c["qm"], c["bm"], c["qv"], theta,
                         c["exner"], c["pres"], c["rho_d"], dz, 10.0,
                         qv_prev=qv_prev, t_prev=t_prev)
    scales = dict(qc=1e-3, nc=1e8, qr=1e-3, nr=1e5, qi=1e-3, ni=1e5,
                  qm=1e-3, bm=1e-6, qv=1e-2, theta=300.0)
    for i, name in enumerate(SCHEME_OUT[:10]):
        np.testing.assert_allclose(out[i].numpy().reshape(NZ_FULL), ora[i],
                                   rtol=1e-9, atol=1e-9 * scales[name],
                                   err_msg=f"{kind}: {name}")
    for i in (10, 11):
        assert float(out[i]) == pytest.approx(ora[i], rel=1e-9, abs=1e-18)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 2e-4)])
def test_time_step_matches_jax(dtype, tol):
    """MicrophysicsP3.time_step on the seeded mixed state, every field."""
    st, jmicro = _seeded_mixed_state(dtype)
    want = jmicro.time_step(st, 2.0)
    got = PP.MicrophysicsP3().time_step(to_port(st), 2.0)
    for name in sorted(st.fields):
        g = got[name]
        assert g.dtype == (torch.float32 if dtype == "float32"
                           else torch.float64), name
        _close_of_scale(g.double(), np.asarray(want[name], np.float64), tol,
                        name, rtol=tol)


@pytest.fixture(scope="module")
def chain_states():
    """Both packages' supercell_p3 chains at 16x2x12 f64 after 2 steps,
    seeded with the smooth layers of ``supercell_p3.seed_layers`` (warm
    rain, mixed phase, rimed ice aloft; white noise would make the WENO/FCT
    dycore switch stencils everywhere, which turns its last-bit differences
    into larger ones than the bound)."""
    raw = dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=2, nz=12,
               xlen=40000.0, ylen=40000.0, zlen=16000.0, init_data="supercell",
               out_prefix="t", dt_phys=0.0, out_freq=-1.0, dtype="float64")
    js, jmods, jd = jax_build(jax_config(raw))
    _, pmods, pd = supercell_p3.build(config_from_dict(raw), "cpu")
    ps = supercell_p3.seed_layers(to_port(js))
    js = js.replace_fields(**{t[0]: jnp.asarray(ps[t[0]].numpy())
                              for t in JP.MicrophysicsP3.TRACERS[:8]})
    dt = jd.compute_time_step(js)
    assert pd.compute_time_step(ps) == dt
    for _ in range(2):
        for m in jmods:
            js = m(js, dt)
        for m in pmods:
            ps = m(ps, dt)
    return js, ps


def test_seed_mixed_regimes_is_the_jax_recipe():
    """chip_smoke.py's mixed-regime state is the JAX suite's, bit for bit."""
    from miniweatherml_tpu_torch.core.coupler import make_coupler_state
    from miniweatherml_tpu_torch.dycore.euler import Dycore

    st, _ = _seeded_mixed_state("float64")
    ps = Dycore().init(PP.MicrophysicsP3().init(make_coupler_state(
        to_port(st).grid, dtype="float64",
        options={"init_data": "supercell", "out_freq": -1.0},
        device="cpu")))
    ps = supercell_p3.seed_mixed_regimes(ps)
    for name in st.fields:
        np.testing.assert_allclose(ps[name].numpy(), np.asarray(st[name]),
                                   rtol=1e-13, atol=0, err_msg=name)


def test_chain_two_steps_matches_jax(chain_states):
    js, ps = chain_states
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)
    assert ps.validate() == {}
    assert float(ps["ice"].max()) > 0 and float(ps["precl"].max()) > 0


def test_chain_tracers_and_options(chain_states):
    js, ps = chain_states
    assert ps.meta.tracer_names == js.meta.tracer_names
    assert ps.meta.idWV == 8
    assert dict(ps.options) == dict(js.options)


def test_module_options_and_diagnostics_init():
    from miniweatherml_tpu_torch.core.coupler import make_coupler_state

    st, _ = _seeded_mixed_state("float64")
    micro = PP.MicrophysicsP3(diagnostics=True)
    g = st.grid
    fresh = micro.init(make_coupler_state(to_port(st).grid, dtype="float64",
                                          device="cpu"))
    assert fresh.meta.tracer_names == tuple(t[0] for t in micro.TRACERS)
    assert float(fresh["equiv_reflectivity"].max()) == -99.0
    assert float(fresh["eff_radius_qc"].min()) == 10.0e-6
    assert tuple(fresh["precl_ice"].shape) == (g.nens, g.ny, g.nx)
    assert fresh.options["micro"] == "p3"
    out = micro.time_step(to_port(st), 2.0)
    dbz = out["equiv_reflectivity"]
    assert torch.isfinite(dbz).all() and float(dbz.min()) >= -99.0
    assert float(dbz.max()) > 0.0
    assert float(out["eff_radius_qc"].min()) > 0.0


def test_backends():
    assert PP.MicrophysicsP3(backend="jax").tables is not None
    native = PP.MicrophysicsP3(backend="native")
    assert native.backend == "native" and native.tables is None
    with pytest.raises(ValueError, match="diagnostics"):
        PP.MicrophysicsP3(backend="native", diagnostics=True)
    with pytest.raises(ValueError):
        PP.MicrophysicsP3(backend="fortran")
    assert PP.MicrophysicsP3(use_tables=False).tables is None


def test_run_with_diagnostics_writes_netcdf(tmp_path, capsys):
    from scipy.io import netcdf_file

    prefix = str(tmp_path / "p3")
    cfg = config_from_dict(dict(
        sim_time=4.0, nx_glob=24, ny_glob=1, nz=12, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell", out_freq=2.0,
        out_prefix=prefix, dtype="float32", p3_diagnostics=True))
    state = supercell_p3.run(cfg, "cpu")
    beats = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Etime , dtphys, maxw:")]
    assert len(beats) == 2 and state.validate() == {}
    with netcdf_file(prefix + ".nc", "r", mmap=False) as nc:
        for name in (*PP.MicrophysicsP3.DIAG_FIELDS, "ice", "water_vapor"):
            assert nc.variables[name].shape == (3, 12, 1, 24), name
        np.testing.assert_allclose(nc.variables["equiv_reflectivity"][-1],
                                   state["equiv_reflectivity"][0].numpy())


def _p3_yaml(tmp_path, backend, out=""):
    path = tmp_path / f"p3_{backend}.yaml"
    path.write_text("sim_time: 2.0\nnx_glob: 12\nny_glob: 2\nnz: 12\n"
                    "xlen: 40000.0\nylen: 40000.0\nzlen: 16000.0\n"
                    "init_data: supercell\n"
                    + (out or "out_freq: -1.0\n")
                    + f"p3_backend: {backend}\n")
    return path


def test_cli_runs_the_native_backend(tmp_path, capsys):
    """supercell_p3.main with ``p3_backend: native`` on the CPU: the
    heartbeat, a valid state and the 9 P3 tracers (the comparison with
    JAX's native chain is tests/test_torch_p3_native.py)."""
    out = f"out_freq: 1.0\nout_prefix: {tmp_path / 'native'}\n"
    state = supercell_p3.main([str(_p3_yaml(tmp_path, "native", out)),
                               "--device", "cpu"])
    beats = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Etime , dtphys, maxw:")]
    assert len(beats) == 2 and state.validate() == {}
    assert (tmp_path / "native.nc").exists()
    assert state.meta.tracer_names == tuple(
        t[0] for t in PP.MicrophysicsP3.TRACERS)


def test_cli_and_benchmark_take_the_p3_chain(tmp_path):
    state = supercell_p3.main([str(_p3_yaml(tmp_path, "jax")), "--device",
                               "cpu"])
    assert "ice_rime_vol" in state.fields and state.validate() == {}
    cfg = config_from_dict(dict(
        sim_time=3.0, nx_glob=12, ny_glob=2, nz=12, xlen=40000.0,
        ylen=40000.0, zlen=16000.0, init_data="supercell", dtype="float32"))
    state, res = run_benchmark(cfg, "cpu", quiet=True,
                               build=supercell_p3.build)
    assert res["steps"] == int(np.ceil(3.0 / (0.6 * cfg.grid.dz / 430.0)))
    assert state.meta.num_tracers == 9 and state.validate() == {}
    assert set(state_to_numpy(state)) == set(state.fields)

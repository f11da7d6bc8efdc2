"""The microphysics tails that run as kernels on the card, on the CPU: the
Kessler sub-cycle step (``kessler_cuda.min_step``), P3's homogeneous
freezing with part3 and its output pass (``p3_cellwise_cuda.p3_part3`` /
``p3_wrapper_out``), and the MLP surrogate's forward pass
(``kessler_surrogate_cuda.surrogate_forward``).  Given CPU tensors each
wrapper runs its plain version, and this file holds those:

  * to the JAX package: the sub-cycle count equal to JAX's
    ``kessler_rainsplit`` as an integer (a dry state, count 1, and
    heavy-rain columns, counts 3-5; one member and an ensemble of 2); freezing + part3 fed JAX's state after
    ``p3_scheme(..., profile_stop="sed")`` against JAX's whole
    ``p3_scheme``, and ``MicrophysicsP3.time_step``, at the port's P3 bar,
    rtol 1e-9 plus 1e-7 of each field's scale (tests/test_torch_p3_phases.py),
    both tiers, ``do_predict_nc`` both ways, on a state without ice, one
    with ice in a single cell and one with cells below -40 C; the surrogate
    against JAX's ``_nn_forward`` at tests/test_torch_surrogate.py's
    tolerances (f64 1e-12 of each output's scale, f32 1e-6 of its scaling
    range), for the shipped 5 -> 10 -> 4 model and a seeded 5 -> 16 -> 16
    -> 4, and one online step of MicrophysicsKesslerSurrogate with a 5 ->
    17 -> 4, a 5 -> 64 -> 64 -> 4 and an 18-layer model (the port takes
    every MLP of 5 inputs and 4 outputs, as JAX does);
  * to the eager code they replace, rebuilt here, bit for bit in f32 and
    f64: the sub-cycle count and the Kessler step made with it, part3 (with
    its diagnostics too) and the output pass.  The surrogate's former eager
    code summed its dot products in ``torch.matmul``, whose order and fused
    multiply-adds the library chooses; the plain version sums in a fixed
    order, so the two agree to the same bounds as against JAX;
  * the per-cell gate of part3's ice limiter lookup (the kernel looks up
    where the cell has ice) against the plain version's gate on any cell
    having ice: equal bit for bit, since part3 zeroes every cell without
    ice whatever the lookup gives.

Inputs are small (16x8x10 and 16x2x12 grids), made with numpy from seeds.
JAX runs its P3 scheme eagerly (about a second a call), so each JAX result
is computed once.
"""

import os
from functools import lru_cache
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments.supercell_p3 import build as jax_build
from miniweatherml_tpu.ml import mlp as JM
from miniweatherml_tpu.physics import p3 as JP
from miniweatherml_tpu.physics import p3_tables as JT
from miniweatherml_tpu.physics.kessler import \
    kessler_rainsplit as jax_rainsplit
from miniweatherml_tpu.physics.kessler_surrogate import \
    MicrophysicsKesslerSurrogate as JSurrogate
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.ml import mlp as TM
from miniweatherml_tpu_torch.physics import kessler_cuda as KC
from miniweatherml_tpu_torch.physics import kessler_surrogate_cuda as SC
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.physics import p3_cellwise_cuda as CW
from miniweatherml_tpu_torch.physics.kessler import MicrophysicsKessler
from miniweatherml_tpu_torch.physics.p3_tables import (
    ice_table_indices, interp_ice_multi, load_p3_tables)
from miniweatherml_tpu_torch.utils.profiling import counter
from tests.test_torch_dycore import to_port

torch.set_num_threads(1)

DTYPES = (torch.float64, torch.float32)
PROG = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta")
RTOL, ATOL_OF_SCALE = 1e-9, 1e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "inputs", "examples")


# -- the Kessler sub-cycle count ---------------------------------------------

def _rain_columns(dtype, dry=False, nens=1, shape=(10, 8, 16), seed=5):
    """(rho_r, rho_d) of moist columns, 200 m levels, as the coupler holds
    them: heavy rain below 3 km and up to 5.5 g/kg everywhere (none when
    ``dry``)."""
    rng = np.random.default_rng(seed)
    nz = shape[0]
    full = (nens, *shape)
    z = ((np.arange(nz) + 0.5) * 200.0)[None, :, None, None]
    rho = 1.2 * np.exp(-z / 8000.0) * np.ones(full)
    qr = 0.0 if dry else (np.where(z < 3000.0, 5e-4, 0.0)
                          + 5e-3 * rng.random(full))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).contiguous()
    return t(qr * rho), t(rho)


def _former_rainsplit(qr, rho, z, dt):
    """The sub-cycle count as the port computed it before the kernel,
    rebuilt from its eager code."""
    nz = qr.shape[1]
    r = 0.001 * rho
    rhalf = torch.sqrt(rho[:, 0:1] / rho)
    velqr = 36.34 * (qr * r) ** 0.1364 * rhalf
    dz_lev = z[:, 1:nz] - z[:, 0:nz - 1]
    vel_lo = velqr[:, 0:nz - 1]
    dt2d = torch.where(vel_lo > 1e-10, 0.8 * dz_lev / vel_lo, dt)
    dt_max = torch.clamp(torch.amin(dt2d), max=dt)
    return dt_max, torch.ceil(dt / dt_max).to(torch.int32)


# (dt, the counts it gives): one sub-step when dry, 3-5 in heavy rain
RAIN_CASES = [(True, 60.0, (1,)), (False, 60.0, (3, 4, 5)),
              (False, 100.0, (3, 4, 5))]


@pytest.mark.parametrize("nens", [1, 2])
@pytest.mark.parametrize("dry,dt,counts", RAIN_CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_kessler_count_matches_jax_and_former(dtype, dry, dt, counts, nens):
    """min_step's plain version and the count made of it, on one member and
    on an ensemble of 2: the count equal to JAX's kessler_rainsplit, the
    step and the count equal bit for bit to the former eager code's, and
    the Kessler time_step equal bit for bit to the former step made with
    that count."""
    rho_r, rho_d = _rain_columns(dtype, dry, nens)
    dz = 200.0
    step = KC.min_step(rho_r, rho_d, dt, dz)
    count = torch.ceil(dt / step).to(torch.int32)
    assert int(count) in counts, int(count)
    zmid = ((torch.arange(rho_d.shape[1], dtype=dtype) + 0.5)
            * dz)[None, :, None, None]
    want_step, want_count = _former_rainsplit(rho_r / rho_d, rho_d, zmid, dt)
    assert torch.equal(step, want_step) and torch.equal(count, want_count)
    jz = jnp.asarray(zmid.numpy())
    j = jax_rainsplit(jnp.asarray((rho_r / rho_d).numpy()),
                      jnp.asarray(rho_d.numpy()), jz, dt)
    assert int(j) == int(count)

    # the whole Kessler time_step against the former count's step
    g = SimpleNamespace(dz=dz, nz=rho_d.shape[1])
    temp = 300.0 - 0.0065 * zmid + 0.0 * rho_d
    rho_v = 0.012 * rho_d
    rho_c = torch.where(zmid < 1500.0, 1e-4, 0.0) * rho_d
    state = _Fields(g, density_dry=rho_d, temp=temp.contiguous(),
                    water_vapor=rho_v, cloud_liquid=rho_c,
                    precip_liquid=rho_r)
    got = MicrophysicsKessler().time_step(state, dt)
    k = MicrophysicsKessler
    want = KC.kessler_step_plain(rho_d, state["temp"], rho_v, rho_c, rho_r,
                                 want_count, dt, dz, k.R_d, k.R_v, k.cp_d,
                                 k.p0)
    for name, w in zip(("water_vapor", "cloud_liquid", "precip_liquid",
                        "temp", "precl"), want):
        assert torch.equal(got[name], w), name


class _Fields:
    """The part of a coupler state that a micro module reads: fields by
    name, the grid and meta, replace_fields."""

    def __init__(self, grid=None, meta=None, **fields):
        self.grid, self.meta, self.fields = grid, meta, fields

    def __getitem__(self, name):
        return self.fields[name]

    def replace_fields(self, **kw):
        return _Fields(self.grid, self.meta, **{**self.fields, **kw})


def test_kessler_rainsplit_keeps_its_form():
    """kessler_rainsplit (any z spacing, used by kessler_column) is the
    former eager count bit for bit."""
    from miniweatherml_tpu_torch.physics.kessler import kessler_rainsplit
    for dtype in DTYPES:
        rho_r, rho_d = _rain_columns(dtype, nens=2)
        z = torch.as_tensor(np.cumsum(np.linspace(150.0, 260.0, 10)),
                            dtype=dtype)[None, :, None, None]
        got = kessler_rainsplit(rho_r / rho_d, rho_d, z, 80.0)
        assert torch.equal(got, _former_rainsplit(rho_r / rho_d, rho_d, z,
                                                  80.0)[1])


# -- P3: freezing + part3, and the output pass --------------------------------

def _p3_raw(zlen, nz):
    return dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=2, nz=nz,
                xlen=40000.0, ylen=40000.0, zlen=zlen, init_data="supercell",
                out_prefix="t", dt_phys=0.0, out_freq=-1.0, dtype="float64")


ICE = ("ice", "ice_num", "ice_rime", "ice_rime_vol")


@lru_cache(maxsize=None)
def _p3_state(case):
    """A seeded 16x2 supercell_p3 state (port, f64, CPU):
      "cold": 16 km deep, cloud, rain and rimed ice in every cell (cells
        below -40 C with cloud and rain, so they freeze);
      "no_ice": 4 km deep (no cell below -1 C, so no ice forms), cloud
        and rain layers, no ice;
      "one_ice": "no_ice" with rimed ice in one cell of the top level."""
    if case == "cold":
        state = supercell_p3.build(config_from_dict(_p3_raw(16000.0, 12)),
                                   "cpu")[0]
        return supercell_p3.seed_all_active(state)
    state = supercell_p3.build(config_from_dict(_p3_raw(4000.0, 10)),
                               "cpu")[0]
    state = supercell_p3.seed_layers(state)
    state = state.replace_fields(**{k: torch.zeros_like(state[k])
                                    for k in ICE})
    if case == "one_ice":
        # the top level, at -0.7 C: the ice neither melts nor nucleates
        # more there
        cell = (0, 9, 1, 9)
        fields = {k: state[k].clone() for k in ICE}
        for k, v in zip(ICE, (1e-4, 1e5, 5e-5, 1e-7)):
            fields[k][cell] = v * float(state["density_dry"][cell])
        state = state.replace_fields(**fields)
    return state


@lru_cache(maxsize=None)
def _scheme_inputs(case):
    """(the 12 scheme fields, rho_d, dz, qv_prev, t_prev) as numpy: the
    port's wrapper outputs on the case's state."""
    state = _p3_state(case)
    ins = [a.numpy() for a in PP.p3_wrapper_inputs(state)]
    return (*ins[:12], state["density_dry"].numpy(), ins[12], ins[13],
            ins[14])


@lru_cache(maxsize=None)
def _tables(pkg):
    return JT.load_p3_tables() if pkg == "jax" else load_p3_tables()


@lru_cache(maxsize=None)
def _jax_scheme(case, tier, pnc, stop):
    a = [jnp.asarray(x) for x in _scheme_inputs(case)]
    out = JP.p3_scheme(*a[:14], 2.0, tables=_tables("jax") if tier ==
                       "tables" else None, qv_prev=a[14], t_prev=a[15],
                       do_predict_nc=pnc, profile_stop=stop)
    return tuple(np.asarray(x) for x in out)


def _part3_inputs(case, tier, pnc, dtype=torch.float64):
    """What the port's scheme hands part3 when fed JAX's state after
    sedimentation: the ten prognostics, part1's temp (from the port's
    part1, which tests/test_torch_p3.py holds to JAX's at 1e-12), exner,
    rho and inv_rho; and the tables."""
    ins = _scheme_inputs(case)
    sed = _jax_scheme(case, tier, pnc, "sed")
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype)
    exner = t(ins[10])
    rho = t(ins[12]) * (1.0 + t(ins[8]) + t(ins[0]) + t(ins[2]) + t(ins[4]))
    temp = CW.part1_plain(*(t(a) for a in ins[:12]), rho,
                          do_predict_nc=pnc)[10]
    args = (*(t(a) for a in sed[:10]), temp, exner, rho, 1.0 / rho)
    dtab = (_tables("port").to("cpu", dtype) if tier == "tables" else None)
    return args, dtab


# (tier, do_predict_nc, state): both tiers, droplet number predicted and
# prescribed (part3 itself does not read the flag; the state it is handed
# does), the three states spread over them.  JAX's table tier runs eagerly
# at ~3-7 s a call, so it takes the case where its gate matters most;
# test_part3_and_output_pass_equal_former_code holds the table tier's gate
# on all three states to the per-cell gate, and tests/test_torch_p3.py its
# whole scheme to JAX's on the mixed-regime state.
PART3_CASES = [("tables", False, "one_ice"), ("approx", True, "cold"),
               ("approx", True, "one_ice"), ("approx", False, "no_ice")]


@pytest.mark.parametrize("tier,pnc,case", PART3_CASES)
def test_part3_matches_jax(tier, pnc, case):
    """Freezing + part3's plain version fed JAX's state after
    sedimentation, against JAX's whole p3_scheme."""
    args, dtab = _part3_inputs(case, tier, pnc)
    got = CW.p3_part3(*args, dtab)
    want = _jax_scheme(case, tier, pnc, None)
    for name, g, w in zip(PROG, got, want):
        scale = max(np.abs(w).max(), 1e-300)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL_OF_SCALE * scale,
                                   err_msg=f"{tier} {pnc} {case}: {name}")
    qc, qi, temp = args[0].numpy(), args[4].numpy(), args[10].numpy()
    if case == "cold":
        assert ((temp < PP.T_HOMOGFRZ) & (qc >= PP.QSMALL)).any()
    else:  # the seeded cell and the one its ice fell into
        assert int((qi >= PP.QSMALL).sum()) == (case == "one_ice") * 2
    assert (want[4] > 0).any() == (case != "no_ice")


def _former_part3(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, exner,
                  rho, inv_rho, dtab, diagnostics):
    """Freezing and part3 as p3_scheme ran them before the kernel, rebuilt
    from its eager code (the ten prognostics, and the per-cell diagnostics
    before the column mask)."""
    from miniweatherml_tpu_torch.physics.p3 import (
        _bulk_rho_rime, _cap_ni, _cloud_dsd2, _max, _rain_dsd2, _where0)
    Lv, Ls, Lf, cp = PP.LATVAP, PP.LATVAP + PP.LATICE, PP.LATICE, PP.CP_D

    def freeze(q, n):
        nonlocal qm, qi, bm, ni, theta
        frz = (q >= PP.QSMALL) & (temp < PP.T_HOMOGFRZ)
        q_nuc = _where0(frz, q)
        qm = qm + q_nuc
        qi = qi + q_nuc
        bm = bm + q_nuc / PP.RHO_RIMEMAX
        ni = ni + _where0(frz, _max(n, PP.NSMALL))
        theta = theta + q_nuc * Lf / (cp * exner)
        return _where0(~frz, q), _where0(~frz, n)

    qc, nc = freeze(qc, nc)
    qr, nr = freeze(qr, nr)
    small_c = qc < PP.QSMALL
    qv = qv + _where0(small_c, qc)
    theta = theta - _where0(small_c, qc) * Lv / (cp * exner)
    nc3, mu_c3, lamc3 = _cloud_dsd2(qc, nc, rho)
    nc = _where0(~small_c, nc3)
    qc = _where0(~small_c, qc)
    eff_qc = torch.where(small_c, 10.0e-6, 0.5 * (mu_c3 + 3.0) / lamc3)
    small_r = qr < PP.QSMALL
    qv = qv + _where0(small_r, qr)
    theta = theta - _where0(small_r, qr) * Lv / (cp * exner)
    nr3, lamr3 = _rain_dsd2(qr, nr)
    nr = _where0(~small_r, nr3)
    qr = _where0(~small_r, qr)
    l2 = lamr3 * lamr3
    ze_rain = torch.where(small_r, 1.0e-22,
                          _max(nr * 5040.0 / (l2 * (l2 * l2)), 1.0e-22))
    small_i = qi < PP.QSMALL
    qv = qv + _where0(small_i, qi)
    theta = theta - _where0(small_i, qi) * Ls / (cp * exner)
    ni = _max(ni, PP.NSMALL)
    qm, bm, _ = _bulk_rho_rime(qi, qm, bm)
    ni = _cap_ni(ni, inv_rho)
    ice_diag = None
    if dtab is not None:
        rhop3 = torch.clamp(qm / _max(bm, 1e-30), PP.RHO_RIMEMIN,
                            PP.RHO_RIMEMAX)
        idx3 = ice_table_indices(qi, ni, qm, rhop3)
        cols3 = (7, 8, 2, 6, 9, 11, 12) if diagnostics else (7, 8)
        vals3 = interp_ice_multi(dtab, cols3, *idx3,
                                 present=(qi >= PP.QSMALL).any())
        ni = torch.minimum(ni, vals3[0] * ni)
        ni = torch.maximum(ni, vals3[1] * ni)
        if diagnostics:
            ice_diag = vals3[2:]
    qi, ni, qm, bm = (_where0(~small_i, a) for a in (qi, ni, qm, bm))
    prog = (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)
    if not diagnostics:
        return prog, None
    if ice_diag is not None:
        t2_3, t6_3, t9_3, t11_3, t12_3 = ice_diag
        rhofaci3 = (PP._RHO_600MB * inv_rho) ** 0.54
        vm_qi = _where0(~small_i, t2_3 * rhofaci3)
        eff_qi = torch.where(small_i, 25.0e-6, t6_3)
        diam_qi = _where0(~small_i, t11_3)
        rho_qi_d = _where0(~small_i, t12_3)
        ze_ice = torch.where(small_i, 1.0e-22,
                             _max(1.0e-22 + 0.1892 * t9_3 * ni * rho,
                                  1.0e-22))
    else:
        vm_qi = torch.zeros_like(qi)
        eff_qi = torch.full_like(qi, 25.0e-6)
        diam_qi = torch.zeros_like(qi)
        rho_qi_d = torch.zeros_like(qi)
        ze_ice = torch.full_like(qi, 1.0e-22)
    dbz = 10.0 * torch.log10((ze_rain + ze_ice) * 1.0e18)
    return prog, dict(eff_radius_qc=eff_qc, eff_radius_qi=eff_qi,
                      diam_qi=diam_qi, rho_qi=rho_qi_d, vm_qi=vm_qi,
                      equiv_reflectivity=dbz)


def _per_cell_gated(*args):
    """The table tier's part3 with the ice limiter's lookup gated per cell,
    as the kernel gates it: the [approx] tier's part3 (the same up to the
    limiter, which leaves a cell with ice as it was), then the limiter
    looked up and applied only where the cell has ice."""
    *args, dtab = args
    out = list(CW.p3_part3(*args, None))
    qi, ni, qm, bm = out[4:8]
    has = qi >= PP.QSMALL
    rhop = torch.clamp(qm / torch.clamp(bm, min=1e-30), PP.RHO_RIMEMIN,
                       PP.RHO_RIMEMAX)
    v7, v8 = interp_ice_multi(dtab, (7, 8), *ice_table_indices(qi, ni, qm,
                                                               rhop))
    lim = torch.minimum(ni, v7 * ni)
    out[5] = torch.where(has, torch.maximum(lim, v8 * lim), ni)
    return tuple(out)


def _port_part3_inputs(case, tier, dtype):
    """What the port's own p3_scheme hands p3_part3 on the case's inputs in
    ``dtype``, and the tables."""
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype)
    a = [t(x) for x in _scheme_inputs(case)]
    dtab = _tables("port").to("cpu", dtype) if tier == "tables" else None
    seen = {}
    real = CW.p3_part3

    def spy(*args):
        seen["args"] = args
        return real(*args)
    CW.p3_part3 = spy
    try:
        PP.p3_scheme(*a[:14], 2.0, tables=dtab, qv_prev=a[14], t_prev=a[15])
    finally:
        CW.p3_part3 = real
    return seen["args"][:14], dtab


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["cold", "no_ice", "one_ice"])
def test_part3_and_output_pass_equal_former_code(case, dtype):
    """part3's plain version (both tiers; diagnostics on and off) and the
    output pass, on what the port's scheme hands them, equal the former
    eager code bit for bit; the table tier equals its per-cell-gated form
    bit for bit."""
    for tier in ("tables", "approx"):
        args, dtab = _port_part3_inputs(case, tier, dtype)
        got = CW.p3_part3(*args, dtab)
        want, _ = _former_part3(*args, dtab, False)
        for name, g, w in zip(PROG, got, want):
            assert torch.equal(g, w), (tier, name)
        prog, diag = CW.p3_part3(*args, dtab, diagnostics=True)
        want, want_diag = _former_part3(*args, dtab, True)
        for name, g, w in zip(PROG, prog, want):
            assert torch.equal(g, w), (tier, "diagnostics", name)
        for name in want_diag:
            assert torch.equal(diag[name], want_diag[name]), (tier, name)
        if tier == "tables":
            for name, g, w in zip(PROG, got, _per_cell_gated(*args, dtab)):
                assert torch.equal(g, w), ("per-cell gate", name)
    rho_d = torch.as_tensor(_scheme_inputs(case)[12], dtype=dtype)
    q = got[:10]
    out = CW.p3_wrapper_out(*q, args[11], rho_d)
    want = [torch.clamp(a * rho_d, min=0.0) for a in q[:9]]
    want += [q[9] * args[11], torch.clamp(q[8], min=0.0)]
    assert len(out) == 11
    for i, (g, w) in enumerate(zip(out, want)):
        assert torch.equal(g, w), i


def test_time_step_matches_jax():
    """MicrophysicsP3.time_step (part3 and the output pass through their
    wrappers) against JAX's on the seeded cold state, every field; the
    [approx] tier (test_part3_matches_jax holds the table tier's part3)."""
    ps = _p3_state("cold")
    js = jax_build(jax_config(_p3_raw(16000.0, 12)))[0]
    js = js.replace_fields(**{t[0]: jnp.asarray(ps[t[0]].numpy())
                              for t in JP.MicrophysicsP3.TRACERS})
    want = JP.MicrophysicsP3(use_tables=False).time_step(js, 2.0)
    got = PP.MicrophysicsP3(use_tables=False).time_step(to_port(js), 2.0)
    assert float(np.max(np.asarray(want["ice"]))) > 0.0
    for name in sorted(js.fields):
        w = np.asarray(want[name], np.float64)
        scale = max(np.abs(w).max(), 1e-300)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=RTOL,
                                   atol=ATOL_OF_SCALE * scale, err_msg=name)


# -- the MLP surrogate ---------------------------------------------------------

def _models():
    """(name, JAX MLP, port MLP, scl_in, scl_out as numpy): the shipped
    model (weights and tables loaded as f32) and a seeded 5 -> 16 -> 16 ->
    4, its weights drawn with numpy."""
    jm = JM.load_mlp(os.path.join(EX, "supercell_kessler_example_weights.npz"))
    si = np.asarray(JM.load_scaling(os.path.join(
        EX, "supercell_kessler_input_scaling.txt"), 5))
    so = np.asarray(JM.load_scaling(os.path.join(
        EX, "supercell_kessler_output_scaling.txt"), 4))
    rng = np.random.default_rng(17)
    deep = [(rng.uniform(-0.5, 0.5, (a, b)).astype(np.float32),
             rng.uniform(-0.5, 0.5, b).astype(np.float32))
            for a, b in ((5, 16), (16, 16), (16, 4))]
    out = []
    for name, ws in (("shipped", [(np.asarray(W), np.asarray(b))
                                  for W, b in jm.weights]), ("deep", deep)):
        out.append((name, JM.MLP([(jnp.asarray(W), jnp.asarray(b))
                                  for W, b in ws]),
                    TM.mlp_from_numpy(ws, "cpu"), si, so))
    return out


def _surrogate_inputs(dtype, si, shape=(1, 10, 8, 16), seed=23):
    """[T, rho_d, rho_v, rho_c, rho_r] drawn over the input scaling table's
    [min, max] rows ``si``, with no cloud or rain in a fifth of the cells,
    as numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = si[:, 0], si[:, 1]
    out = []
    for i in range(5):
        a = lo[i] + (hi[i] - lo[i]) * rng.random(shape)
        if i >= 3:
            a[rng.random(shape) < 0.2] = 0.0
        out.append(a.astype(dtype))
    return out


NAMES = ("temp", "density_dry", "water_vapor", "cloud_liquid",
         "precip_liquid")


def _port_forward(fields, model, si, so, tdtype):
    si_t = torch.as_tensor(si, dtype=tdtype)
    params, widths = SC.pack_mlp(
        [(W.to(tdtype), b.to(tdtype)) for W, b in model.weights], si_t,
        torch.as_tensor(so, dtype=tdtype))
    return SC.surrogate_forward(*(torch.as_tensor(f) for f in fields),
                                params, widths)


def _former_forward(fields, model, si, so, tdtype):
    """The surrogate's forward as the port computed it before the kernel:
    stack, normalise, the MLP's torch.matmul layers, denormalise, clamp."""
    si = torch.as_tensor(si, dtype=tdtype)
    so = torch.as_tensor(so, dtype=tdtype)
    x = torch.stack([torch.as_tensor(f) for f in fields], dim=-1)
    x = (x - si[:, 0]) / (si[:, 1] - si[:, 0])
    y = TM.MLP([(W.to(tdtype), b.to(tdtype))
                for W, b in model.weights])(x)
    y = y * (so[:, 1] - so[:, 0]) + so[:, 0]
    t, v, c, r = y.unbind(-1)
    return (t, torch.clamp_min(v, 0.0), torch.clamp_min(c, 0.0),
            torch.clamp_min(r, 0.0))


def _assert_surrogate_close(got, want, so, dtype, where):
    rng = np.diff(np.asarray(so, np.float64), axis=1)[:, 0]
    for v, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (where, v)
        err = np.abs(g - w).max()
        if dtype == np.float64:
            assert err <= 1e-12 * np.abs(w).max(), (where, v, err)
        else:
            assert err <= 1e-6 * rng[v], (where, v, err)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_surrogate_forward_matches_jax_and_former(dtype):
    """The plain forward (ordered sums) against JAX's _nn_forward and
    against the former eager forward (torch.matmul), both models; it keeps
    rho_v, rho_c and rho_r non-negative."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    models = _models()
    fields = _surrogate_inputs(dtype, models[0][3])
    for name, jmodel, pmodel, si, so in models:
        got = [a.detach().numpy() for a in _port_forward(fields, pmodel, si,
                                                         so, tdtype)]
        jstate = _Fields(meta=SimpleNamespace(jdtype=dtype), **dict(zip(
            NAMES, (jnp.asarray(f) for f in fields))))
        want = JSurrogate(jmodel, si, so)._nn_forward(jstate)
        _assert_surrogate_close(got, want, so, dtype, (name, "jax"))
        former = _former_forward(fields, pmodel, si, so, tdtype)
        _assert_surrogate_close(got, [a.detach().numpy() for a in former],
                                so, dtype, (name, "former"))
        assert min(float(np.min(a)) for a in got[1:]) >= 0.0


# -- the CPU takes the plain versions -----------------------------------------

def test_wrappers_take_the_plain_versions_on_the_cpu():
    """Given CPU tensors the four wrappers return their plain versions'
    values and count no launch."""
    counters = ("min_step.launches", "p3_part3.launches",
                "p3_wrapper_out.launches", "surrogate_forward.launches")
    before = [counter(c) for c in counters]
    rho_r, rho_d = _rain_columns(torch.float64)
    assert torch.equal(KC.min_step(rho_r, rho_d, 60.0, 200.0),
                       KC.min_step_plain(rho_r, rho_d, 60.0, 200.0))
    args, dtab = _port_part3_inputs("one_ice", "tables", torch.float64)
    for a, b in zip(CW.p3_part3(*args, dtab), CW.part3_plain(*args, dtab)):
        assert torch.equal(a, b)
    (prog, diag), (want, want_diag) = (
        f(*args, dtab, diagnostics=True) for f in (CW.p3_part3,
                                                   CW.part3_plain))
    for a, b in zip((*prog, *diag.values()), (*want, *want_diag.values())):
        assert torch.equal(a, b)
    w_args = (*args[:10], args[11], args[12])
    for a, b in zip(CW.p3_wrapper_out(*w_args),
                    CW.wrapper_out_plain(*w_args)):
        assert torch.equal(a, b)
    name, _, pmodel, si, so = _models()[0]
    fields = [torch.as_tensor(f) for f in _surrogate_inputs(np.float64, si)]
    params, widths = SC.pack_mlp(
        [(W.double(), b.double()) for W, b in pmodel.weights],
        torch.as_tensor(si, dtype=torch.float64),
        torch.as_tensor(so, dtype=torch.float64))
    assert widths == (5, 10, 4)
    for a, b in zip(SC.surrogate_forward(*fields, params, widths),
                    SC.surrogate_forward_plain(*fields, params, widths)):
        assert torch.equal(a, b)
    assert [counter(c) for c in counters] == before


def _seeded_model(sizes, seed):
    """(JAX MLP, port MLP) of ``sizes`` with the same f32 weights, drawn
    with numpy uniform in +-1/sqrt(n_in) (layer outputs stay of order 1)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.uniform(-a, a, (n, m)).astype(np.float32),
           rng.uniform(-a, a, m).astype(np.float32))
          for n, m, a in ((n, m, n ** -0.5)
                          for n, m in zip(sizes[:-1], sizes[1:]))]
    return (JM.MLP([(jnp.asarray(W), jnp.asarray(b)) for W, b in ws]),
            TM.mlp_from_numpy(ws, "cpu"))


# models of other widths and depths than the shipped 5 -> 10 -> 4
OTHER_MLPS = {"5-17-4": (5, 17, 4), "5-64-64-4": (5, 64, 64, 4),
              "18 layers": (5,) + (8,) * 17 + (4,)}


@pytest.mark.parametrize("name", list(OTHER_MLPS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_surrogate_takes_every_mlp(dtype, name):
    """MicrophysicsKesslerSurrogate takes an MLP of any widths and depth:
    one online step writes what JAX's MicrophysicsKesslerSurrogate.
    _nn_forward computes, at test_surrogate_forward_matches_jax_and_former's
    bounds (f64 1e-12 of each output's scale, f32 1e-6 of its scaling
    range), and leaves the diffs field as it was."""
    from miniweatherml_tpu_torch.physics.kessler_surrogate import \
        MicrophysicsKesslerSurrogate
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    jmodel, pmodel = _seeded_model(OTHER_MLPS[name], len(name))
    _, _, _, si, so = _models()[0]
    fields = _surrogate_inputs(dtype, si)
    micro = MicrophysicsKesslerSurrogate(pmodel, si, so, online=True)
    diffs = torch.zeros(4, dtype=tdtype)
    state = _Fields(meta=SimpleNamespace(tdtype=tdtype), surrogate_diffs=diffs,
                    **dict(zip(NAMES, (torch.as_tensor(f) for f in fields))))
    state.device = torch.device("cpu")
    out = micro.time_step(state, 1.0)
    got = [out[n].numpy() for n in ("temp", "water_vapor", "cloud_liquid",
                                    "precip_liquid")]
    jstate = _Fields(meta=SimpleNamespace(jdtype=dtype), **dict(zip(
        NAMES, (jnp.asarray(f) for f in fields))))
    want = JSurrogate(jmodel, si, so)._nn_forward(jstate)
    _assert_surrogate_close(got, want, so, dtype, name)
    assert out["surrogate_diffs"] is diffs
    assert micro._cast_for(state)[4][1] == OTHER_MLPS[name]


def test_surrogate_refuses_other_than_5_inputs_and_4_outputs():
    """pack_mlp raises a ValueError for a model of other than 5 inputs and
    4 outputs (JAX's forward fails on such a model too), on any device; the
    surrogate module raises it when it first packs the model."""
    from miniweatherml_tpu_torch.physics.kessler_surrogate import \
        MicrophysicsKesslerSurrogate
    gen = torch.Generator().manual_seed(3)
    si, so = torch.ones((5, 2)), torch.ones((4, 2))
    for sizes in ((5, 8, 3), (6, 8, 4), (4, 4)):
        with pytest.raises(ValueError, match="5 inputs to 4 outputs"):
            SC.pack_mlp(TM.init_mlp(sizes, gen).weights, si, so)
    micro = MicrophysicsKesslerSurrogate(TM.init_mlp((5, 40, 3), gen), si, so)
    state = SimpleNamespace(device=torch.device("cpu"),
                            meta=SimpleNamespace(tdtype=torch.float64))
    with pytest.raises(ValueError, match="5 inputs to 4 outputs"):
        micro._nn_forward(state)

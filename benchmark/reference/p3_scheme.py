"""The P3 scheme of the plain reference, in PyTorch: the wrapper's inputs
with the saturation pre-adjustment, ``p3_scheme`` at the lookup-table tier
with prescribed droplet number (the reference wrapper's settings,
microphysics_p3.h:314), and the wrapper's output pass.

Translated into PyTorch from the JAX package's
``miniweatherml_tpu/physics/p3.py`` at commit b9c5862 (its plain XLA
path: ``compute_adjusted_state``'s guarded Newton, ``_p3_part1_cellwise``,
the process rates of ``p3_scheme``, ``_p3_update_cellwise``, the
sedimentation loop, homogeneous freezing and part3,
``_p3_wrapper_inputs_cellwise`` and ``MicrophysicsP3.time_step``'s
output), and frozen here: a later change to either package does not move
it.  The JAX package's scheme is held to an independent transliteration
of the Fortran (``tests/oracle_p3.py``) by the repository's tests, and
this translation to the same oracle by ``benchmark/tests``.  The Fortran
citations (micro_p3.F90, microphysics_p3.h) are the JAX package's.

Every presence gate of the JAX scheme (``lax.cond`` around a lookup)
becomes the lookup on every cell: each value a lookup gives is used only
where its own gate holds.  With ``counts`` (a dict) the scheme adds the
number of cells that pass each gate, and the sub-step count, to it.
"""

from __future__ import annotations

import math

import torch

from . import p3_tables as T

R_D = 287.042
CP_D = 1004.64
R_V = 461.505
CP_V = 1859.0
P0 = 1.0e5
CP_L = 4188.0
RHO_H2O = 1000.0
LATVAP = 2501000.0
LATICE = 333700.0
TMELT = 273.15
QSMALL = 1.0e-14
NSMALL = 1.0e-16
NCCNST = 200.0e6
CONS3 = 1.0 / (4.0 * math.pi / 3.0 * RHO_H2O * 25.0e-6 ** 3)
T_HOMOGFRZ = TMELT - 40.0
MAX_TOTAL_NI = 500.0e3
RHO_RIMEMIN = 50.0
RHO_RIMEMAX = 900.0
EP_2 = 18.016 / 28.966
MAGNUS_A, MAGNUS_B = 17.625, 243.04
CONS1 = math.pi / 6.0 * RHO_H2O
INCLD_LIM, PRECIP_LIM = 5.1e-3, 1.0e-2
RHO_600MB = 60000.0 / (287.042 * 253.15)
RHO_1000MB = 100000.0 / (287.042 * 273.15)


def _w(cond, a, b=0.0):
    return torch.where(cond, a, b)


def _cbrt(x):
    return x ** (1.0 / 3.0)


# -- saturation (wrapper: Magnus; scheme: Murphy-Koop) ----------------------
def svp_magnus(temp):
    tc = temp - 273.15
    return 610.94 * torch.exp(MAGNUS_A * tc / (MAGNUS_B + tc))


def _dsvp_magnus(svp, temp):
    tc = temp - 273.15
    return svp * (MAGNUS_A * MAGNUS_B) / ((MAGNUS_B + tc) * (MAGNUS_B + tc))


def _mk_liq(t):
    logt = torch.log(t)
    return torch.exp(54.842763 - 6763.22 / t - 4.210 * logt + 0.000367 * t
                     + torch.tanh(0.0415 * (t - 218.8))
                     * (53.878 - 1331.22 / t - 9.44523 * logt
                        + 0.014025 * t))


def _mk_ice(t):
    logt = torch.log(t)
    e_ice = torch.exp(9.550426 - 5723.265 / t + 3.53068 * logt
                      - 0.00728332 * t)
    return _w(t < TMELT, e_ice, _mk_liq(t))


def qv_sat_liq(t, pres):
    e = _mk_liq(t)
    return EP_2 * e / (pres - e).clamp(min=1.0e-3)


def qv_sat_ice(t, pres):
    e = _mk_ice(t)
    return EP_2 * e / (pres - e).clamp(min=1.0e-3)


def latent_heat_condensation(temp):
    tc = temp - 273.15
    return (2500.8 - 2.36 * tc + 0.0016 * tc * tc
            - 0.00006 * tc * tc * tc) * 1000.0


def _cp_moist(rho_d, rho_v, rho_c):
    return (rho_d * CP_D + rho_v * CP_V + rho_c * CP_L) / (rho_d + rho_v
                                                           + rho_c)


def adjusted_state(rho, rho_d, rho_v, rho_c, temp):
    """The wrapper's saturation adjustment (microphysics_p3.h:467-550) by
    the JAX package's bracket-guarded Newton: a seed step from 0, then 7
    (float32 and below) or 10 (float64) more, the best |f| kept, and the
    boundary root x = -rho_c where all the cloud evaporates.  Returns
    (rho_v, rho_c, temp)."""
    svp = svp_magnus(temp)
    pv = rho_v * R_V * temp
    condensing = pv > svp
    evaporating = (pv < svp) & (rho_c > 0.0)
    lv = latent_heat_condensation(temp)
    n_newton = 10 if temp.dtype == torch.float64 else 7
    lo = _w(condensing, torch.zeros_like(rho_c), -rho_c)
    hi = _w(condensing, rho_v, 0.0)
    rho_t = rho_d + rho_v + rho_c
    cp0 = (rho_d * CP_D + rho_v * CP_V + rho_c * CP_L) / rho_t
    dcp = (CP_L - CP_V) / rho_t
    f0 = pv - svp
    dtdx0 = lv / (rho * cp0)
    dsvp0 = _dsvp_magnus(svp, temp)
    fp0 = -R_V * temp + rho_v * R_V * dtdx0 - dsvp0 * dtdx0
    x1 = -f0 / fp0.clamp(max=-1e-30)
    x = _w((fp0 < 0.0) & (x1 >= lo) & (x1 <= hi), x1, 0.5 * (lo + hi))
    xb = x
    fb = torch.full_like(x, float("inf"))
    for _ in range(n_newton + 1):
        rv = rho_v - x
        cp = cp0 + x * dcp
        dtdx_lin = lv / (rho * cp)
        t_loc = temp + x * dtdx_lin
        svp_loc = svp_magnus(t_loc)
        f = rv * R_V * t_loc - svp_loc
        absf = f.abs()
        better = absf < fb
        xb = _w(better, x, xb)
        fb = _w(better, absf, fb)
        lo = _w(f > 0.0, x, lo)
        hi = _w(f > 0.0, hi, x)
        dtdx = dtdx_lin * (1.0 - x * dcp / cp)
        dsvp = _dsvp_magnus(svp_loc, t_loc)
        fp = -R_V * t_loc + rv * R_V * dtdx - dsvp * dtdx
        xn = x - f / fp
        x = _w((xn >= lo) & (xn <= hi), xn, 0.5 * (lo + hi))
    x = xb
    cp_lo = cp0 - rho_c * dcp
    t_lo = temp - rho_c * lv / (rho * cp_lo)
    f_lo = (rho_v + rho_c) * R_V * t_lo - svp_magnus(t_lo)
    x = _w(evaporating & (f_lo <= 0.0), -rho_c, x)
    x = _w(condensing | evaporating, x, 0.0)
    rv = (rho_v - x).clamp(min=0.0)
    rc = (rho_c + x).clamp(min=0.0)
    return rv, rc, temp + x * lv / (rho * _cp_moist(rho_d, rv, rc))


# -- shared per-cell pieces -------------------------------------------------
def bulk_rho_rime(qi, qm, bm):
    """calc_bulkRhoRime (micro_p3.F90:1897-1943): (qm, bm, rho_rime)."""
    has = bm >= 1.0e-15
    rr = _w(has, (qm / bm.clamp(min=1e-30)).clamp(RHO_RIMEMIN, RHO_RIMEMAX))
    bm2 = _w(has, qm / rr.clamp(min=RHO_RIMEMIN))
    qm2 = _w(has, qm)
    over = (qm2 > qi) & (rr > 0.0)
    qm2 = _w(over, qi, qm2)
    bm2 = _w(over, qm2 / rr.clamp(min=RHO_RIMEMIN), bm2)
    tiny = qm2 < QSMALL
    return _w(tiny, 0.0, qm2), _w(tiny, 0.0, bm2), rr


def cap_ni(ni, inv_rho):
    """impose_max_total_ni (micro_p3.F90:1947-1969)."""
    dum = MAX_TOTAL_NI * inv_rho / ni.clamp(min=1e-20)
    return _w(ni >= 1e-20, ni * dum.clamp(max=1.0), ni)


def rain_dsd2(qr, nr):
    """get_rain_dsd2's limiter of nr at mu_r = 1: (nr, lamr clipped)."""
    nr1 = nr.clamp(min=NSMALL)
    lamr = _cbrt(CONS1 * nr1 * 24.0 / qr.clamp(min=QSMALL))
    lamr_cl = lamr.clamp(2.0 * 500.0, 2.0 * 1.0e5)
    nr_lim = _w(lamr != lamr_cl, lamr_cl ** 3 * qr / (24.0 * CONS1), nr1)
    return _w(qr >= QSMALL, nr_lim, nr), lamr_cl


def cloud_mu(nc, rho):
    s = 0.0005714 * (nc * 1.0e-6 * rho) + 0.2714
    return (1.0 / (s * s) - 1.0).clamp(2.0, 15.0)


def cloud_dsd2(qc, nc, rho):
    """get_cloud_dsd2's limiter of nc: (nc, mu_c, lamc clipped)."""
    nc1 = nc.clamp(min=NSMALL)
    mu = cloud_mu(nc1, rho)
    mval = (mu + 3.0) * (mu + 2.0) * (mu + 1.0)
    lamc = _cbrt(CONS1 * nc1 * mval / qc.clamp(min=QSMALL))
    lamc_cl = torch.minimum(torch.maximum(lamc, (mu + 1.0) * 2.5e4),
                            (mu + 1.0) * 1.0e6)
    nc_lim = _w(lamc != lamc_cl, lamc_cl ** 3 * qc / (CONS1 * mval), nc1)
    return _w(qc >= QSMALL, nc_lim, nc), mu, lamc_cl


def _clip_t(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


# -- p3_main_part1 + in-cloud values (micro_p3.F90:363-481, :588-637) -------
def part1(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, rho):
    lv, ls, lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D
    inv_rho = 1.0 / rho
    temp = theta * exner
    sup_i0 = qv / qv_sat_ice(temp, pres).clamp(min=QSMALL) - 1.0
    small_c = qc < QSMALL
    qv = qv + _w(small_c, qc)
    theta = theta - _w(small_c, qc) * lv / (cp * exner)
    qc = _w(small_c, 0.0, qc)
    nc = _w(small_c, 0.0, NCCNST * inv_rho)
    small_r = qr < QSMALL
    qv = qv + _w(small_r, qr)
    theta = theta - _w(small_r, qr) * lv / (cp * exner)
    qr = _w(small_r, 0.0, qr)
    nr = _w(small_r, 0.0, nr)
    small_i = (qi < QSMALL) | ((qi < 1.0e-8) & (sup_i0 < -0.1))
    qv = qv + _w(small_i, qi)
    theta = theta - _w(small_i, qi) * ls / (cp * exner)
    qi, ni, qm, bm = (_w(small_i, 0.0, a) for a in (qi, ni, qm, bm))
    melt1 = (qi >= QSMALL) & (qi < 1.0e-8) & (temp >= TMELT)
    qr = qr + _w(melt1, qi)
    theta = theta - _w(melt1, qi) * lf / (cp * exner)
    qi, ni, qm, bm = (_w(melt1, 0.0, a) for a in (qi, ni, qm, bm))
    temp = theta * exner
    skip = ((qc < QSMALL) & (qr < QSMALL) & (qi < QSMALL) & (temp < TMELT)
            & (sup_i0 < -0.05))
    qc_in = _w(qc >= QSMALL, qc.clamp(max=INCLD_LIM))
    qr_in = _w(qr >= QSMALL, qr.clamp(max=PRECIP_LIM))
    qi_in = _w(qi >= QSMALL, qi.clamp(max=INCLD_LIM))
    has_qm = (qm >= QSMALL) & (qi >= QSMALL)
    qm_in = _w(has_qm, qm)
    bm_in = _w(has_qm, bm.clamp(min=0.0).clamp(max=INCLD_LIM))
    nc = cloud_dsd2(qc_in, nc, rho)[0]
    nr = rain_dsd2(qr_in, nr)[0]
    nc_in = _w(qc >= QSMALL, nc.clamp(min=0.0))
    nr_in = _w(qr >= QSMALL, nr.clamp(min=0.0))
    ni_in = cap_ni(_w(qi >= QSMALL, ni.clamp(min=0.0)), inv_rho)
    mu_cd = cloud_mu(nc.clamp(min=NSMALL), rho)
    return (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, skip,
            qc_in, qr_in, qi_in, qm_in, bm_in, nc_in, nr_in, ni_in, mu_cd)


def _conserve(avail, dt, *sinks):
    total = sum(sinks) * dt
    ratio = _w(total > avail, avail / total.clamp(min=1e-300), 1.0)
    return [s * ratio for s in sinks]


def _ratio(sinks, avail, strict):
    cond = (sinks > avail) & (sinks >= 1.0e-20) if strict else sinks > avail
    return _w(cond, avail / sinks.clamp(min=1e-30), 1.0)


# -- conservation, prognostic update, end-of-part2 clip (:2957-3266) --------
def update(dt, r, c):
    """``r``: the process rates by name; ``c``: the cell values, in-cloud
    values and thermodynamics by name.  Returns the ten prognostics."""
    lv, ls, lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D
    qc, nc, qr, nr, qi, ni, qm, bm, qv, theta = (
        c[k] for k in ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv",
                       "theta"))
    exner, inv_rho, temp, qv_si, pres = (
        c[k] for k in ("exner", "inv_rho", "temp", "qv_si", "pres"))
    qc_in, nc_in, qr_in, nr_in, qi_in, ni_rate = (
        c[k] for k in ("qc_in", "nc_in", "qr_in", "nr_in", "qi_in",
                       "ni_rate"))
    au, ac, qc_frz, nc_frz, qr_frz, nr_frz = (
        r[k] for k in ("au", "ac", "qc_frz", "nc_frz", "qr_frz", "nr_frz"))
    rim, shed, ncshdc, berg, dep, sub, ev, melt = (
        r[k] for k in ("rim", "shed", "ncshdc", "berg", "dep", "sub", "ev",
                       "melt"))
    qinuc, ninuc, qrcol, nr_col, nr_self, ni_self, nr_shed_wg = (
        r[k] for k in ("qinuc", "ninuc", "qrcol", "nr_col", "nr_self",
                       "ni_self", "nr_shed_wg"))
    rho_rime, log_wg, skip = r["rho_rime"], r["log_wg"], c["skip"]

    inv_qc = 1.0 / qc_in.clamp(min=QSMALL)
    nc2nr_auto = au * nc_in * inv_qc
    nc_accret = ac * nc_in * inv_qc
    nc_collect = (rim + shed) * nc_in * inv_qc
    ncautr = au * CONS3
    ni2nr_melt = melt * ni_rate / qi_in.clamp(min=QSMALL)
    ni_sub_n = sub * ni_rate / qi_in.clamp(min=QSMALL)
    nr_evap = ev * nr_in / qr_in.clamp(min=QSMALL)

    ratio_qc = _ratio((au + ac + qc_frz + rim + shed + berg) * dt, qc, True)
    au, ac, qc_frz, rim, shed, berg = (
        t * ratio_qc for t in (au, ac, qc_frz, rim, shed, berg))
    liq = qc > 1.0e-20
    dep = _w(liq, dep * (1.0 - ratio_qc), dep)
    sub = _w(liq, sub * (1.0 - ratio_qc), sub)
    ratio_qr = _ratio((ev + qrcol + qr_frz) * dt,
                      qr + (au + ac + melt + shed) * dt, True)
    ev, qrcol, qr_frz = (t * ratio_qr for t in (ev, qrcol, qr_frz))
    ratio_qi = _ratio((sub + melt) * dt,
                      qi + (dep + qinuc + berg + qrcol + rim + qr_frz
                            + qc_frz) * dt, True)
    sub, melt = sub * ratio_qi, melt * ratio_qi
    qv_avail = ((qv + (sub + ev) * dt - qv_si)
                / (1.0 + ls * ls * qv_si / (cp * R_V * temp * temp))
                ).clamp(min=0.0)
    dep_l, qinuc_l = _conserve(qv_avail, dt, dep, qinuc)
    scale = dep + qinuc > QSMALL
    dep = _w(scale, dep_l, dep)
    qinuc = _w(scale, qinuc_l, qinuc)

    ratio_nc = _ratio((nc_collect + nc_frz + nc_accret + nc2nr_auto) * dt,
                      nc, False)
    nc_collect, nc_frz, nc_accret, nc2nr_auto = (
        t * ratio_nc for t in (nc_collect, nc_frz, nc_accret, nc2nr_auto))
    ratio_nr = _ratio((nr_col + nr_frz + nr_self + nr_evap) * dt,
                      nr + (ni2nr_melt + nr_shed_wg + ncshdc
                            + nc2nr_auto) * dt, False)
    nr_col, nr_frz, nr_self, nr_evap = (
        t * ratio_nr for t in (nr_col, nr_frz, nr_self, nr_evap))
    ratio_ni = _ratio((ni2nr_melt + ni_sub_n + ni_self) * dt,
                      ni + (ninuc + nr_frz + nc_frz) * dt, False)
    ni2nr_melt, ni_sub_n, ni_self = (
        t * ratio_ni for t in (ni2nr_melt, ni_sub_n, ni_self))

    # prevent_liq_supersaturation (:2888-2955)
    qv_sources = sub + ev
    qv_sinks = dep + qinuc
    t_end = temp + ((qv_sinks - sub) * ls / cp - ev * lv / cp) * dt
    qsl_end = qv_sat_liq(t_end, pres)
    a_plq = (lv * qsl_end * dt / cp / (R_V * t_end * t_end)
             * (ls * sub + lv * ev))
    tiny = 1e-300 if qv.dtype == torch.float64 else 1e-35
    frac = ((qsl_end - qv + qv_sinks * dt + a_plq)
            / (qv_sources * dt + a_plq).clamp(min=tiny)).clamp(0.0, 1.0)
    frac = _w(qv_sources < QSMALL, 0.0, frac)
    sub, ev = sub * frac, ev * frac

    qc_new = qc + dt * (-au - ac - qc_frz - rim - shed - berg)
    qr_new = qr + dt * (au + ac - ev - qr_frz - qrcol + melt + shed)
    qi_new = qi + dt * (qc_frz + qr_frz + qrcol + dep + qinuc + berg
                        - sub - melt + rim)
    qv_new = qv + dt * (ev + sub - dep - qinuc)
    nr_new = nr + dt * (ncautr - nr_self - nr_frz - nr_col + ni2nr_melt
                        + ncshdc + nr_shed_wg - nr_evap)
    ni_new = ni + dt * (ninuc + nc_frz + nr_frz - ni_self - ni2nr_melt
                        - ni_sub_n)
    qm_new = qm + dt * (rim + qr_frz + qrcol + qc_frz
                        - (melt + sub) * qm / qi.clamp(min=QSMALL))
    bm_new = bm + dt * (rim / rho_rime + (qr_frz + qrcol + qc_frz) / 900.0
                        - (melt + sub) * bm / qi.clamp(min=QSMALL))
    neg = qm_new < 0.0
    qm_new = _w(neg, 0.0, qm_new)
    bm_new = _w(neg, 0.0, bm_new)
    qm_new = _w(log_wg, qi_new, qm_new)
    bm_new = _w(log_wg, qi_new / 900.0, bm_new)
    nc = _w(skip, nc, NCCNST * inv_rho)
    theta = theta + dt / (cp * exner) * (
        lv * (-ev) + ls * (dep + qinuc - sub)
        + lf * (qc_frz + qr_frz + qrcol + rim + berg - melt))
    qc, qr, qi, qv, nr, ni = (a.clamp(min=0.0) for a in (
        qc_new, qr_new, qi_new, qv_new, nr_new, ni_new))
    qm, bm = qm_new, bm_new

    tiny_c = qc < QSMALL
    qv = qv + _w(tiny_c, qc)
    theta = theta - _w(tiny_c, qc * lv / (cp * exner))
    qc, nc = _w(tiny_c, 0.0, qc), _w(tiny_c, 0.0, nc)
    tiny_r = qr < QSMALL
    qv = qv + _w(tiny_r, qr)
    theta = theta - _w(tiny_r, qr * lv / (cp * exner))
    qr, nr = _w(tiny_r, 0.0, qr), _w(tiny_r, 0.0, nr)
    tiny_i = qi < QSMALL
    qv = qv + _w(tiny_i, qi)
    theta = theta - _w(tiny_i, qi * ls / (cp * exner))
    qi, ni, qm, bm = (_w(tiny_i, 0.0, a) for a in (qi, ni, qm, bm))
    ni = cap_ni(ni, inv_rho)
    return qc, nc, qr, nr, qi, ni, qm, bm, qv, theta


def _count(counts, name, mask):
    if counts is not None:
        counts[name] = counts.get(name, 0) + int(mask.sum().item())


def _gamma_ratio(a, b):
    return torch.exp(torch.lgamma(a) - torch.lgamma(b))


def p3_scheme(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres,
              rho_d, dz, dt, tab, qv_prev, t_prev, vmax=None, counts=None):
    """One P3 step on dry mixing ratios, the vertical on axis 1
    (bottom-up), at the table tier (``tab``: ``p3_tables.Tables`` on the
    device).  The sedimentation's sub-step count comes from ``vmax`` where
    given, else from these cells' fastest fall speed.  Returns the ten
    prognostics, the surface liquid and ice rates (m/s) and the fastest
    fall speed seen here."""
    lv, ls, lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D
    rho = rho_d * (1.0 + qv + qc + qr + qi)
    inv_rho = 1.0 / rho
    nz = qc.shape[1]
    (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, skip, qc_in, qr_in,
     qi_in, qm_in, bm_in, nc_in, nr_in, ni_in, mu_cd) = part1(
        qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres, rho)
    for name, q in (("cloud", qc), ("rain", qr), ("ice", qi)):
        _count(counts, name, q >= QSMALL)
    _count(counts, "ice_and_rain", (qi >= QSMALL) & (qr >= QSMALL))

    mu_visc0 = 1.496e-6 * temp ** 1.5 / (temp + 120.0)
    acn = 9.80616 * RHO_H2O / (18.0 * mu_visc0)

    def lamc_mu(qc_, nc_, mu_):
        lamc = _cbrt(CONS1 * nc_.clamp(min=NSMALL) * (mu_ + 3.0)
                     * (mu_ + 2.0) * (mu_ + 1.0) / qc_.clamp(min=QSMALL))
        return _clip_t(lamc, (mu_ + 1.0) * 2.5e4, (mu_ + 1.0) * 1.0e6)

    def cloud_vt(qc_, nc_):
        mu_ = cloud_mu(nc_, rho)
        lamc = lamc_mu(qc_, nc_, mu_)
        v = acn * _gamma_ratio(mu_ + 6.0, mu_ + 4.0) / (lamc * lamc)
        return _w(qc_ >= QSMALL, v), lamc

    # -- warm rates
    qc_gt = qc_in >= 1.0e-8
    au = _w(qc_gt, 1350.0 * qc_in.clamp(min=QSMALL) ** 2.47
            * (nc_in * 1.0e-6 * rho).clamp(min=NSMALL) ** (-1.79))
    both = (qc >= QSMALL) & (qr >= QSMALL)
    ac = _w(both, 67.0 * (qc_in * qr_in).clamp(min=1e-300) ** 1.15)
    dm_r = _cbrt(qr_in.clamp(min=QSMALL)
                 / (math.pi * RHO_H2O * nr_in.clamp(min=NSMALL)))
    brk = _w(dm_r < 280.0e-6, 1.0, 2.0 - torch.exp(2300.0 * (dm_r
                                                             - 280.0e-6)))
    nr_self = _w(qr >= QSMALL, brk * 5.78 * nr_in * qr_in * rho)
    qsl = qv_sat_liq(temp, pres)
    _count(counts, "autoconversion", qc_gt)
    _count(counts, "accretion", both)

    # -- ice rates
    tc = temp - TMELT
    qv_si = qv_sat_ice(temp, pres)
    sup_i = qv / qv_si.clamp(min=QSMALL) - 1.0
    mi0 = 4.0 * math.pi / 3.0 * 900.0 * 1.0e-18
    n_coop = torch.minimum(
        0.005 * torch.exp(0.304 * (-tc).clamp(min=0.0)) * 1.0e3 * inv_rho,
        100.0e3 * inv_rho)
    n_nuc = (n_coop - ni).clamp(min=0.0) / dt
    nucleate = (tc < -15.0) & (sup_i >= 0.05) & (n_nuc >= 1.0e-20)
    qinuc = _w(nucleate, n_nuc * mi0)
    ninuc = _w(nucleate, n_nuc)
    _count(counts, "nucleation", nucleate)
    cons5 = math.pi / 6.0 * 2.0
    cons6 = (math.pi / 6.0) ** 2 * RHO_H2O * 2.0
    dum1_frz = torch.exp(0.65 * (-tc).clamp(max=40.0))
    frz_c = (qc >= QSMALL) & (tc <= -4.0)
    lamc_frz = lamc_mu(qc_in, nc, mu_cd)
    cdist1_c = nc_in.clamp(min=NSMALL) * torch.exp(-torch.lgamma(mu_cd
                                                                 + 1.0))
    qc_frz = _w(frz_c, cons6 * cdist1_c * torch.exp(torch.lgamma(7.0 + mu_cd))
                * dum1_frz / lamc_frz ** 6)
    nc_frz = _w(frz_c, cons5 * cdist1_c * torch.exp(torch.lgamma(4.0 + mu_cd))
                * dum1_frz / lamc_frz ** 3)
    frz_r = (qr >= QSMALL) & (tc <= -4.0)
    lamr_frz = _cbrt(math.pi / 6.0 * RHO_H2O * 24.0 * nr_in.clamp(min=NSMALL)
                     / qr_in.clamp(min=QSMALL))
    qr_frz = _w(frz_r, cons6 * nr_in.clamp(min=NSMALL) * 5040.0 * dum1_frz
                / lamr_frz ** 6)
    nr_frz = _w(frz_r, cons5 * nr_in.clamp(min=NSMALL) * 24.0 * dum1_frz
                / lamr_frz ** 3)
    _count(counts, "freeze_cloud", frz_c)
    _count(counts, "freeze_rain", frz_r)

    # -- the table tier's ice rates (micro_p3.F90:2054-2355)
    qm_reb, bm_reb, rho_rime_raw = bulk_rho_rime(qi_in, qm_in, bm_in)
    qm = _w(qi >= QSMALL, qm_reb, qm)
    bm = _w(qi >= QSMALL, bm_reb, bm)
    idx = T.ice_indices(qi_in, ni_in.clamp(min=NSMALL), qm_reb, rho_rime_raw)
    tab7, tab8, tab4, tab2, tab3, tab5, tab10 = (
        T.interp_ice(tab, k, *idx) for k in (7, 8, 4, 2, 3, 5, 10))
    ni_t = ni_in.clamp(min=NSMALL)
    ni_t = torch.minimum(ni_t, tab7 * ni_t)
    ni_t = torch.maximum(ni_t, tab8 * ni_t)
    ni_rate = _w(qi >= QSMALL, ni_t, ni_in)
    rhofaci = (RHO_600MB * inv_rho) ** 0.54
    collect_qc = rhofaci * tab4 * qc_in * 0.5 * rho * ni_rate
    both_ic = (qi >= QSMALL) & (qc >= QSMALL)
    rim = _w(both_ic & (tc < 0.0), collect_qc)
    shed = _w(both_ic & (tc > 0.0), collect_qc)
    ncshdc = shed * (1.0 / 5.2e-7)
    vi_table = rhofaci * tab2
    vt_qc, lamc_r = cloud_vt(qc_in, nc_in)
    d_c = (mu_cd + 4.0) / lamc_r
    i_tc = 1.0 / tc.clamp(max=-0.001)
    ri = (-0.5e6 * d_c * (vi_table - vt_qc).abs() * i_tc).clamp(1.0, 12.0)
    rho_rime = _w(ri <= 8.0, (0.051 + 0.114 * ri - 0.0055 * ri * ri) * 1000.0,
                  611.0 + 72.25 * (ri - 8.0))
    rho_rime = _w((rim >= QSMALL) & (qc >= QSMALL), rho_rime, 400.0)
    _count(counts, "riming", both_ic & (tc < 0.0))
    _count(counts, "shedding", both_ic & (tc > 0.0))

    j0, fj = T.rain_collection_index(qr_in, nr_in.clamp(min=NSMALL))
    lamr = _cbrt(math.pi / 6.0 * RHO_H2O * 24.0 * nr_in.clamp(min=NSMALL)
                 / qr_in.clamp(min=QSMALL))
    n0r = nr_in.clamp(min=NSMALL) * lamr * lamr
    both_ir = (qi >= QSMALL) & (qr >= QSMALL) & (tc <= 0.0)
    coll2, coll1 = (T.interp_collect(tab, k, *idx, j0, fj) for k in (2, 1))
    qrcol = _w(both_ir, coll2 * n0r * rho * rhofaci * ni_rate)
    nr_col = _w((qi >= QSMALL) & (qr >= QSMALL),
                coll1 * n0r * rho * rhofaci * ni_rate)
    _count(counts, "ice_rain_collection", both_ir)

    mu_visc = 1.496e-6 * temp ** 1.5 / (temp + 120.0)
    dv_diff = 8.794e-5 * temp ** 1.81 / pres
    sc_n = mu_visc / (rho * dv_diff)
    kap = 1.414e3 * mu_visc
    eii = (0.001 + (temp - 253.15) * (0.3 - 0.001) / 20.0).clamp(0.001, 0.3)
    fr = qm_reb / qi_in.clamp(min=QSMALL)
    eii_fact = (1.0 - (fr - 0.6) / 0.3).clamp(0.0, 1.0)
    has_ice = qi >= QSMALL
    ni_self = _w(has_ice, tab3 * rho * eii * eii_fact * rhofaci * ni_rate
                 * ni_rate)
    vent = tab5 + tab10 * _cbrt(sc_n) * torch.sqrt(rhofaci * rho / mu_visc)
    qsat0 = qv_sat_liq(torch.full_like(temp, TMELT), pres)
    melt = _w(has_ice & (tc > 0.0),
              (vent * (tc * kap - rho * lv * dv_diff * (qsat0 - qv))
               * 2.0 * math.pi / lf * ni_rate).clamp(min=0.0))
    epsi = _w(has_ice & (tc < 0.0),
              vent * 2.0 * math.pi * rho * dv_diff * ni_rate)
    dqsidt = (lv + LATICE) * qv_si / (R_V * temp * temp)
    abi = 1.0 + dqsidt * (lv + LATICE) / CP_D
    qi_tend = (epsi / abi).clamp(max=1.0 / dt) * (qv - qv_si)
    dep = _w(tc < 0.0, qi_tend.clamp(min=0.0))
    sub = (-qi_tend).clamp(min=0.0)
    berg = _w(has_ice & (tc < 0.0), (epsi / abi * (qsl - qv_si)).clamp(
        min=0.0))
    _count(counts, "melting", has_ice & (tc > 0.0))
    _count(counts, "deposition_sublimation", has_ice & (tc < 0.0))

    vn_row, vm_row, revap_row = (torch.as_tensor(a).to(qr.device, qr.dtype)
                                 for a in T.rain_tables())
    i0r, fir = T.rain_size_index((T.MU_R + 1.0) / lamr)
    revap_v = T.interp_rain(revap_row, i0r, fir)
    cdistr = nr_in.clamp(min=NSMALL)
    epsr = 2.0 * math.pi * cdistr * rho * dv_diff * (
        T.F1R * 2.0 / lamr
        + T.F2R * torch.sqrt(rho / mu_visc) * _cbrt(sc_n) * revap_v)
    cold_mix = (qi >= QSMALL) & (qc_in + qr_in >= 1.0e-6) & (tc < 0.0)
    qwgrth = _w(cold_mix,
                (vent * 2.0 * math.pi
                 * (rho * lv * dv_diff * (qsat0 - qv) - tc * kap)
                 / (lf + CP_L * tc) * ni_rate).clamp(min=0.0),
                float("inf"))
    excess = (rim + qrcol - qwgrth).clamp(min=0.0)
    excess = _w(excess >= 1.0e-10, excess)
    log_wg = cold_mix & (excess >= 1.0e-10)
    tot_col = (rim + qrcol).clamp(min=1e-30)
    wg_frac = _w(rim + qrcol >= 1.0e-10, excess / tot_col)
    shed = shed + excess * (rim / tot_col)
    rim = rim * (1.0 - wg_frac)
    qrcol = qrcol * (1.0 - wg_frac)
    nr_shed_wg = excess * 1.923e6
    _count(counts, "wet_growth", log_wg)

    # rain evaporation (evaporate_rain, :3383-3537)
    dqsldt = lv * qsl / (R_V * temp * temp)
    abl = 1.0 + dqsldt * lv / CP_D
    ssat_r = qv - qsl
    below = tc < 0.0
    eps_eff = _w(below, epsr + epsi * (1.0 + ls / CP_D * dqsldt) / abi,
                 epsr).clamp(min=1.0e-20)
    tau_eff = 1.0 / eps_eff
    a_c = ((qv - qv_prev) / dt - dqsldt * (temp - t_prev) / dt
           - _w(below, (qsl - qv_si) * (1.0 + ls / CP_D * dqsldt) / abi
                * epsi))
    tau_r = 1.0 / epsr.clamp(min=1.0e-20)
    dtau = dt / tau_eff
    w_ts = -torch.expm1(-dtau) / dtau
    ev_big = (-ssat_r / (abl * tau_r)) * w_ts \
        + (-a_c / abl * tau_eff / tau_r) * (1.0 - w_ts)
    ev = _w((qr_in < 1.0e-12) & (qv / qsl.clamp(min=QSMALL) < 0.999),
            qr_in / dt, ev_big)
    ev = torch.minimum(ev, -ssat_r / dt / abl)
    ev = torch.minimum(ev.clamp(min=0.0), qr_in / dt)
    evap = (qc_in + qi_in < 1.0e-6) & (ssat_r < 0.0) & (qr >= QSMALL)
    ev = _w(evap, ev)
    _count(counts, "rain_evaporation", evap)

    rhofacr = (RHO_1000MB * inv_rho) ** 0.54
    rates = dict(au=au, ac=ac, qc_frz=qc_frz, nc_frz=nc_frz, qr_frz=qr_frz,
                 nr_frz=nr_frz, rim=rim, shed=shed, ncshdc=ncshdc, berg=berg,
                 dep=dep, sub=sub, ev=ev, melt=melt, qinuc=qinuc,
                 ninuc=ninuc, qrcol=qrcol, nr_col=nr_col, nr_self=nr_self,
                 ni_self=ni_self, nr_shed_wg=nr_shed_wg, rho_rime=rho_rime,
                 log_wg=log_wg)
    cells = dict(qc=qc, nc=nc, qr=qr, nr=nr, qi=qi, ni=ni, qm=qm, bm=bm,
                 qv=qv, theta=theta, exner=exner, inv_rho=inv_rho,
                 temp=temp, qv_si=qv_si, pres=pres, skip=skip, qc_in=qc_in,
                 nc_in=nc_in, qr_in=qr_in, nr_in=nr_in, qi_in=qi_in,
                 ni_rate=ni_rate)
    qc, nc, qr, nr, qi, ni, qm, bm, qv, theta = update(dt, rates, cells)
    del rates, cells

    # -- sedimentation (cloud, rain, ice), upstream, CFL sub-cycled
    def cloud_speeds(qc_, nc_):
        gate = qc_ >= QSMALL
        qc_c = _w(gate, qc_.clamp(max=5.1e-3))
        nc_l = cloud_dsd2(qc_c, _w(gate, nc_.clamp(min=0.0)), rho)[0]
        return cloud_vt(qc_c, nc_l)[0], _w(gate, nc_l, nc_)

    def ice_speeds(qi_, ni_, qm_, bm_):
        gate = qi_ >= QSMALL
        qi_c = _w(gate, qi_.clamp(max=5.1e-3))
        ni_c = _w(gate, ni_.clamp(min=0.0)).clamp(min=NSMALL)
        has_m = gate & (qm_ >= QSMALL)
        qm_c = _w(has_m, qm_)
        bm_c = _w(has_m, bm_.clamp(min=0.0).clamp(max=5.1e-3))
        qm_c, bm_c, rr = bulk_rho_rime(qi_c, qm_c, bm_c)
        ix = T.ice_indices(qi_c, ni_c, qm_c, rr)
        v_q, v_n, t7, t8 = (T.interp_ice(tab, k, *ix) for k in (2, 1, 7, 8))
        ni_l = torch.minimum(ni_c, t7 * ni_c)
        ni_l = torch.maximum(ni_l, t8 * ni_l)
        return (_w(gate, rhofaci * v_q), _w(gate, rhofaci * v_n),
                _w(gate, ni_l, ni_), _w(gate, qm_c, qm_), _w(gate, bm_c, bm_))

    def rain_speeds(qr_, nr_):
        gate = qr_ >= QSMALL
        qr_c = _w(gate, qr_.clamp(max=1.0e-2))
        nr_l = rain_dsd2(qr_c, _w(gate, nr_.clamp(min=0.0)))[0]
        lam = _cbrt(math.pi / 6.0 * RHO_H2O * 24.0 * nr_l.clamp(min=NSMALL)
                    / qr_c.clamp(min=QSMALL))
        i0, fi = T.rain_size_index((T.MU_R + 1.0) / lam)
        vm = T.interp_rain(vm_row, i0, fi)
        vn = T.interp_rain(vn_row, i0, fi)
        return (_w(gate, rhofacr * vm), _w(gate, rhofacr * vn),
                _w(gate, nr_l, nr_))

    here = torch.stack([rain_speeds(qr, nr)[0].max(),
                        ice_speeds(qi, ni, qm, bm)[0].max(),
                        cloud_speeds(qc, nc)[0].max()]).max()
    v = here if vmax is None else vmax
    nsub = max(1, int(math.ceil(dt * float(v) / (0.9 * float(dz)))))
    dts = dt / nsub
    if counts is not None:
        counts["sed_substeps"] = max(counts.get("sed_substeps", 0), nsub)

    def fall(q, v_):
        flux = rho * q * v_
        dq = torch.empty_like(q)
        dq[:, :nz - 1] = dts * (flux[:, 1:] - flux[:, :nz - 1]) / (
            rho[:, :nz - 1] * dz)
        dq[:, nz - 1] = -dts * flux[:, nz - 1] / (rho[:, nz - 1] * dz)
        return (q + dq).clamp(min=0.0), dts * flux[:, 0] / RHO_H2O

    pl = torch.zeros_like(qc[:, 0])
    pi_ = torch.zeros_like(qc[:, 0])
    for _ in range(nsub):
        vr, vnr, nr = rain_speeds(qr, nr)
        vi, vni, ni, qm, bm = ice_speeds(qi, ni, qm, bm)
        vc, nc = cloud_speeds(qc, nc)
        qc, p = fall(qc, vc)
        pl = pl + p
        qr, p = fall(qr, vr)
        pl = pl + p
        nr = fall(nr, vnr)[0]
        qi, p = fall(qi, vi)
        pi_ = pi_ + p
        ni = fall(ni, vni)[0]
        qm = fall(qm, vi)[0]
        bm = fall(bm, vi)[0]
    precip_liq, precip_ice = pl / dt, pi_ / dt

    # -- homogeneous freezing (:4145-4200), on part1's temperature
    for q_name in ("c", "r"):
        q, n = (qc, nc) if q_name == "c" else (qr, nr)
        frz = (q >= QSMALL) & (temp < T_HOMOGFRZ)
        _count(counts, "homogeneous_freezing_" + q_name, frz)
        q_nuc = _w(frz, q)
        qm = qm + q_nuc
        qi = qi + q_nuc
        bm = bm + q_nuc / RHO_RIMEMAX
        ni = ni + _w(frz, n.clamp(min=NSMALL))
        theta = theta + q_nuc * lf / (cp * exner)
        if q_name == "c":
            qc, nc = _w(frz, 0.0, qc), _w(frz, 0.0, nc)
        else:
            qr, nr = _w(frz, 0.0, qr), _w(frz, 0.0, nr)

    # -- part3 (:977-1137), prognostic effects only
    small_c = qc < QSMALL
    qv = qv + _w(small_c, qc)
    theta = theta - _w(small_c, qc) * lv / (cp * exner)
    nc = _w(small_c, 0.0, cloud_dsd2(qc, nc, rho)[0])
    qc = _w(small_c, 0.0, qc)
    small_r = qr < QSMALL
    qv = qv + _w(small_r, qr)
    theta = theta - _w(small_r, qr) * lv / (cp * exner)
    nr = _w(small_r, 0.0, rain_dsd2(qr, nr)[0])
    qr = _w(small_r, 0.0, qr)
    small_i = qi < QSMALL
    qv = qv + _w(small_i, qi)
    theta = theta - _w(small_i, qi) * ls / (cp * exner)
    ni = ni.clamp(min=NSMALL)
    qm, bm, _ = bulk_rho_rime(qi, qm, bm)
    ni = cap_ni(ni, inv_rho)
    rhop3 = (qm / bm.clamp(min=1e-30)).clamp(RHO_RIMEMIN, RHO_RIMEMAX)
    ix3 = T.ice_indices(qi, ni, qm, rhop3)
    t7, t8 = (T.interp_ice(tab, k, *ix3) for k in (7, 8))
    ni = torch.minimum(ni, t7 * ni)
    ni = torch.maximum(ni, t8 * ni)
    qi, ni, qm, bm = (_w(small_i, 0.0, a) for a in (qi, ni, qm, bm))
    return (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, precip_liq,
            precip_ice, here)


def wrapper_inputs(rho_d, temp, rho_c, rho_nc, rho_r, rho_nr, rho_i, rho_ni,
                   rho_m, rho_bm, rho_v, qv_prev_f, t_prev_f):
    """The wrapper's pre-scheme work (microphysics_p3.h:273-301): the
    saturation adjustment on densities, densities to mixing ratios,
    pressure, exner and theta, and the qv_prev / t_prev history with its
    first-step sentinel t_prev = 0."""
    rho = rho_d + rho_c + rho_r + rho_i + rho_v
    rho_v, rho_c, temp = adjusted_state(rho, rho_d, rho_v, rho_c, temp)
    inv_rd = 1.0 / rho_d
    q = [a * inv_rd for a in (rho_c, rho_nc, rho_r, rho_nr, rho_i, rho_ni,
                              rho_m, rho_bm, rho_v)]
    pressure = R_D * rho_d * temp + R_V * rho_v * temp
    exner = (pressure / P0) ** (R_D / CP_D)
    first = t_prev_f <= 0.0
    return (*q, temp / exner, exner, pressure, _w(first, q[8], qv_prev_f),
            _w(first, temp, t_prev_f))

"""P3-class ice microphysics.

Port of ``miniweatherml_tpu/physics/p3.py`` (reference
model/modules/microphysics_p3.h + the vendored SCREAM P3 v4.1.1 Fortran,
micro_p3.F90): the whole scheme as vectorized PyTorch over every column at
once.  The process list, tiers and reference citations are those of the JAX
module's docstring; this module keeps its structure and names.

Execution: the long per-cell phases (part1 + in-cloud values, the table
tier's rates before and after the lookups, the conservation/update pass,
and the wrapper's inputs with the saturation Newton) are plain functions
here and run through ``p3_cellwise_cuda``, which launches one fused CUDA
kernel per phase on CUDA tensors.  Table lookups go through
``p3_tables.interp_*_multi`` (CUDA kernels on CUDA tensors).  The presence
gates the JAX package wrote as ``lax.cond(jnp.any(...))`` are 0-d device
booleans the lookups read (the rates_pre phase sets them); no gate reads
the device from the host.  Sedimentation runs through ``p3_sed_cuda``: on
CUDA tensors one kernel computes every cell's fall speeds once, takes their
maximum and makes one sub-step of the fall (``sed_step``), and a second
reruns the whole sub-cycle loop per column, with the count ``nsub`` read on
the device (the JAX package's ``lax.while_loop``), only where that count is
above 1, so a P3 step makes no host read; its plain versions loop in Python
over ``nsub`` read to the host.  The [approx] tier's rates, freezing and
part3 are plain tensor code.

Every division of a tensor by a number (or of a number by a tensor) in the
per-cell phases goes through ``exact_div``: PyTorch would multiply by a
reciprocal there, the CUDA kernels divide, and the two must do the same IEEE
operations.  Integer powers are written as products (``lax.integer_pow``);
the JAX package's ``_cbrt_pos`` sites use ``pow(x, 1/3)`` and its
``jnp.cbrt`` sites use ``p3_tables.cbrt``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.coupler import CouplerState
from ..ops.exact_div import exact_div
from ..parallel.collectives import host_ints, pmax, pmin
from ..utils.profiling import count_device, span
from .p3_tables import (F1R, F2R, MU_R, P3Tables, cbrt,
                        default_table_path, ice_table_indices,
                        interp_collect_multi, interp_ice_multi,
                        interp_rain_multi, load_p3_tables,
                        rain_collection_index, rain_size_index)

__all__ = ["MicrophysicsP3", "compute_adjusted_state", "p3_scheme",
           "p3_wrapper_inputs"]

# -- constants (reference microphysics_p3.h:74-88, micro_p3_utils.F90) -----
R_D = 287.042
CP_D = 1004.64
R_V = 461.505
CP_V = 1859.0
P0 = 1.0e5
GRAV = 9.80616
CP_L = 4188.0
RHO_H2O = 1000.0
LATVAP = 2501000.0
LATICE = 333700.0
TMELT = 273.15
QSMALL = 1.0e-14      # micro_p3_utils.F90:18
NSMALL = 1.0e-16      # micro_p3_utils.F90:19
NCCNST = 200.0e6      # prescribed droplet number (micro_p3_utils.F90:115)
# 1/(cons2 * (25e-6)^3), cons2 = 4*pi/3*rho_h2o: new raindrops are 25 um
# (micro_p3_utils.F90:174-175)
CONS3 = 1.0 / (4.0 * math.pi / 3.0 * RHO_H2O * 25.0e-6 ** 3)
T_HOMOGFRZ = TMELT - 40.0   # homogeneous freezing (micro_p3_utils.F90:123)
MAX_TOTAL_NI = 500.0e3      # max ice number, m^-3 (micro_p3_utils.F90:112)
RHO_RIMEMIN = 50.0          # bulk rime density bounds
RHO_RIMEMAX = 900.0         # (micro_p3_utils.F90:151-153)
# ratio of molecular masses of water and dry air (micro_p3_utils.F90:133)
EP_2 = 18.016 / 28.966

# Magnus liquid-svp constants, shared by saturation_vapor_pressure and the
# Newton solver's analytic derivative (which must stay in lockstep).
_MAGNUS_A = 17.625
_MAGNUS_B = 243.04
_CONS1 = math.pi / 6.0 * RHO_H2O
_INCLD_LIM, _PRECIP_LIM = 5.1e-3, 1.0e-2


def _max(x, v):
    return torch.clamp(x, min=v)


def _min(x, v):
    return torch.clamp(x, max=v)


def _where0(cond, x):
    return torch.where(cond, x, 0.0)


def saturation_vapor_pressure(temp):
    """Liquid svp, Magnus form: the wrapper's own svp, used only by the
    saturation pre-adjustment (reference microphysics_p3.h:446-449)."""
    tc = temp - 273.15
    return 610.94 * torch.exp(_MAGNUS_A * tc / (_MAGNUS_B + tc))


def _magnus_dsvp_dT(svp, temp):
    """d(svp)/dT of the Magnus form, from its own output."""
    tc = temp - 273.15
    return svp * (_MAGNUS_A * _MAGNUS_B) / ((_MAGNUS_B + tc)
                                            * (_MAGNUS_B + tc))


def saturation_vapor_pressure_ice(temp):
    """Ice svp, Magnus form (wrapper-tier companion of the above)."""
    tc = temp - 273.15
    return 611.21 * torch.exp(22.587 * tc / (273.86 + tc))


def _murphy_koop_svp_liq(t):
    """Murphy & Koop (2005) liquid saturation vapor pressure [Pa]
    (wv_sat_scream.F90 MurphyKoop_svp)."""
    logt = torch.log(t)
    return torch.exp(54.842763 - exact_div(6763.22, t) - 4.210 * logt
                     + 0.000367 * t
                     + torch.tanh(0.0415 * (t - 218.8))
                     * (53.878 - exact_div(1331.22, t) - 9.44523 * logt
                        + 0.014025 * t))


def _murphy_koop_svp_ice(t):
    """Murphy & Koop (2005) ice svp below freezing, the liquid form at
    T >= 0 C (wv_sat_scream.F90:96-107)."""
    logt = torch.log(t)
    e_ice = torch.exp(9.550426 - exact_div(5723.265, t) + 3.53068 * logt
                      - 0.00728332 * t)
    return torch.where(t < TMELT, e_ice, _murphy_koop_svp_liq(t))


def p3_qv_sat_liq(t, pres):
    """Saturation mixing ratio over liquid, wv_sat_scream qv_sat(t, p, 0):
    ep_2 * e / max(1e-3, p - e)."""
    e = _murphy_koop_svp_liq(t)
    return EP_2 * e / _max(pres - e, 1.0e-3)


def p3_qv_sat_ice(t, pres):
    """Saturation mixing ratio over ice, qv_sat(t, p, 1)."""
    e = _murphy_koop_svp_ice(t)
    return EP_2 * e / _max(pres - e, 1.0e-3)


def latent_heat_condensation(temp):
    """(reference microphysics_p3.h:452-455)"""
    tc = temp - 273.15
    return (2500.8 - 2.36 * tc + 0.0016 * tc * tc
            - 0.00006 * tc * tc * tc) * 1000.0


def _cp_moist(rho_d, rho_v, rho_c):
    """(reference microphysics_p3.h:458-462)"""
    rho = rho_d + rho_v + rho_c
    return (rho_d * CP_D + rho_v * CP_V + rho_c * CP_L) / rho


def compute_adjusted_state(rho, rho_d, rho_v, rho_c, temp,
                           iters: int | None = None):
    """Instantaneous saturation adjustment (reference
    microphysics_p3.h:467-550): supersaturated cells condense, subsaturated
    cells with cloud evaporate, until the post-transfer vapor pressure meets
    the post-transfer saturation pressure.

    The default is a bracket-guarded Newton iteration on the transferred
    mass x (a seed step from x = 0, then 10 steps in f64 or 7 in f32, plus
    one, keeping the best iterate), with an exact check of the boundary
    root x = -rho_c.  ``iters`` selects the reference's bisection with that
    many halvings.  Returns (rho_v, rho_c, temp).  See the JAX function for
    the derivation."""
    svp = saturation_vapor_pressure(temp)
    pv = rho_v * R_V * temp
    condensing = pv > svp
    evaporating = (pv < svp) & (rho_c > 0.0)
    Lv = latent_heat_condensation(temp)
    zero = 0.0

    if iters is not None:
        lo = torch.where(condensing, zero, torch.where(evaporating, -rho_c,
                                                       zero))
        hi = torch.where(condensing, rho_v, zero)
        for _ in range(iters):
            x = 0.5 * (lo + hi)
            rv = _max(rho_v - x, 0.0)
            rc = _max(rho_c + x, 0.0)
            cp = _cp_moist(rho_d, rv, rc)
            t_loc = temp + x * Lv / (rho * cp)
            super_sat = rv * R_V * t_loc > saturation_vapor_pressure(t_loc)
            lo, hi = (torch.where(super_sat, x, lo),
                      torch.where(super_sat, hi, x))
        x = 0.5 * (lo + hi)
    else:
        n_newton = 10 if temp.dtype == torch.float64 else 7
        lo = torch.where(condensing, zero, -rho_c)
        hi = torch.where(condensing, rho_v, zero)
        rho_t = rho_d + rho_v + rho_c
        cp0 = (rho_d * CP_D + rho_v * CP_V + rho_c * CP_L) / rho_t
        dcp = exact_div(CP_L - CP_V, rho_t)

        # seed: one Newton step from x = 0 on the svp already computed
        f0 = pv - svp
        dtdx0 = Lv / (rho * cp0)
        dsvp0 = _magnus_dsvp_dT(svp, temp)
        fp0 = -R_V * temp + rho_v * R_V * dtdx0 - dsvp0 * dtdx0
        x1 = -f0 / _min(fp0, -1e-30)
        x = torch.where((fp0 < 0.0) & (x1 >= lo) & (x1 <= hi), x1,
                        0.5 * (lo + hi))
        xb = x
        fb = torch.full_like(x, math.inf)
        for _ in range(n_newton + 1):
            rv = rho_v - x
            cp = cp0 + x * dcp
            dtdx_lin = Lv / (rho * cp)
            t_loc = temp + x * dtdx_lin
            svp_loc = saturation_vapor_pressure(t_loc)
            f = rv * R_V * t_loc - svp_loc
            # the answer is the best iterate ever visited
            absf = torch.abs(f)
            better = absf < fb
            xb = torch.where(better, x, xb)
            fb = torch.where(better, absf, fb)
            pos = f > 0.0
            lo = torch.where(pos, x, lo)
            hi = torch.where(pos, hi, x)
            dtdx = dtdx_lin * (1.0 - x * dcp / cp)
            dsvp = _magnus_dsvp_dT(svp_loc, t_loc)
            fp = -R_V * t_loc + rv * R_V * dtdx - dsvp * dtdx
            xn = x - f / fp
            inb = (xn >= lo) & (xn <= hi)
            x = torch.where(inb, xn, 0.5 * (lo + hi))
        x = xb

        # boundary root: still subsaturated after all cloud evaporates
        cp_lo = cp0 - rho_c * dcp
        t_lo = temp - rho_c * Lv / (rho * cp_lo)
        f_lo = (rho_v + rho_c) * R_V * t_lo - saturation_vapor_pressure(t_lo)
        x = torch.where(evaporating & (f_lo <= 0.0), -rho_c, x)

    x = torch.where(condensing | evaporating, x, zero)
    rv = _max(rho_v - x, 0.0)
    rc = _max(rho_c + x, 0.0)
    cp = _cp_moist(rho_d, rv, rc)
    return rv, rc, temp + x * Lv / (rho * cp)


def _bulk_rho_rime(qi_, qm_, bm_):
    """calc_bulkRhoRime (micro_p3.F90:1897-1943): (qm, bm, rho_rime) with
    the bulk rime density bounded to [50, 900] (bm adjusted), qm capped at
    qi, tiny rime zeroed; rho_rime is 0 where bm < 1e-15."""
    has = bm_ >= 1.0e-15
    rr = _where0(has, torch.clamp(qm_ / _max(bm_, 1e-30), RHO_RIMEMIN,
                                  RHO_RIMEMAX))
    bm2 = _where0(has, qm_ / _max(rr, RHO_RIMEMIN))
    qm2 = _where0(has, qm_)
    over = (qm2 > qi_) & (rr > 0.0)
    qm2 = torch.where(over, qi_, qm2)
    bm2 = torch.where(over, qm2 / _max(rr, RHO_RIMEMIN), bm2)
    keep = ~(qm2 < QSMALL)
    return _where0(keep, qm2), _where0(keep, bm2), rr


def _conserve(avail, dt, *sinks):
    """Rescale sink tendencies so their dt-integral cannot exceed
    ``avail`` (the reference's *_conservation subroutines)."""
    total = sum(sinks) * dt
    ratio = torch.where(total > avail, avail / _max(total, 1e-300), 1.0)
    return [s * ratio for s in sinks]


def _cbrt_pos(x):
    """Cube root of a positive argument via pow (the JAX module's form)."""
    return x ** (1.0 / 3.0)


def _cap_ni(ni_, inv_rho):
    """Cap total ice number at MAX_TOTAL_NI m^-3 (impose_max_total_ni,
    micro_p3.F90:1947-1969)."""
    dum = MAX_TOTAL_NI * inv_rho / _max(ni_, 1e-20)
    return torch.where(ni_ >= 1e-20, ni_ * _min(dum, 1.0), ni_)


def _rain_dsd2(qr_, nr_):
    """get_rain_dsd2's lambda limiter on nr (micro_p3.F90:1841-1893,
    mu_r = 1).  Returns (nr adjusted, lamr after the clip)."""
    nr1 = _max(nr_, NSMALL)
    lamr = _cbrt_pos(_CONS1 * nr1 * 24.0 / _max(qr_, QSMALL))
    lamr_cl = torch.clamp(lamr, 2.0 * 500.0, 2.0 * 1.0e5)
    nr_lim = torch.where(lamr != lamr_cl,
                         exact_div(lamr_cl * lamr_cl * lamr_cl * qr_,
                                   24.0 * _CONS1), nr1)
    return torch.where(qr_ >= QSMALL, nr_lim, nr_), lamr_cl


def _cloud_mu(nc_, rho):
    s_ = 0.0005714 * (nc_ * 1.0e-6 * rho) + 0.2714
    return torch.clamp(exact_div(1.0, s_ * s_) - 1.0, 2.0, 15.0)


def _cloud_dsd2(qc_, nc_, rho):
    """get_cloud_dsd2's lambda limiter on nc (micro_p3.F90:1774-1837).
    Returns (nc adjusted, mu_c, lamc after the clip)."""
    nc1 = _max(nc_, NSMALL)
    mu_ = _cloud_mu(nc1, rho)
    mval_ = (mu_ + 3.0) * (mu_ + 2.0) * (mu_ + 1.0)
    lamc = _cbrt_pos(_CONS1 * nc1 * mval_ / _max(qc_, QSMALL))
    lamc_cl = torch.clamp(lamc, (mu_ + 1.0) * 2.5e4, (mu_ + 1.0) * 1.0e6)
    nc_lim = torch.where(lamc != lamc_cl,
                         lamc_cl * lamc_cl * lamc_cl * qc_ / (_CONS1 * mval_),
                         nc1)
    return torch.where(qc_ >= QSMALL, nc_lim, nc_), mu_, lamc_cl


def _p3_part1_cellwise(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                       pres, rho, *, do_predict_nc: bool):
    """p3_main_part1 + in-cloud mixing ratios + part2's pre-process DSD
    writebacks, per cell (micro_p3.F90:363-481, :588-595, :626-637;
    calculate_incloud_mixingratios, micro_p3_utils.F90:238-292).  The
    plain version of the ``part1`` phase of ``csrc/p3_cellwise.cu``.
    Returns (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, skip_mask,
    qc_in, qr_in, qi_in, qm_in, bm_in, nc_in, nr_in, ni_in, mu_cd)."""
    Lv, Ls, Lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D
    inv_rho = exact_div(1.0, rho)
    temp = theta * exner
    cpx = cp * exner

    # part1 tiny-mass clips (:363-481); T refreshed after them (:477)
    qv_si0 = p3_qv_sat_ice(temp, pres)
    sup_i0 = qv / _max(qv_si0, QSMALL) - 1.0
    small_c1 = qc < QSMALL
    qv = qv + _where0(small_c1, qc)
    theta = theta - _where0(small_c1, qc) * Lv / cpx
    qc = _where0(~small_c1, qc)
    if do_predict_nc:
        nc = _where0(~small_c1, _max(nc, 0.0))
    else:
        # prescribed droplet number (microphysics_p3.h:314; :436)
        nc = _where0(~small_c1, NCCNST * inv_rho)
    small_r1 = qr < QSMALL
    qv = qv + _where0(small_r1, qr)
    theta = theta - _where0(small_r1, qr) * Lv / cpx
    qr = _where0(~small_r1, qr)
    nr = _where0(~small_r1, nr)
    # tiny qi, or small qi in strongly ice-subsaturated air (:445-455)
    small_i1 = (qi < QSMALL) | ((qi < 1.0e-8) & (sup_i0 < -0.1))
    qv = qv + _where0(small_i1, qi)
    theta = theta - _where0(small_i1, qi) * Ls / cpx
    qi, ni, qm, bm = (_where0(~small_i1, a) for a in (qi, ni, qm, bm))
    # tiny warm ice melts instantly to rain (:457-465)
    melt1 = (qi >= QSMALL) & (qi < 1.0e-8) & (temp >= TMELT)
    qr = qr + _where0(melt1, qi)
    theta = theta - _where0(melt1, qi) * Lf / cpx
    qi, ni, qm, bm = (_where0(~melt1, a) for a in (qi, ni, qm, bm))
    temp = theta * exner

    # part2's level skip (:588-595)
    skip_mask = ((qc < QSMALL) & (qr < QSMALL) & (qi < QSMALL)
                 & (temp < TMELT) & (sup_i0 < -0.05)).to(qc.dtype)

    # in-cloud values with the reference's magnitude caps
    qc_in = _where0(qc >= QSMALL, _min(qc, _INCLD_LIM))
    qr_in = _where0(qr >= QSMALL, _min(qr, _PRECIP_LIM))
    qi_in = _where0(qi >= QSMALL, _min(qi, _INCLD_LIM))
    has_qm = (qm >= QSMALL) & (qi >= QSMALL)
    qm_in = _where0(has_qm, qm)
    bm_in = _where0(has_qm, _min(_max(bm, 0.0), _INCLD_LIM))

    # part2's pre-process DSD limiting (:626, :630); persists to nc/nr
    nc = _cloud_dsd2(qc_in, nc, rho)[0]
    nr = _rain_dsd2(qr_in, nr)[0]
    nc_in = _where0(qc >= QSMALL, _max(nc, 0.0))
    nr_in = _where0(qr >= QSMALL, _max(nr, 0.0))
    # impose_max_total_ni on the in-cloud ni only (:637)
    ni_in = _cap_ni(_where0(qi >= QSMALL, _max(ni, 0.0)), inv_rho)
    mu_cd = _cloud_mu(_max(nc, NSMALL), rho)
    return (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, skip_mask,
            qc_in, qr_in, qi_in, qm_in, bm_in, nc_in, nr_in, ni_in, mu_cd)


def _p3_update_cellwise(dt, au, ac, qc_frz, nc_frz, qr_frz, nr_frz, rim,
                        shed, ncshdc, berg, dep, sub, ev, melt, qinuc,
                        ninuc, qrcol, nr_col, nr_self, ni_self, nr_shed_wg,
                        rho_rime, wg_mask, qc_in, nc_in, qr_in, nr_in,
                        qi_in, ni_rate, qc, nc, qr, nr, qi, ni, qm, bm,
                        qv, theta, exner, inv_rho, temp, qv_si, pres,
                        skip_mask, *, do_predict_nc: bool):
    """Conservation rescaling -> prognostic update -> end-of-part2 clip,
    per cell (micro_p3.F90:2957-3266 + :893-925).  The plain version of the
    ``update`` phase of ``csrc/p3_cellwise.cu``.  ``dt``: a number;
    ``wg_mask``/``skip_mask``: the wet-growth and level-skip booleans as
    0/1 floats.  Returns (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)."""
    Lv, Ls, Lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D
    log_wg = wg_mask > 0.5
    skip_lvl = skip_mask > 0.5
    one = 1.0

    # droplet-number tendencies (iparam=3 / KK2000)
    inv_qc = exact_div(1.0, _max(qc_in, QSMALL))
    nc2nr_auto = au * nc_in * inv_qc
    nc_accret = ac * nc_in * inv_qc
    nc_collect = (rim + shed) * nc_in * inv_qc
    ncautr = au * CONS3
    # number rates tied to mass rates, before the mass rescalings
    ni2nr_melt = melt * ni_rate / _max(qi_in, QSMALL)
    ni_sub_n = sub * ni_rate / _max(qi_in, QSMALL)
    nr_evap = ev * nr_in / _max(qr_in, QSMALL)

    # cloud water: sinks scaled; dep/sub only for the liquid-free remainder
    # of the step (Wegener-Bergeron-Findeisen split, :3051-3058)
    sinks_qc = (au + ac + qc_frz + rim + shed + berg) * dt
    ratio_qc = torch.where((sinks_qc > qc) & (sinks_qc >= 1.0e-20),
                           qc / _max(sinks_qc, 1e-30), one)
    au, ac, qc_frz, rim, shed, berg = (
        t * ratio_qc for t in (au, ac, qc_frz, rim, shed, berg))
    liq = qc > 1.0e-20
    dep = torch.where(liq, dep * (1.0 - ratio_qc), dep)
    sub = torch.where(liq, sub * (1.0 - ratio_qc), sub)

    # rain: sinks vs qr + sources (:3063-3082)
    sinks_qr = (ev + qrcol + qr_frz) * dt
    sources_qr = qr + (au + ac + melt + shed) * dt
    ratio_qr = torch.where((sinks_qr > sources_qr) & (sinks_qr >= 1.0e-20),
                           sources_qr / _max(sinks_qr, 1e-30), one)
    ev, qrcol, qr_frz = (t * ratio_qr for t in (ev, qrcol, qr_frz))

    # ice: sinks vs qi + sources (:3084-3106)
    sinks_qi = (sub + melt) * dt
    sources_qi = qi + (dep + qinuc + berg + qrcol + rim + qr_frz
                       + qc_frz) * dt
    ratio_qi = torch.where((sinks_qi > sources_qi) & (sinks_qi >= 1.0e-20),
                           sources_qi / _max(sinks_qi, 1e-30), one)
    sub, melt = sub * ratio_qi, melt * ratio_qi

    # ice_supersat_conservation (:2856-2886)
    qv_avail = _max((qv + (sub + ev) * dt - qv_si)
                    / (1.0 + Ls * Ls * qv_si / (cp * R_V * temp * temp)),
                    0.0)
    dep_l, qinuc_l = _conserve(qv_avail, dt, dep, qinuc)
    scale_isc = dep + qinuc > QSMALL
    dep = torch.where(scale_isc, dep_l, dep)
    qinuc = torch.where(scale_isc, qinuc_l, qinuc)

    # number conservations (:2957-3007)
    sinks_nc = (nc_collect + nc_frz + nc_accret + nc2nr_auto) * dt
    ratio_nc = torch.where(sinks_nc > nc, nc / _max(sinks_nc, 1e-30), one)
    nc_collect, nc_frz, nc_accret, nc2nr_auto = (
        t * ratio_nc for t in (nc_collect, nc_frz, nc_accret, nc2nr_auto))
    sinks_nr = (nr_col + nr_frz + nr_self + nr_evap) * dt
    sources_nr = nr + (ni2nr_melt + nr_shed_wg + ncshdc + nc2nr_auto) * dt
    ratio_nr = torch.where(sinks_nr > sources_nr,
                           sources_nr / _max(sinks_nr, 1e-30), one)
    nr_col, nr_frz, nr_self, nr_evap = (
        t * ratio_nr for t in (nr_col, nr_frz, nr_self, nr_evap))
    sinks_ni = (ni2nr_melt + ni_sub_n + ni_self) * dt
    sources_ni = ni + (ninuc + nr_frz + nc_frz) * dt
    ratio_ni = torch.where(sinks_ni > sources_ni,
                           sources_ni / _max(sinks_ni, 1e-30), one)
    ni2nr_melt, ni_sub_n, ni_self = (
        t * ratio_ni for t in (ni2nr_melt, ni_sub_n, ni_self))

    # prevent_liq_supersaturation (:2888-2955)
    qv_sources = sub + ev
    qv_sinks_plq = dep + qinuc
    t_end = temp + (exact_div((qv_sinks_plq - sub) * Ls, cp)
                    - exact_div(ev * Lv, cp)) * dt
    qsl_end = p3_qv_sat_liq(t_end, pres)
    A_plq = (exact_div(Lv * qsl_end * dt, cp) / (R_V * t_end * t_end)
             * (Ls * sub + Lv * ev))
    floor = 1e-300 if qv.dtype == torch.float64 else 1e-35
    frac_plq = ((qsl_end - qv + qv_sinks_plq * dt + A_plq)
                / _max(qv_sources * dt + A_plq, floor))
    frac_plq = torch.clamp(frac_plq, 0.0, 1.0)
    frac_plq = _where0(~(qv_sources < QSMALL), frac_plq)
    sub = sub * frac_plq
    ev = ev * frac_plq

    # apply the process tendencies (:3108-3266)
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
                        - (melt + sub) * qm / _max(qi, QSMALL))
    bm_new = bm + dt * (rim / rho_rime
                        + exact_div(qr_frz + qrcol + qc_frz, 900.0)
                        - (melt + sub) * bm / _max(qi, QSMALL))
    # negative rime zeroes qm and bm; wet growth densifies (:3188-3200)
    neg_qm = qm_new < 0.0
    qm_new = _where0(~neg_qm, qm_new)
    bm_new = _where0(~neg_qm, bm_new)
    qm_new = torch.where(log_wg, qi_new, qm_new)
    bm_new = torch.where(log_wg, exact_div(qi_new, 900.0), bm_new)
    if do_predict_nc:
        nc = _max(nc + dt * (-nc_accret - nc2nr_auto - nc_collect - nc_frz),
                  0.0)
    else:
        # prescribed droplet number re-imposed at end of part2 (:3241)
        nc = torch.where(skip_lvl, nc, NCCNST * inv_rho)
    qc, qr, qi, qv = qc_new, qr_new, qi_new, qv_new
    nr, ni, qm, bm = nr_new, ni_new, qm_new, bm_new
    cpx = cp * exner
    theta = theta + exact_div(dt, cpx) * (
        Lv * (-ev) + Ls * (dep + qinuc - sub)
        + Lf * (qc_frz + qr_frz + qrcol + rim + berg - melt))
    qc, qr, qi, qv, nr, ni = (_max(a, 0.0) for a in (qc, qr, qi, qv, nr, ni))

    # end-of-part2 clipping (:893-925)
    tiny_c2 = qc < QSMALL
    qv = qv + _where0(tiny_c2, qc)
    theta = theta - _where0(tiny_c2, qc * Lv / cpx)
    qc = _where0(~tiny_c2, qc)
    nc = _where0(~tiny_c2, nc)
    tiny_r2 = qr < QSMALL
    qv = qv + _where0(tiny_r2, qr)
    theta = theta - _where0(tiny_r2, qr * Lv / cpx)
    qr = _where0(~tiny_r2, qr)
    nr = _where0(~tiny_r2, nr)
    tiny_i2 = qi < QSMALL
    qv = qv + _where0(tiny_i2, qi)
    theta = theta - _where0(tiny_i2, qi * Ls / cpx)
    qi, ni, qm, bm = (_where0(~tiny_i2, a) for a in (qi, ni, qm, bm))
    ni = _cap_ni(ni, inv_rho)
    return (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)


def _p3_wrapper_inputs_cellwise(rho_d, temp, rho_c, rho_nc, rho_r, rho_nr,
                                rho_i, rho_ni, rho_m, rho_bm, rho_v,
                                qv_prev_f, t_prev_f):
    """Per-cell body of ``p3_wrapper_inputs`` (microphysics_p3.h:273-301),
    saturation Newton included.  The plain version of the ``wrapper``
    phase of ``csrc/p3_cellwise.cu``.  Returns (qc, nc, qr, nr, qi, ni, qm,
    bm, qv, theta, exner, pressure, qv_prev, t_prev)."""
    rho = rho_d + rho_c + rho_r + rho_i + rho_v
    rho_v, rho_c, temp = compute_adjusted_state(rho, rho_d, rho_v, rho_c,
                                                temp)
    inv_rd = exact_div(1.0, rho_d)
    qc, nc = rho_c * inv_rd, rho_nc * inv_rd
    qr, nr = rho_r * inv_rd, rho_nr * inv_rd
    qi, ni = rho_i * inv_rd, rho_ni * inv_rd
    qm, bm = rho_m * inv_rd, rho_bm * inv_rd
    qv = rho_v * inv_rd
    pressure = R_D * rho_d * temp + R_V * rho_v * temp
    exner = exact_div(pressure, P0) ** (R_D / CP_D)
    theta = temp / exner
    # t_prev starts at 0: the reference's first_step sentinel (:297-301)
    first = t_prev_f <= 0.0
    qv_prev = torch.where(first, qv, qv_prev_f)
    t_prev = torch.where(first, temp, t_prev_f)
    return (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pressure,
            qv_prev, t_prev)


def _mu_visc(temp):
    """Dynamic viscosity of air (micro_p3.F90:3564)."""
    return 1.496e-6 * temp ** 1.5 / (temp + 120.0)


def _cloud_lamc(qc_, nc_, mu_):
    """get_cloud_dsd2's clipped lambda for a given mu_c."""
    lamc = _cbrt_pos(_CONS1 * _max(nc_, NSMALL) * (mu_ + 3.0)
                     * (mu_ + 2.0) * (mu_ + 1.0) / _max(qc_, QSMALL))
    return torch.clamp(lamc, (mu_ + 1.0) * 2.5e4, (mu_ + 1.0) * 1.0e6)


def _cloud_vt(qc_, nc_, rho, acn):
    """(V_qc, lamc, mu_c) of the current (qc, nc): the Stokes mass-weighted
    droplet fall speed (cloud_sedimentation, micro_p3.F90:3685-3688, bcn =
    2; acn at :3613)."""
    mu_ = _cloud_mu(nc_, rho)
    lamc = _cloud_lamc(qc_, nc_, mu_)
    v = acn * torch.exp(torch.lgamma(mu_ + 6.0)
                        - torch.lgamma(mu_ + 4.0)) / (lamc * lamc)
    return _where0(qc_ >= QSMALL, v), lamc, mu_


def _stokes_acn(mu_visc):
    """The Stokes fall-speed coefficient acn (micro_p3.F90:3613)."""
    return 9.80616 * RHO_H2O / (18.0 * mu_visc)


_RHO_600MB = 60000.0 / (287.042 * 253.15)
_RHO_1000MB = 100000.0 / (287.042 * 273.15)


def _p3_warm_ice_rates(dt, qc, nc, qr, ni, qv, temp, pres, rho, inv_rho,
                       qc_in, qr_in, nc_in, nr_in, mu_cd):
    """The rates both tiers share: warm rain (KK2000 autoconversion and
    accretion, rain self-collection), saturation, Cooper nucleation and
    Bigg immersion freezing (micro_p3.F90:2504-2618).  Returns (au, ac,
    nr_self, qsl, tc, qv_si, sup_i, qinuc, ninuc, qc_frz, nc_frz, qr_frz,
    nr_frz)."""
    pi = math.pi
    au = _where0(qc_in >= 1.0e-8,
                 1350.0 * _max(qc_in, QSMALL) ** 2.47
                 * _max(nc_in * 1.0e-6 * rho, NSMALL) ** (-1.79))
    both = (qc >= QSMALL) & (qr >= QSMALL)
    ac = _where0(both, 67.0 * _max(qc_in * qr_in, 1e-300) ** 1.15)
    dm_r = cbrt(_max(qr_in, QSMALL) / (pi * RHO_H2O * _max(nr_in, NSMALL)))
    brk = torch.where(dm_r < 280.0e-6, 1.0,
                      2.0 - torch.exp(2300.0 * (dm_r - 280.0e-6)))
    nr_self = _where0(qr >= QSMALL, brk * 5.78 * nr_in * qr_in * rho)

    qsl = p3_qv_sat_liq(temp, pres)
    tc = temp - TMELT
    qv_si = p3_qv_sat_ice(temp, pres)
    sup_i = qv / _max(qv_si, QSMALL) - 1.0

    # ice nucleation, Cooper 1986 (ice_nucleation, micro_p3.F90:2576-2618)
    mi0 = 4.0 * pi / 3.0 * 900.0 * 1.0e-18
    n_coop = torch.minimum(
        0.005 * torch.exp(0.304 * _max(-tc, 0.0)) * 1.0e3 * inv_rho,
        100.0e3 * inv_rho)
    n_nuc = exact_div(_max(n_coop - ni, 0.0), dt)
    nucleate = (tc < -15.0) & (sup_i >= 0.05) & (n_nuc >= 1.0e-20)
    qinuc = _where0(nucleate, n_nuc * mi0)
    ninuc = _where0(nucleate, n_nuc)

    # immersion freezing of cloud and rain, Bigg 1953 (:2504-2573)
    aimm, bimm = 0.65, 2.0
    cons5 = pi / 6.0 * bimm
    cons6 = (pi / 6.0) ** 2 * RHO_H2O * bimm
    dum1_frz = torch.exp(aimm * _min(-tc, 40.0))
    frz_gate_c = (qc >= QSMALL) & (tc <= -4.0)
    lamc_frz = _cloud_lamc(qc_in, nc, mu_cd)
    cdist1_c = _max(nc_in, NSMALL) * torch.exp(-torch.lgamma(mu_cd + 1.0))
    l2 = lamc_frz * lamc_frz
    qc_frz = _where0(frz_gate_c, cons6 * cdist1_c
                     * torch.exp(torch.lgamma(7.0 + mu_cd)) * dum1_frz
                     / (l2 * (l2 * l2)))
    nc_frz = _where0(frz_gate_c, cons5 * cdist1_c
                     * torch.exp(torch.lgamma(4.0 + mu_cd)) * dum1_frz
                     / (lamc_frz * l2))
    frz_gate_r = (qr >= QSMALL) & (tc <= -4.0)
    lamr_frz = cbrt(pi / 6.0 * RHO_H2O * 24.0 * _max(nr_in, NSMALL)
                    / _max(qr_in, QSMALL))
    l2 = lamr_frz * lamr_frz
    qr_frz = _where0(frz_gate_r, cons6 * _max(nr_in, NSMALL) * 5040.0
                     * dum1_frz / (l2 * (l2 * l2)))
    nr_frz = _where0(frz_gate_r, cons5 * _max(nr_in, NSMALL) * 24.0
                     * dum1_frz / (lamr_frz * l2))
    return (au, ac, nr_self, qsl, tc, qv_si, sup_i, qinuc, ninuc, qc_frz,
            nc_frz, qr_frz, nr_frz)


def _p3_rates_pre_cellwise(qi, qr, qm, bm, qi_in, qm_in, bm_in, ni_in, qr_in,
                           nr_in):
    """What the table tier's lookups need, per cell: calc_bulkRhoRime's
    re-bounds of the in-cloud rime, persisted to qm/bm where there is ice
    (micro_p3.F90:1897-1943, :633), and the three index sets -- ice
    (find_lookupTable_indices_1a), ice-rain collection (_1b) and rain size
    (_3).  The plain version of the ``rates_pre`` phase of
    ``csrc/p3_cellwise.cu``.  Returns (qm, bm, i0, fi, ii0, fii, jj0, fjj,
    j0, fj, i0r, fir, present): indices int32, and ``present`` a (3,) bool
    tensor -- any ice, any ice with rain, any rain -- the lookups' presence
    gates."""
    qm_reb, bm_reb, rho_rime_raw = _bulk_rho_rime(qi_in, qm_in, bm_in)
    has_qi = qi >= QSMALL
    has_qr = qr >= QSMALL
    qm = torch.where(has_qi, qm_reb, qm)
    bm = torch.where(has_qi, bm_reb, bm)
    idx = ice_table_indices(qi_in, _max(ni_in, NSMALL), qm_reb, rho_rime_raw)
    j0, fj = rain_collection_index(qr_in, _max(nr_in, NSMALL))
    lamr = cbrt(math.pi / 6.0 * RHO_H2O * 24.0 * _max(nr_in, NSMALL)
                / _max(qr_in, QSMALL))
    i0r, fir = rain_size_index((MU_R + 1.0) / lamr)
    present = torch.stack([has_qi.any(), (has_qi & has_qr).any(),
                           has_qr.any()])
    return (qm, bm, *idx, j0, fj, i0r, fir, present)


def _p3_rates_post_cellwise(dt, qc, nc, qr, qi, ni, qv, temp, pres, rho,
                            qc_in, qr_in, qi_in, qm_in, bm_in, nc_in, nr_in,
                            ni_in, mu_cd, qv_prev, t_prev, tab7, tab8, tab4,
                            tab2, tab3, tab5, tab10, coll2, coll1, revap_v):
    """Every process rate of the table tier (micro_p3.F90 part2,
    :2054-2490, :3269-3537), per cell, given part1's state and in-cloud
    values, the wrapper's qv/T history and the ten lookup values (ice
    columns 7, 8, 4, 2, 3, 5, 10; collection 2, 1; the rain evaporation
    row).  The plain version of the ``rates_post`` phase of
    ``csrc/p3_cellwise.cu``.  ``dt``: a number.  Returns the update's 25
    rate inputs: (au, ac, qc_frz, nc_frz, qr_frz, nr_frz, rim, shed, ncshdc,
    berg, dep, sub, ev, melt, qinuc, ninuc, qrcol, nr_col, nr_self,
    ni_self, nr_shed_wg, rho_rime, wg_mask, ni_rate, qv_si)."""
    Lv, Ls, Lf = LATVAP, LATVAP + LATICE, LATICE
    pi = math.pi
    inv_rho = 1.0 / rho
    (au, ac, nr_self, qsl, tc, qv_si, _, qinuc, ninuc, qc_frz, nc_frz,
     qr_frz, nr_frz) = _p3_warm_ice_rates(
        dt, qc, nc, qr, ni, qv, temp, pres, rho, inv_rho, qc_in, qr_in,
        nc_in, nr_in, mu_cd)
    mu_visc = _mu_visc(temp)
    acn = _stokes_acn(mu_visc)
    qm_reb = _bulk_rho_rime(qi_in, qm_in, bm_in)[0]
    has_qi = qi >= QSMALL

    # part2's ni lambda limiter on the in-cloud ni (:662-678)
    ni_t = _max(ni_in, NSMALL)
    ni_t = torch.minimum(ni_t, tab7 * ni_t)
    ni_t = torch.maximum(ni_t, tab8 * ni_t)
    ni_rate = torch.where(has_qi, ni_t, ni_in)
    rhofaci = (_RHO_600MB * inv_rho) ** 0.54
    eci = 0.5
    # riming (ice_cldliq_collection, :2054-2100)
    collect_qc = rhofaci * tab4 * qc_in * eci * rho * ni_rate
    both_ic = has_qi & (qc >= QSMALL)
    rim = _where0(both_ic & (tc < 0.0), collect_qc)
    shed = _where0(both_ic & (tc > 0.0), collect_qc)
    inv_dropmass = 1.0 / 5.2e-7
    ncshdc = shed * inv_dropmass
    vi_table = rhofaci * tab2
    # rime density (calc_rime_density, :2413-2490)
    vt_qc, lamc_r, _ = _cloud_vt(qc_in, nc_in, rho, acn)
    d_c = (mu_cd + 4.0) / lamc_r
    i_tc = 1.0 / _min(tc, -0.001)
    ri = torch.clamp(-0.5e6 * d_c * torch.abs(vi_table - vt_qc) * i_tc,
                     1.0, 12.0)
    rho_rime = torch.where(
        ri <= 8.0, (0.051 + 0.114 * ri - 0.0055 * ri * ri) * 1000.0,
        611.0 + 72.25 * (ri - 8.0))
    rho_rime = torch.where((rim >= QSMALL) & (qc >= QSMALL), rho_rime,
                           400.0)

    # ice-rain collection (ice_rain_collection, :2103-2157)
    lamr = cbrt(pi / 6.0 * RHO_H2O * 24.0 * _max(nr_in, NSMALL)
                / _max(qr_in, QSMALL))
    n0r = _max(nr_in, NSMALL) * lamr * lamr
    both_ir_any = has_qi & (qr >= QSMALL)
    qrcol = _where0(both_ir_any & (tc <= 0.0),
                    coll2 * n0r * rho * rhofaci * ni_rate)
    nr_col = _where0(both_ir_any, coll1 * n0r * rho * rhofaci * ni_rate)

    # thermodynamic/ventilation parameters (:3564-3572)
    dv_diff = 8.794e-5 * temp ** 1.81 / pres
    sc_n = mu_visc / (rho * dv_diff)
    kap = 1.414e3 * mu_visc
    eii = torch.clamp(
        0.001 + exact_div((temp - 253.15) * (0.3 - 0.001), 20.0), 0.001, 0.3)
    fr = qm_reb / _max(qi_in, QSMALL)
    eii_fact = torch.clamp(1.0 - exact_div(fr - 0.6, 0.3), 0.0, 1.0)
    # aggregation (ice_self_collection, :2159-2207)
    ni_self = _where0(has_qi, tab3 * rho * eii * eii_fact * rhofaci
                      * ni_rate * ni_rate)
    vent = (tab5 + tab10 * cbrt(sc_n)
            * torch.sqrt(rhofaci * rho / mu_visc))
    # melting (ice_melting, :2211-2256)
    qsat0 = p3_qv_sat_liq(torch.full_like(temp, TMELT), pres)
    melt = _where0(has_qi & (tc > 0.0), _max(
        exact_div(vent * (tc * kap - rho * Lv * dv_diff * (qsat0 - qv))
                  * 2.0 * pi, Lf) * ni_rate, 0.0))
    # deposition/sublimation by relaxation (:2322-2355, :3269-3330);
    # epsi gated at T < 0 (:2346)
    epsi = _where0(has_qi & (tc < 0.0),
                   vent * 2.0 * pi * rho * dv_diff * ni_rate)
    dqsidt = (Lv + LATICE) * qv_si / (R_V * temp * temp)
    abi = 1.0 + exact_div(dqsidt * (Lv + LATICE), CP_D)
    qi_tend = _min(epsi / abi, 1.0 / dt) * (qv - qv_si)
    dep = _where0(tc < 0.0, _max(qi_tend, 0.0))
    sub = _max(-qi_tend, 0.0)
    # Wegener-Bergeron-Findeisen (:3326-3328)
    berg = _where0(has_qi & (tc < 0.0),
                   _max(epsi / abi * (qsl - qv_si), 0.0))

    # rain evaporation through the generated ventilation table
    cdistr = _max(nr_in, NSMALL)
    gamma_mu2 = 2.0  # Gamma(mu_r + 2) = Gamma(3)
    epsr = 2.0 * pi * cdistr * rho * dv_diff * (
        F1R * gamma_mu2 / lamr
        + F2R * torch.sqrt(rho / mu_visc) * cbrt(sc_n) * revap_v)
    # wet growth (ice_cldliq_wet_growth, :2259-2319)
    cold_mix = has_qi & (qc_in + qr_in >= 1.0e-6) & (tc < 0.0)
    qwgrth = torch.where(
        cold_mix,
        _max(vent * 2.0 * pi
             * (rho * Lv * dv_diff * (qsat0 - qv) - tc * kap)
             / (Lf + CP_L * tc) * ni_rate, 0.0),
        math.inf)
    excess = _max(rim + qrcol - qwgrth, 0.0)
    excess = _where0(excess >= 1.0e-10, excess)
    log_wg = cold_mix & (excess >= 1.0e-10)
    tot_col = _max(rim + qrcol, 1e-30)
    wg_frac = _where0(rim + qrcol >= 1.0e-10, excess / tot_col)
    shed = shed + excess * (rim / tot_col)
    rim = rim * (1.0 - wg_frac)
    qrcol = qrcol * (1.0 - wg_frac)
    nr_shed_wg = excess * 1.923e6  # 1 mm drops (:2304)

    # rain evaporation, analytically integrated (evaporate_rain,
    # :3383-3537) with the qv_prev/t_prev history
    dqsldt = Lv * qsl / (R_V * temp * temp)
    abl = 1.0 + exact_div(dqsldt * Lv, CP_D)
    ssat_r = qv - qsl
    below = tc < 0.0
    eps_eff = _max(torch.where(
        below, epsr + epsi * (1.0 + Ls / CP_D * dqsldt) / abi, epsr),
        1.0e-20)
    tau_eff = 1.0 / eps_eff
    A_c = (exact_div(qv - qv_prev, dt)
           - exact_div(dqsldt * (temp - t_prev), dt)
           - _where0(below, (qsl - qv_si) * (1.0 + Ls / CP_D * dqsldt)
                     / abi * epsi))
    tau_r = 1.0 / _max(epsr, 1.0e-20)
    dtau = dt / tau_eff
    w_ts = -torch.expm1(-dtau) / dtau
    instant = -ssat_r / (abl * tau_r)
    equilib = -A_c / abl * tau_eff / tau_r
    ev_big = instant * w_ts + equilib * (1.0 - w_ts)
    ev = torch.where((qr_in < 1.0e-12)
                     & (qv / _max(qsl, QSMALL) < 0.999),
                     exact_div(qr_in, dt), ev_big)
    ev = torch.minimum(ev, exact_div(-ssat_r, dt) / abl)
    ev = torch.minimum(_max(ev, 0.0), exact_div(qr_in, dt))
    ev = _where0((qc_in + qi_in < 1.0e-6) & (ssat_r < 0.0)
                 & (qr >= QSMALL), ev)
    return (au, ac, qc_frz, nc_frz, qr_frz, nr_frz, rim, shed, ncshdc, berg,
            dep, sub, ev, melt, qinuc, ninuc, qrcol, nr_col, nr_self,
            ni_self, nr_shed_wg, rho_rime, log_wg.to(qc.dtype), ni_rate,
            qv_si)


def _p3_rates_approx(dt, qc, nc, qr, qi, ni, qv, temp, pres, rho, inv_rho,
                     qc_in, qr_in, qi_in, nc_in, nr_in, ni_in, mu_cd):
    """The continuous [approx] tier's rates, plain tensor code; the same
    25 outputs as ``_p3_rates_post_cellwise``."""
    (au, ac, nr_self, qsl, tc, qv_si, sup_i, qinuc, ninuc, qc_frz, nc_frz,
     qr_frz, nr_frz) = _p3_warm_ice_rates(
        dt, qc, nc, qr, ni, qv, temp, pres, rho, inv_rho, qc_in, qr_in,
        nc_in, nr_in, mu_cd)
    # rain evaporation, deposition/sublimation by relaxation [approx]
    subsat = _max(qsl - qv, 0.0) / _max(qsl, QSMALL)
    tau_evap = 150.0 / _max((rho * qr_in) ** 0.35, 1e-4)
    ev = _where0((qr >= QSMALL) & (qc < QSMALL), subsat * qr_in / tau_evap)
    tau_dep = 300.0 / _max((rho * qi_in) ** 0.25, 1e-3)
    has_ice = (qi >= QSMALL) & (tc < 0.0)
    dep = _where0(has_ice & (sup_i > 0.0), (qv - qv_si) / tau_dep)
    sub = _where0(has_ice & (sup_i < 0.0), (qv_si - qv) / tau_dep)
    # riming [approx]
    vi = torch.clamp(1.2 * _max(rho * qi, 0.0) ** 0.0625, 0.3, 3.0)
    erim = 0.7
    rim = _where0((qi >= QSMALL) & (qc >= QSMALL) & (tc < 0.0),
                  erim * 2.0 * vi * qi * qc)
    melt = _where0((qi >= QSMALL) & (tc > 0.0), exact_div(qi * tc, 60.0))
    zero = torch.zeros_like(qc)
    return (au, ac, qc_frz, nc_frz, qr_frz, nr_frz, rim, zero, zero, zero,
            dep, sub, ev, melt, qinuc, ninuc, zero, zero, nr_self, zero,
            zero, torch.full_like(qc, 400.0), zero, ni_in, qv_si)


# -- sedimentation: the fall speeds and the sub-cycled upstream fall --------

def _cloud_sed_speeds(qc_, nc_, rho, acn):
    """(V_qc, nc) with get_cloud_dsd2's nc adjustment persisted
    (cloud_sedimentation, micro_p3.F90:3670-3722)."""
    gate = qc_ >= QSMALL
    qc_c = _where0(gate, _min(qc_, 5.1e-3))
    nc_l = _cloud_dsd2(qc_c, _where0(gate, _max(nc_, 0.0)), rho)[0]
    v, _, _ = _cloud_vt(qc_c, nc_l, rho, acn)
    return v, torch.where(gate, nc_l, nc_)


def _ice_sed_speeds(qi_, ni_, qm_, bm_, rho, inv_rho, dtab):
    """(V_qit, V_nit, ni, qm, bm) with the re-bounds and the limited ni
    persisted (ice_sedimentation, micro_p3.F90:4007-4037)."""
    gate = qi_ >= QSMALL
    if dtab is None:
        v = torch.clamp(1.2 * _max(rho * qi_, 0.0) ** 0.0625, 0.3, 3.0)
        return v, v, ni_, qm_, bm_
    qi_c = _where0(gate, _min(qi_, 5.1e-3))
    ni_c = _max(_where0(gate, _max(ni_, 0.0)), NSMALL)
    has_m = gate & (qm_ >= QSMALL)
    qm_c = _where0(has_m, qm_)
    bm_c = _where0(has_m, _min(_max(bm_, 0.0), 5.1e-3))
    qm_c, bm_c, rr_ = _bulk_rho_rime(qi_c, qm_c, bm_c)
    idx_ = ice_table_indices(qi_c, ni_c, qm_c, rr_)
    rfac = (_RHO_600MB * inv_rho) ** 0.54
    v_q, v_n, t7_, t8_ = interp_ice_multi(dtab, (2, 1, 7, 8), *idx_,
                                          present=gate.any())
    ni_l = torch.minimum(ni_c, t7_ * ni_c)
    ni_l = torch.maximum(ni_l, t8_ * ni_l)
    return (_where0(gate, rfac * v_q), _where0(gate, rfac * v_n),
            torch.where(gate, ni_l, ni_), torch.where(gate, qm_c, qm_),
            torch.where(gate, bm_c, bm_))


def _rain_sed_speeds(qr_, nr_, rho, inv_rho, rho_sfc, dtab):
    """(V_qr, V_nr, nr) with get_rain_dsd2's nr adjustment persisted
    (rain_sedimentation, micro_p3.F90:3825-3843); the speeds from the
    generated vm/vn rows in one lookup (compute_rain_fall_velocity,
    :3872-3908), or a KW-style speed without tables (then V_nr = V_qr)."""
    gate = qr_ >= QSMALL
    qr_c = _where0(gate, _min(qr_, 1.0e-2))
    nr_c = _where0(gate, _max(nr_, 0.0))
    nr_l = _rain_dsd2(qr_c, nr_c)[0]
    if dtab is None:
        v_q = v_n = torch.clamp(36.34 * _max(rho * qr_c, 0.0) ** 0.1364
                                * torch.sqrt(rho_sfc / rho), 0.0, 9.1)
    else:
        rhofacr = (_RHO_1000MB * inv_rho) ** 0.54
        lam = cbrt(math.pi / 6.0 * RHO_H2O * 24.0 * _max(nr_l, NSMALL)
                   / _max(qr_c, QSMALL))
        i0, fi_ = rain_size_index((MU_R + 1.0) / lam)
        vgate = qr_c >= QSMALL
        vm, vn = interp_rain_multi(dtab.rain_rows(("vm", "vn")), i0, fi_,
                                   present=vgate.any())
        v_q, v_n = _where0(vgate, rhofacr * vm), _where0(vgate, rhofacr * vn)
    return v_q, v_n, torch.where(gate, nr_l, nr_)


def _p3_sed_vmax(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dtab,
                 z_axis: int = 1):
    """The fastest mass-weighted fall speed of the state (rain V_qr, ice
    V_qit, cloud V_qc), a 0-d tensor: the oracle of the maximum that
    ``sed_step`` (``p3_sed_cuda``) takes."""
    inv_rho = 1.0 / rho
    rho_sfc = rho.narrow(z_axis, 0, 1)
    return torch.maximum(
        torch.maximum(
            _rain_sed_speeds(qr, nr, rho, inv_rho, rho_sfc, dtab)[0].max(),
            _ice_sed_speeds(qi, ni, qm, bm, rho, inv_rho, dtab)[0].max()),
        _cloud_sed_speeds(qc, nc, rho, _stokes_acn(_mu_visc(temp)))[0].max())


class _Fall:
    """The fixed parts of the sub-cycled fall: the speeds' density terms
    and the column masses of ``rho`` and ``dz`` along ``z_axis``."""

    def __init__(self, rho, temp, dz, z_axis, dtab):
        self.nz, self.z_axis, self.dtab, self.rho = (rho.shape[z_axis],
                                                     z_axis, dtab, rho)
        self.inv_rho = 1.0 / rho
        self.rho_sfc = self.ax(rho, 0, 1)
        self.acn = _stokes_acn(_mu_visc(temp))
        nz = self.nz
        self.mass_lo = self.ax(rho, 0, nz - 1) * self.ax(dz, 0, nz - 1)
        self.mass_top = self.ax(rho, nz - 1, 1) * self.ax(dz, nz - 1, 1)

    def ax(self, a, start, length):
        return a.narrow(self.z_axis, start, length)

    def speeds(self, q):
        """(the speeds (V_qc, V_qr, V_nr, V_qit, V_nit) of q = (qc, nc, qr,
        nr, qi, ni, qm, bm), q with the speeds' persisted write-backs
        (:3700, :3843, :4021-4034))."""
        qc, nc, qr, nr, qi, ni, qm, bm = q
        rho, inv_rho, dtab = self.rho, self.inv_rho, self.dtab
        vr_, vnr_, nr = _rain_sed_speeds(qr, nr, rho, inv_rho, self.rho_sfc,
                                         dtab)
        vi_, vni_, ni, qm, bm = _ice_sed_speeds(qi, ni, qm, bm, rho, inv_rho,
                                                dtab)
        vc_, nc = _cloud_sed_speeds(qc, nc, rho, self.acn)
        return (vc_, vr_, vnr_, vi_, vni_), (qc, nc, qr, nr, qi, ni, qm, bm)

    def substep(self, q, v, dts, do_predict_nc, pl, pi_):
        """One upstream sub-step of q = (qc, nc, qr, nr, qi, ni, qm, bm)
        at the speeds v, falling top-down; returns the new q and the
        surface accumulators (pl, pi_) with this sub-step's outflow."""
        ax, nz = self.ax, self.nz
        qc, nc, qr, nr, qi, ni, qm, bm = q
        vc_, vr_, vnr_, vi_, vni_ = v

        def fall(q, v):
            """One upstream sub-step; returns (q, surface outflow)."""
            flux = self.rho * q * v  # downward mass flux at cell centers
            dq_lower = dts * (ax(flux, 1, nz - 1)
                              - ax(flux, 0, nz - 1)) / self.mass_lo
            dq_top = -dts * ax(flux, nz - 1, 1) / self.mass_top
            q = q + torch.cat([dq_lower, dq_top], dim=self.z_axis)
            return _max(q, 0.0), exact_div(dts * ax(flux, 0, 1), RHO_H2O)

        qc, out = fall(qc, vc_)
        pl = pl + out
        if do_predict_nc:
            nc = fall(nc, vc_)[0]
        qr, out = fall(qr, vr_)
        pl = pl + out
        nr = fall(nr, vnr_)[0]   # nr at V_nr (:3785-3791)
        qi, out = fall(qi, vi_)
        pi_ = pi_ + out
        ni = fall(ni, vni_)[0]   # ni at V_nit (:4025-4037)
        qm = fall(qm, vi_)[0]
        bm = fall(bm, vi_)[0]
        return (qc, nc, qr, nr, qi, ni, qm, bm), pl, pi_

    def run(self, q, v, dt, nsub_t, nsub, do_predict_nc):
        """``nsub`` sub-steps from q, the first at the speeds ``v`` (of q),
        each later one at the speeds of its own state; returns (qc ... bm,
        precip_liq, precip_ice), the surface rates in m/s."""
        dts = dt / nsub_t
        pl = torch.zeros_like(self.ax(q[0], 0, 1))
        pi_ = torch.zeros_like(pl)
        for s in range(nsub):
            if s:
                v, q = self.speeds(q)
            q, pl, pi_ = self.substep(q, v, dts, do_predict_nc, pl, pi_)
        z = self.z_axis
        return (*q, exact_div(pl.squeeze(z), dt),
                exact_div(pi_.squeeze(z), dt))


def _p3_sed_step(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt, dtab,
                 do_predict_nc: bool, z_axis: int = 1):
    """Every cell's fall speeds once, their maximum (rain V_qr, ice V_qit,
    cloud V_qc; as ``_p3_sed_vmax`` takes it) and one upstream sub-step of
    the fall at dts = dt: the plain version of ``sed_step``
    (``p3_sed_cuda``).  Returns (vmax, (qc, nc, qr, nr, qi, ni, qm, bm,
    precip_liq, precip_ice)), the outputs those of ``_p3_sed_columns`` at
    one sub-step."""
    fall = _Fall(rho, temp, dz, z_axis, dtab)
    v, q = fall.speeds((qc, nc, qr, nr, qi, ni, qm, bm))
    vc_, vr_, _, vi_, _ = v
    vmax = torch.maximum(torch.maximum(vr_.max(), vi_.max()), vc_.max())
    one = torch.ones((), dtype=qc.dtype, device=qc.device)
    return vmax, fall.run(q, v, dt, one, 1, do_predict_nc)


def _p3_sed_columns(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt,
                    nsub_t, dtab, do_predict_nc: bool, z_axis: int = 1,
                    rerun=None):
    """``nsub_t`` (a 0-d tensor) upstream sub-steps of cloud, rain and ice
    sedimentation, each with its speeds' persisted write-backs (:3700,
    :3843, :4021-4034), falling top-down level by level; the plain version
    of ``sed_columns`` (``p3_sed_cuda``), the counterpart of the JAX
    package's ``lax.while_loop``.  It reads ``nsub_t`` to the host.
    ``rerun``: the outputs ``_p3_sed_step`` made of these inputs, returned
    as they are where nsub is 1.  Returns (qc, nc, qr, nr, qi, ni, qm, bm,
    precip_liq, precip_ice), the surface rates in m/s."""
    # in a mesh run, one read serves every shard
    nsub = host_ints(nsub_t)
    if rerun is not None and nsub == 1:
        return tuple(rerun)
    fall = _Fall(rho, temp, dz, z_axis, dtab)
    v, q = fall.speeds((qc, nc, qr, nr, qi, ni, qm, bm))
    return fall.run(q, v, dt, nsub_t, nsub, do_predict_nc)


def p3_scheme(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pres,
              rho_d, dz, dt, z_axis: int = 1, tables=None, qv_prev=None,
              t_prev=None, do_predict_nc: bool = False,
              diagnostics: bool = False, spmd_axes: tuple = ()):
    """The P3-class column scheme on dry mixing ratios.

    All tensors share one shape with the vertical on ``z_axis``
    (bottom-up).  Returns updated (qc, nc, qr, nr, qi, ni, qm, bm, qv,
    theta) plus (precip_liq_surf, precip_ice_surf) in m/s, shaped without
    the z axis; with ``diagnostics=True`` also part3's diagnostic dict
    (eff_radius_qc/qi, diam_qi, rho_qi, vm_qi, equiv_reflectivity) as a
    13th element.  ``tables`` (``P3Tables`` or ``DeviceTables``) selects
    the lookup-table tier; None the continuous [approx] tier.  ``qv_prev`` /
    ``t_prev``: the previous call's post-micro qv and T (None: the
    instantaneous first-step form).  ``spmd_axes``: in a shard of a mesh
    run, the mesh axes over which sedimentation's fastest fall speed
    (``pmax``) and thinnest level (``pmin``) are taken, so the shards of a
    group run the same sub-step count.  Arguments and semantics are those
    of the JAX ``p3_scheme``."""
    from . import p3_cellwise_cuda as cw
    from . import p3_sed_cuda as sed

    dtab = None if tables is None else tables.to(qc.device, qc.dtype)
    rho = rho_d * (1.0 + qv + qc + qr + qi)  # total density estimate
    inv_rho = 1.0 / rho
    Lv, Ls, Lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D

    # -- part1 + in-cloud values + pre-process DSD writebacks (one kernel)
    (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, skip_f,
     qc_in, qr_in, qi_in, qm_in, bm_in, nc_in, nr_in, ni_in,
     _mu_cd) = cw.p3_part1(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                           pres, rho, do_predict_nc=do_predict_nc)

    # -- process rates: the table tier as two kernels around the lookups
    if dtab is not None:
        (qm, bm, i0, fi, ii0, fii, jj0, fjj, j0, fj, i0r, fir,
         present) = cw.p3_rates_pre(qi, qr, qm, bm, qi_in, qm_in, bm_in,
                                    ni_in, qr_in, nr_in)
        idx = (i0, fi, ii0, fii, jj0, fjj)
        # one batched lookup for every part2 rate, skipped without ice
        tabs = interp_ice_multi(dtab, (7, 8, 4, 2, 3, 5, 10), *idx,
                                present=present[0])
        colls = interp_collect_multi(dtab, (2, 1), *idx, j0, fj,
                                     present=present[1])
        (revap_v,) = interp_rain_multi(dtab.rain_rows(("revap",)), i0r, fir,
                                       present=present[2])
        rates = cw.p3_rates_post(
            dt, qc, nc, qr, qi, ni, qv, temp, pres, rho, qc_in, qr_in, qi_in,
            qm_in, bm_in, nc_in, nr_in, ni_in, _mu_cd,
            qv if qv_prev is None else qv_prev,
            temp if t_prev is None else t_prev, *tabs, *colls, revap_v)
    else:
        rates = _p3_rates_approx(dt, qc, nc, qr, qi, ni, qv, temp, pres, rho,
                                 inv_rho, qc_in, qr_in, qi_in, nc_in, nr_in,
                                 ni_in, _mu_cd)

    # -- conservation -> prognostic update -> end-of-part2 clip (one kernel)
    (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta) = cw.p3_update(
        dt, *rates[:23], qc_in, nc_in, qr_in, nr_in, qi_in, rates[23], qc,
        nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, inv_rho, temp,
        rates[24], pres, skip_f, do_predict_nc=do_predict_nc)

    if diagnostics:
        # per-column is_hydromet_present: a level survived the
        # end-of-part2 clip (micro_p3.F90:893-920)
        hydro_col = torch.any((qc > 0.0) | (qr > 0.0) | (qi > 0.0),
                              dim=z_axis, keepdim=True)

    # -- sedimentation (cloud + rain + ice), upstream, CFL sub-cycled: one
    # pass takes the fastest fall speed and makes one sub-step; the count
    # stays a device tensor, read by the column kernel, which reruns the
    # whole sub-cycle only where it is above 1
    vmax, one_step = sed.sed_step(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp,
                                  dz, dt, dtab, do_predict_nc=do_predict_nc,
                                  z_axis=z_axis)
    vmax = pmax(vmax, spmd_axes)
    dz_min = pmin(dz.min(), spmd_axes)
    nsub_t = _max(torch.ceil(dt * vmax / (0.9 * dz_min)), 1.0)
    count_device("p3.sed_substeps", nsub_t)
    (qc, nc, qr, nr, qi, ni, qm, bm, precip_liq, precip_ice) = (
        sed.sed_columns(qc, nc, qr, nr, qi, ni, qm, bm, rho, temp, dz, dt,
                        nsub_t, dtab, do_predict_nc=do_predict_nc,
                        z_axis=z_axis, rerun=one_step))

    # -- homogeneous freezing and p3_main_part3 (one kernel, with or without
    # the diagnostics)
    part3_in = (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp, exner, rho,
                inv_rho)
    if not diagnostics:
        return (*cw.p3_part3(*part3_in, dtab), precip_liq, precip_ice)
    prog, diag_cells = cw.p3_part3(*part3_in, dtab, diagnostics=True)
    # columns the reference skips keep the p3_main init values

    def col(v, default):
        return torch.where(hydro_col, v, default)
    diag = {name: col(diag_cells[name], default)
            for name, default in _DIAG_DEFAULTS.items()}
    return (*prog, precip_liq, precip_ice, diag)


# part3's diagnostic fields and their p3_main init values
# (micro_p3.F90:1307-1315)
_DIAG_DEFAULTS = dict(eff_radius_qc=10.0e-6, eff_radius_qi=25.0e-6,
                      diam_qi=0.0, rho_qi=0.0, vm_qi=0.0,
                      equiv_reflectivity=-99.0)


def _p3_part3_cellwise(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, temp,
                       exner, rho, inv_rho, dtab, diagnostics=False):
    """Homogeneous freezing and p3_main_part3 per cell, on the state after
    sedimentation (micro_p3.F90:4145-4200, :977-1137).

    ``temp``: the end-of-part1 temperature, which gates the freezing as in
    the reference; ``dtab``: the table tier's ``DeviceTables`` (the ice
    number limiter's K=2 lookup), or None for the [approx] tier.  Returns
    the ten prognostics (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta); with
    ``diagnostics=True`` also a dict of part3's diagnostic fields per cell,
    before the caller's column mask."""
    Lv, Ls, Lf, cp = LATVAP, LATVAP + LATICE, LATICE, CP_D

    # -- homogeneous freezing: below -40 C all cloud, then all rain, freezes
    # into rimed ice packed at rho_rimeMax
    def freeze(q, n):
        nonlocal qm, qi, bm, ni, theta
        frz = (q >= QSMALL) & (temp < T_HOMOGFRZ)
        q_nuc = _where0(frz, q)
        qm = qm + q_nuc
        qi = qi + q_nuc
        bm = bm + exact_div(q_nuc, RHO_RIMEMAX)
        ni = ni + _where0(frz, _max(n, NSMALL))
        theta = theta + q_nuc * Lf / (cp * exner)
        return _where0(~frz, q), _where0(~frz, n)

    qc, nc = freeze(qc, nc)
    qr, nr = freeze(qr, nr)

    # -- p3_main_part3
    small_c = qc < QSMALL
    qv = qv + _where0(small_c, qc)
    theta = theta - _where0(small_c, qc) * Lv / (cp * exner)
    nc3, mu_c3, lamc3 = _cloud_dsd2(qc, nc, rho)
    nc = _where0(~small_c, nc3)
    qc = _where0(~small_c, qc)

    small_r = qr < QSMALL
    qv = qv + _where0(small_r, qr)
    theta = theta - _where0(small_r, qr) * Lv / (cp * exner)
    nr3, lamr3 = _rain_dsd2(qr, nr)
    nr = _where0(~small_r, nr3)
    qr = _where0(~small_r, qr)

    small_i = qi < QSMALL
    qv = qv + _where0(small_i, qi)
    theta = theta - _where0(small_i, qi) * Ls / (cp * exner)
    ni = _max(ni, NSMALL)
    qm, bm, _ = _bulk_rho_rime(qi, qm, bm)
    ni = _cap_ni(ni, inv_rho)
    ice_diag = None
    if dtab is not None:
        # the lambda limiters' lookup, skipped without ice: a cell with
        # qi < QSMALL is zeroed below whatever it gives
        rhop3 = torch.clamp(qm / _max(bm, 1e-30), RHO_RIMEMIN, RHO_RIMEMAX)
        idx3 = ice_table_indices(qi, ni, qm, rhop3)
        cols3 = (7, 8, 2, 6, 9, 11, 12) if diagnostics else (7, 8)
        vals3 = interp_ice_multi(dtab, cols3, *idx3,
                                 present=(qi >= QSMALL).any())
        ni = torch.minimum(ni, vals3[0] * ni)
        ni = torch.maximum(ni, vals3[1] * ni)
        ice_diag = vals3[2:]
    qi, ni, qm, bm = (_where0(~small_i, a) for a in (qi, ni, qm, bm))
    prog = (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta)
    if not diagnostics:
        return prog

    # -- part3's diagnostics (:1026, :1046-1048, :1102-1112) with the
    # p3_main defaults
    eff_qc = torch.where(small_c, 10.0e-6, 0.5 * (mu_c3 + 3.0) / lamc3)
    # ze_rain = nr*(mu_r+6)!/(mu_r)!/lamr^6 at mu_r = 1
    l2 = lamr3 * lamr3
    ze_rain = torch.where(small_r, 1.0e-22,
                          _max(nr * 5040.0 / (l2 * (l2 * l2)), 1.0e-22))
    if ice_diag is not None:
        t2_3, t6_3, t9_3, t11_3, t12_3 = ice_diag
        rhofaci3 = (_RHO_600MB * inv_rho) ** 0.54
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


def _p3_wrapper_out_cellwise(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                             rho_d):
    """``MicrophysicsP3.time_step``'s output pass per cell
    (microphysics_p3.h:425-444): the nine densities q rho_d clamped at 0,
    temp = theta exner (the frozen exner) and qv_prev = max(qv, 0).
    Returns (cloud_water, cloud_water_num, rain, rain_num, ice, ice_num,
    ice_rime, ice_rime_vol, water_vapor, temp, qv_prev)."""
    dens = tuple(_max(q * rho_d, 0.0)
                 for q in (qc, nc, qr, nr, qi, ni, qm, bm, qv))
    return (*dens, theta * exner, _max(qv, 0.0))


def p3_wrapper_inputs(state: CouplerState):
    """The wrapper's pre-scheme work (microphysics_p3.h:273-301) in one
    kernel: saturation pre-adjustment, density -> mixing ratios,
    pressure/exner/theta and the qv_prev/t_prev history.  Returns (qc, nc,
    qr, nr, qi, ni, qm, bm, qv, theta, exner, pressure, dz, qv_prev,
    t_prev)."""
    from .p3_cellwise_cuda import p3_wrapper

    out = p3_wrapper(state["density_dry"], state["temp"],
                     *(state[t[0]] for t in MicrophysicsP3.TRACERS),
                     state["qv_prev"], state["t_prev"])
    dz = torch.full_like(out[9], state.grid.dz)
    return (*out[:12], dz, out[12], out[13])


def _p3_scheme_native(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                      pres, rho_d, dz, dt, qv_prev=None, t_prev=None):
    """``p3_scheme``'s 12 outputs from the C++ twin, the counterpart of the
    JAX package's ``_p3_scheme_native_callback`` (p3.py:1586-1618).

    The 16 fields (nens, nz, ny, nx) become columns (nens, ny, nx, nz) in
    float64 on their own device and go to the host in one copy; one
    ``p3_column_step`` over every column (one global sub-cycle count, so
    never split across threads); the 10 prognostic fields and the 2
    surface fields come back to the device in float64 and are cast there to
    the inputs' dtype."""
    from ..native import column_step, load_p3_library

    lib = load_p3_library()
    nens, nz, ny, nx = qc.shape
    qvp = qv if qv_prev is None else qv_prev
    tp = theta * exner if t_prev is None else t_prev
    cols = _columns_to_host((qc, nc, qr, nr, qi, ni, qm, bm, qv, theta,
                             exner, pres, rho_d, dz, qvp, tp))
    host = cols.numpy().reshape(16, nens * ny * nx, nz)
    pl, pi_ = column_step(lib, host[:10], host[10:14], dt, host[14],
                          host[15])
    srf = torch.from_numpy(np.stack([pl, pi_]).reshape(2, nens, ny, nx))
    return _columns_to_device(cols[:10], srf, qc)


def _columns_to_host(fields) -> torch.Tensor:
    """(nens, nz, ny, nx) fields as one float64 host tensor of columns,
    (n, nens, ny, nx, nz): cast and permuted on their device, then one
    copy."""
    return torch.stack([f.to(torch.float64).permute(0, 2, 3, 1)
                        for f in fields]).cpu()


def _columns_to_device(prog: torch.Tensor, srf: torch.Tensor, like):
    """The twin's host outputs back on ``like``'s device in its dtype: the
    (10, nens, ny, nx, nz) columns as 10 contiguous (nens, nz, ny, nx)
    fields, and the (2, nens, ny, nx) surface fields."""
    n, nens, ny, nx, nz = prog.shape
    out = torch.empty((n, nens, nz, ny, nx), dtype=like.dtype,
                      device=like.device)
    out.copy_(prog.to(like.device).permute(0, 1, 4, 2, 3))
    srf = srf.to(like.device).to(like.dtype)
    return (*out.unbind(0), *srf.unbind(0))


class MicrophysicsP3:
    """P3 coupler module: registers the 9 P3 tracers and the persistent
    fields, runs the saturation pre-adjustment and the scheme each step
    (reference microphysics_p3.h:96-444).

    ``backend``: "torch" (or "jax", the JAX package's name for the same
    vectorized scheme, so its YAML files run unchanged), or "native": the
    column step runs in the C++ twin on the host (``_p3_scheme_native``),
    the reference's host-staged Fortran call (microphysics_p3.h:364-376);
    the rest of the step stays on the state's device."""

    num_tracers = 9

    TRACERS = (
        # name, description, positive, adds_mass (microphysics_p3.h:103-112)
        ("cloud_water", "Cloud Water Mass", True, True),
        ("cloud_water_num", "Cloud Water Number", True, False),
        ("rain", "Rain Water Mass", True, True),
        ("rain_num", "Rain Water Number", True, False),
        ("ice", "Ice Mass", True, True),
        ("ice_num", "Ice Number", True, False),
        ("ice_rime", "Ice-Rime Mass", True, False),
        ("ice_rime_vol", "Ice-Rime Volume", True, False),
        ("water_vapor", "Water Vapor", True, True),
    )

    # part3 diagnostic outputs (opt-in; see p3_scheme(diagnostics=True))
    DIAG_FIELDS = tuple(_DIAG_DEFAULTS)

    def __init__(self, backend: str = "torch", table_path: str | None = None,
                 use_tables: bool | None = None,
                 do_predict_nc: bool = False, diagnostics: bool = False):
        if backend not in ("torch", "jax", "native"):
            raise ValueError("backend must be 'torch' (alias 'jax') or "
                             "'native'")
        if diagnostics and backend == "native":
            raise ValueError("diagnostics=True requires backend 'torch' "
                             "(the native twin mirrors the reference "
                             "wrapper, which discards the diag arrays)")
        self.backend = backend
        self.diagnostics = diagnostics
        self.do_predict_nc = do_predict_nc
        self.tables: P3Tables | None = None
        if backend == "native":
            # built here, so its tables are installed before any shard of a
            # mesh runs; they follow the asset whatever ``use_tables`` says
            from ..native import load_p3_library
            load_p3_library()
        elif use_tables is not False:
            path = table_path or default_table_path()
            if path is not None:
                self.tables = load_p3_tables(path)
            elif use_tables:
                raise FileNotFoundError(
                    "use_tables=True but no P3 lookup table found")

    def init(self, state: CouplerState) -> CouplerState:
        g = state.grid
        for name, desc, pos, mass in self.TRACERS:
            state = state.add_tracer(name, desc, pos, mass)
        state = state.register_field("qv_prev")
        state = state.register_field("t_prev")
        state = state.register_field("precl", shape=(g.nens, g.ny, g.nx))
        state = state.register_field("precl_ice", shape=(g.nens, g.ny, g.nx))
        if self.diagnostics:
            for name in self.DIAG_FIELDS:
                state = state.register_field(name)
            state = state.replace_fields(**{
                k: torch.full_like(state[k], v)
                for k, v in _DIAG_DEFAULTS.items()})
        if self.tables is not None:
            self.tables.to(state.device, state.meta.tdtype)
        cv_d = CP_D - R_D
        return state.set_options(
            micro="p3",
            R_d=R_D, cp_d=CP_D, cv_d=cv_d, gamma_d=CP_D / cv_d,
            kappa_d=R_D / CP_D, R_v=R_V, cp_v=CP_V, cv_v=R_V - CP_V,
            p0=P0, grav=GRAV,
        )

    def time_step(self, state: CouplerState, dt: float,
                  spmd_axes: tuple = ()) -> CouplerState:
        """One P3 step; ``spmd_axes`` as in ``p3_scheme``."""
        with span("p3.step"):
            rho_d = state["density_dry"]
            (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner, pressure, dz,
             qv_prev, t_prev) = p3_wrapper_inputs(state)
            if self.backend == "native":
                # under a mesh each shard's columns take their own sub-cycle
                # count, as JAX's pure_callback does under shard_map
                qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, pl, pi_ = (
                    _p3_scheme_native(
                        qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                        pressure, rho_d, dz, dt, qv_prev=qv_prev,
                        t_prev=t_prev))
            else:
                out = p3_scheme(
                    qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, exner,
                    pressure, rho_d, dz, dt, z_axis=1, tables=self.tables,
                    qv_prev=qv_prev, t_prev=t_prev,
                    do_predict_nc=self.do_predict_nc,
                    diagnostics=self.diagnostics, spmd_axes=spmd_axes)
                (qc, nc, qr, nr, qi, ni, qm, bm, qv, theta, pl,
                 pi_) = out[:12]
                if self.diagnostics:
                    state = state.replace_fields(**out[12])

            from .p3_cellwise_cuda import p3_wrapper_out

            # the clamped densities, temp with the frozen exner
            # (microphysics_p3.h:434-436) and the qv history in one pass
            out = p3_wrapper_out(qc, nc, qr, nr, qi, ni, qm, bm, qv, theta,
                                 exner, rho_d)
            fields = {t[0]: a for t, a in zip(self.TRACERS, out)}
            return state.replace_fields(**fields, temp=out[9],
                                        qv_prev=out[10], t_prev=out[9],
                                        precl=pl, precl_ice=pi_)

    @property
    def micro_name(self) -> str:
        return "p3"

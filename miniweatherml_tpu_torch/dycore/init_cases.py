"""Test-case initial conditions: thermal, supercell, city and building.

Port of ``miniweatherml_tpu/dycore/init_cases.py`` (reference
dynamics_euler_stratified_wenofv.h:1085-1193 analytic profiles, :1338-1419
thermal, :1421-1652 city and building, :1687-1887 supercell).  Quadrature
runs in float64 numpy on the host; the results are cast to the model dtype
on the state's device.  The city and building cases build their
immersed-boundary mask with numpy and move it to the device once.

Every supercell integrand depends only on z, so the reference's ord^3-point
3-D quadrature collapses exactly to 1-D z profiles.  Those profiles are built
on the host and broadcast over (y, x) on the device: no full-grid array is
ever allocated on the host.  The thermal bubble keeps the full 3-D 3-point
Gauss-Legendre quadrature (it feeds the small 2-D tests).

Each ``init_*`` function takes and returns a CouplerState plus the dycore
state/tracer tensors (nvar, nens, nz, ny, nx) in perturbation form.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..core.coupler import CouplerState
from ..ops.direction_fluxes import IDR, IDT, IDU, NUM_STATE
from ..ops.gll import gauss_legendre_points_weights, gll_points, gll_weights
from ..ops.stencil import BC_PERIODIC, BC_WALL

__all__ = ["init_thermal", "init_supercell", "init_city",
           "init_building"]


# ---------------------------------------------------------------------------
# analytic pointwise profiles (reference dynamics...h:1086-1193)
# ---------------------------------------------------------------------------

def hydro_const_theta(z, grav, C0, cp, p0, gamma, rd):
    """Hydrostatic background for constant theta0=300 K
    (reference dynamics...h:1108-1117).  Returns (rho, theta)."""
    theta0 = 300.0
    exner = 1.0 - grav * z / (cp * theta0)
    p = p0 * exner ** (cp / rd)
    rt = (p / C0) ** (1.0 / gamma)
    return rt / theta0, np.full_like(np.asarray(z, float), theta0)


def sample_ellipse_cosine(amp, x, y, z, x0, y0, z0, xrad, yrad, zrad):
    """cos^2 ellipsoid bump (reference dynamics...h:1121-1134)."""
    dist = np.sqrt(((x - x0) / xrad) ** 2 + ((y - y0) / yrad) ** 2
                   + ((z - z0) / zrad) ** 2) * np.pi / 2.0
    return np.where(dist <= np.pi / 2.0, amp * np.cos(dist) ** 2, 0.0)


def saturation_vapor_pressure(temp):
    """(reference dynamics...h:1137-1140)"""
    tc = temp - 273.15
    return 610.94 * np.exp(17.625 * tc / (243.04 + tc))


def supercell_temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top):
    """(reference dynamics...h:1144-1153)"""
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    return np.where(
        z <= z_trop, T_0 - lapse_lo * (z - z_0), T_trop - lapse_hi * (z - z_trop))


def supercell_pressure_dry(z, z_0, z_trop, z_top, T_0, T_trop, T_top, p_0, R_d,
                           grav):
    """(reference dynamics...h:1157-1177)"""
    T = supercell_temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top)
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    p_lo = p_0 * (T / T_0) ** (grav / (R_d * lapse_lo))
    p_trop = p_0 * (T_trop / T_0) ** (grav / (R_d * lapse_lo))
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    if lapse_hi != 0.0:
        p_hi = p_trop * (T / T_trop) ** (grav / (R_d * lapse_hi))
    else:
        p_hi = p_trop * np.exp(-grav * (z - z_trop) / (R_d * T_trop))
    return np.where(z <= z_trop, p_lo, p_hi)


def supercell_relhum(z, z_0, z_trop):
    """(reference dynamics...h:1181-1187)"""
    return np.where(z <= z_trop, 1.0 - 0.75 * (z / z_trop) ** 1.25, 0.25)


def supercell_sat_mix_dry(press, T):
    """(reference dynamics...h:1191-1193)"""
    return 380.0 / press * np.exp(17.27 * (T - 273.0) / (T - 36.0))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _phys(state: CouplerState):
    o = state.options
    return dict(
        R_d=o["R_d"], R_v=o["R_v"], cp_d=o["cp_d"], p0=o["p0"],
        grav=o["grav"], gamma=o["gamma_d"], C0=o["C0"],
    )


def _store_hy(state: CouplerState, hr_c, hrt_c, hr_e, hrt_e) -> CouplerState:
    """Register the hydrostatic background profiles, (nens, nz) at cells and
    (nens, nz + 1) at faces, as coupler fields (dynamics...h:1663-1668)."""
    g = state.grid

    def bc(a):
        t = torch.as_tensor(np.asarray(a, np.float64), dtype=state.meta.tdtype,
                            device=state.device)
        return t[None, :].expand(g.nens, -1).contiguous()

    upd = {
        "hy_dens_cells": bc(hr_c),
        "hy_dens_theta_cells": bc(hrt_c),
        "hy_dens_edges": bc(hr_e),
        "hy_dens_theta_edges": bc(hrt_e),
    }
    for k, v in upd.items():
        if k not in state.fields:
            state = state.register_field(k, value=v)
        else:
            state = state.replace_fields(**{k: v})
    return state


def _zero_dyn(state: CouplerState):
    """Zero dycore state and tracers on the state's device."""
    g = state.grid
    kw = dict(dtype=state.meta.tdtype, device=state.device)
    return (torch.zeros((NUM_STATE,) + g.field_shape, **kw),
            torch.zeros((state.meta.num_tracers,) + g.field_shape, **kw))


def _column(state: CouplerState, prof) -> torch.Tensor:
    """A z profile (nz,) from the host as a (nens, nz, ny, nx) broadcast."""
    t = torch.as_tensor(np.asarray(prof, np.float64), dtype=state.meta.tdtype,
                        device=state.device)
    return t[None, :, None, None].expand(state.grid.field_shape)


def _to_device(state: CouplerState, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=state.meta.tdtype,
                           device=state.device)


# ---------------------------------------------------------------------------
# thermal (reference dynamics...h:1338-1419, thermal() :1086-1103)
# ---------------------------------------------------------------------------

def init_thermal(state: CouplerState):
    state = state.set_options(bc_x=BC_PERIODIC, bc_y=BC_PERIODIC, bc_z=BC_WALL,
                              latitude=0.0)
    g = state.grid
    p = _phys(state)
    nq = 3
    qp, qw = gauss_legendre_points_weights(nq)  # on [0, 1]

    kk = np.arange(g.nz)
    jj = np.arange(g.ny)
    ii = np.arange(g.nx)
    xq = (ii[:, None] + 0.5) * g.dx + (qp[None, :] - 0.5) * g.dx
    yq = (jj[:, None] + 0.5) * g.dy + (qp[None, :] - 0.5) * g.dy
    zq = (kk[:, None] + 0.5) * g.dz + (qp[None, :] - 0.5) * g.dz
    if g.sim2d:
        yq = np.full_like(yq, g.ylen / 2.0)

    # broadcast to (nz, ny, nx, qz, qy, qx)
    X = xq[None, None, :, None, None, :]
    Y = yq[None, :, None, None, :, None]
    Z = zq[:, None, None, :, None, None]

    hr, ht = hydro_const_theta(Z, p["grav"], p["C0"], p["cp_d"], p["p0"],
                               p["gamma"], p["R_d"])
    theta_d = ht + sample_ellipse_cosine(
        2.0, X, Y, Z, g.xlen / 2, g.ylen / 2, 2000.0, 2000.0, 2000.0, 2000.0)
    rho_d = hr
    p_d = p["C0"] * (rho_d * theta_d) ** p["gamma"]
    temp = p_d / rho_d / p["R_d"]
    sat_pv = saturation_vapor_pressure(temp)
    sat_rv = sat_pv / p["R_v"] / temp
    rho_v = sample_ellipse_cosine(
        0.8, X, Y, Z, g.xlen / 2, g.ylen / 2, 2000.0, 2000.0, 2000.0,
        2000.0) * sat_rv
    press = rho_d * p["R_d"] * temp + rho_v * p["R_v"] * temp
    rho = rho_d + rho_v
    theta = (press / p["C0"]) ** (1.0 / p["gamma"]) / rho

    W = (qw[None, None, None, :, None, None] * qw[None, None, None, None, :, None]
         * qw[None, None, None, None, None, :])

    def avg(f):
        return (f * W).sum(axis=(3, 4, 5))

    hr_b = np.broadcast_to(hr, rho.shape)
    ht_b = np.broadcast_to(ht, rho.shape)
    s, tr = _zero_dyn(state)
    s[IDR] = _to_device(state, avg(rho - hr_b)[None])
    s[IDT] = _to_device(state, avg(rho * theta - hr_b * ht_b)[None])
    # u = v = w = 0 for the thermal case
    tr[state.meta.idWV] = _to_device(state, avg(rho_v)[None])

    # Edge profiles from the analytic background; cell averages with the
    # same 3-point Gauss-Legendre rule as the reference (dynamics...h:1396-1408).
    ze = np.arange(g.nz + 1) * g.dz
    hr_e, ht_e = hydro_const_theta(ze, p["grav"], p["C0"], p["cp_d"], p["p0"],
                                   p["gamma"], p["R_d"])
    k = np.arange(g.nz)
    zq3 = (k[:, None] + 0.5) * g.dz + (qp[None, :] - 0.5) * g.dz
    hr_q, ht_q = hydro_const_theta(zq3, p["grav"], p["C0"], p["cp_d"], p["p0"],
                                   p["gamma"], p["R_d"])
    hr_c = (hr_q * qw).sum(1)
    hrt_c = (hr_q * ht_q * qw).sum(1)
    state = _store_hy(state, hr_c, hrt_c, hr_e, hr_e * ht_e)
    return state, s, tr


# ---------------------------------------------------------------------------
# supercell (reference dynamics...h:1687-1887)
# ---------------------------------------------------------------------------

def init_supercell(state: CouplerState, ord: int = 5):
    state = state.set_options(bc_x=BC_PERIODIC, bc_y=BC_PERIODIC, bc_z=BC_WALL,
                              latitude=0.0)
    g = state.grid
    p = _phys(state)
    z_0, z_trop, T_0, T_trop, T_top, p_0 = 0.0, 12000.0, 300.0, 213.0, 213.0, 100000.0
    ztop = g.zlen
    R_d, R_v, grav = p["R_d"], p["R_v"], p["grav"]

    gp, gw = gll_points(ord), gll_weights(ord)

    def qv_of(z, press_dry):
        temp = supercell_temperature(z, z_0, z_trop, ztop, T_0, T_trop, T_top)
        qvs = supercell_sat_mix_dry(press_dry, temp)
        relhum = supercell_relhum(z, z_0, z_trop)
        relhum = np.where(relhum * qvs > 0.014, 0.014 / qvs, relhum)
        return np.minimum(0.014, qvs * relhum), temp

    # --- hydrostatic pressure at GLL points by integrating dp/p between
    # consecutive GLL points with an ord-point GLL sub-quadrature
    # (dynamics...h:1736-1774) ---
    k = np.arange(g.nz)
    cellmid = (k + 0.5) * g.dz
    seg_b = cellmid[:, None] + gp[None, :-1] * g.dz
    seg_t = cellmid[:, None] + gp[None, 1:] * g.dz
    seg_m = 0.5 * (seg_b + seg_t)
    seg_dz = g.dz * (gp[1:] - gp[:-1])[None, :]
    zloc = seg_m[:, :, None] + seg_dz[:, :, None] * gp[None, None, :]
    press_dry = supercell_pressure_dry(zloc, z_0, z_trop, ztop, T_0, T_trop,
                                       T_top, p_0, R_d, grav)
    qv, temp = qv_of(zloc, press_dry)
    integrand = -(1.0 + qv) * grav / (R_d + qv * R_v) / temp
    tot = (integrand * gw[None, None, :]).sum(-1) * seg_dz  # (nz, ord-1)
    # p(k,kk+1) = p(k,kk) * exp(tot(k,kk)); p(k+1,0) = p(k,ord-1)
    logp = np.log(p_0) + np.concatenate([[0.0], np.cumsum(tot.ravel())])
    idx = k[:, None] * (ord - 1) + np.arange(ord)[None, :]
    press_gll = np.exp(logp[idx])  # (nz, ord)

    # --- hydrostatic background at GLL points (dynamics...h:1777-1805) ---
    z_gll = cellmid[:, None] + gp[None, :] * g.dz
    press_tmp = supercell_pressure_dry(z_gll, z_0, z_trop, ztop, T_0, T_trop,
                                       T_top, p_0, R_d, grav)
    qv_g, temp_g = qv_of(z_gll, press_tmp)
    dens_dry = press_gll / (R_d + qv_g * R_v) / temp_g
    dens_vap = qv_g * dens_dry
    dens = dens_dry + dens_vap
    dens_theta = (press_gll / p["C0"]) ** (1.0 / p["gamma"])

    hr_e = np.concatenate([dens[:, 0], dens[-1:, -1]])
    hrt_e = np.concatenate([dens_theta[:, 0], dens_theta[-1:, -1]])
    hr_c = (dens * gw).sum(1)
    hrt_c = (dens_theta * gw).sum(1)
    vap_c = (dens_vap * gw).sum(1)

    # --- initial state: the z-quadrature of (dens * u(z)); rho' and
    # (rho theta)' integrate to zero (dynamics...h:1843-1886) ---
    zs, us, uc = 5000.0, 30.0, 15.0
    uvel = np.where(z_gll < zs, us * (z_gll / zs) - uc, us - uc)
    ru_c = (dens * uvel * gw).sum(1)

    s, tr = _zero_dyn(state)
    s[IDU] = _column(state, ru_c)
    tr[state.meta.idWV] = _column(state, vap_c)

    state = _store_hy(state, hr_c, hrt_c, hr_e, hrt_e)
    return state, s, tr


# ---------------------------------------------------------------------------
# city / building (reference dynamics...h:1421-1652)
# ---------------------------------------------------------------------------

# The reference's building heights, shipped with the JAX package.
CITY_HEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "..", "miniweatherml_tpu", "assets",
                            "city_heights_mt19937_17.npy")


def _hydro_theta_profiles(state: CouplerState, nq: int):
    """Cell-average + edge hydrostatic profiles for the constant-theta
    background via nq-point GLL quadrature in z (dynamics...h:1396-1419)."""
    g = state.grid
    p = _phys(state)
    qp, qw = gll_points(nq), gll_weights(nq)
    k = np.arange(g.nz)
    zq = (k[:, None] + 0.5) * g.dz + qp[None, :] * g.dz
    hr_q, ht_q = hydro_const_theta(zq, p["grav"], p["C0"], p["cp_d"], p["p0"],
                                   p["gamma"], p["R_d"])
    hr_c = (hr_q * qw).sum(1)
    hrt_c = (hr_q * ht_q * qw).sum(1)
    ze = np.arange(g.nz + 1) * g.dz
    hr_e, ht_e = hydro_const_theta(ze, p["grav"], p["C0"], p["cp_d"], p["p0"],
                                   p["gamma"], p["R_d"])
    return hr_c, hrt_c, hr_e, hr_e * ht_e


def _uniform_flow_profiles(state: CouplerState, nq: int = 9):
    """rho/theta profiles for city/building: hydro-const-theta if gravity on,
    else uniform rho=1.15, theta=300 (dynamics...h:1475-1547)."""
    g = state.grid
    if state.get_option("enable_gravity", True):
        return _hydro_theta_profiles(state, nq)
    return (np.full(g.nz, 1.15), np.full(g.nz, 1.15 * 300.0),
            np.full(g.nz + 1, 1.15), np.full(g.nz + 1, 1.15 * 300.0))


def _uniform_flow_state(state: CouplerState, hr_c):
    """State for u=20 uniform flow in hydrostatic balance: the quadrature
    averages of (rho - hr) and (rho theta - hr ht) vanish; rho*u averages to
    hr_c * 20 (a z-only integrand, broadcast on the device)."""
    s, tr = _zero_dyn(state)
    s[IDU] = _column(state, hr_c * 20.0)
    return s, tr


def _city_height_stream(n: int) -> np.ndarray:
    """First ``n`` building-height draws of the reference's RNG
    (dynamics...h:1441-1452: std::mt19937{17} + std::normal_distribution
    {60, 10}), read from the JAX package's asset (numpy's normal draws
    differ from libstdc++'s, so the realized stream ships as data)."""
    stream = np.load(CITY_HEIGHTS)
    if n > stream.size:
        raise ValueError(
            f"city config needs {n} building heights but the shipped "
            f"mt19937(17) stream has {stream.size}; regenerate the asset "
            "with a longer run of the reference RNG expression")
    return stream[:n]


def _immersed_case(state: CouplerState, imm: np.ndarray):
    """Shared tail of city/building: the (nz, ny, nx) mask as the
    ``immersed_proportion`` field (one host-to-device copy), the uniform
    flow and its hydrostatic background."""
    hr_c, hrt_c, hr_e, hrt_e = _uniform_flow_profiles(state, nq=9)
    s, tr = _uniform_flow_state(state, hr_c)
    state = _store_hy(state, hr_c, hrt_c, hr_e, hrt_e)
    mask = _to_device(state, imm.astype(np.float64))
    state = state.replace_fields(immersed_proportion=mask[None].expand(
        state.grid.field_shape).contiguous())
    return state, s, tr


def init_city(state: CouplerState):
    """Random downtown of buildings (reference dynamics...h:1421-1547).

    Building heights ~ N(60, 10) from the reference's exact MT19937(17) +
    std::normal_distribution stream (``_city_height_stream``), consumed
    row-major like the reference's (j, i) loop.
    """
    state = state.set_options(bc_x=BC_PERIODIC, bc_y=BC_PERIODIC, bc_z=BC_WALL,
                              use_immersed_boundaries=True)
    g = state.grid

    building_length = 30
    cells_per_building = max(int(round(building_length / g.dx)), 1)
    buildings_pad = 20
    nblocks_x = (int(g.xlen) // building_length - 2 * buildings_pad) // 3
    nblocks_y = (int(g.ylen) // building_length - 2 * buildings_pad) // 9
    if nblocks_x <= 0 or nblocks_y <= 0:
        # The reference's building loops place nothing when the block
        # counts come out non-positive; small domains run building-free.
        warnings.warn(
            "city domain smaller than the building grid (~1.3 km/side "
            f"needed, got {g.xlen} x {g.ylen} m); proceeding with no "
            "buildings like the reference's zero-iteration loops "
            "(reference city domain: 2000 x 2000 m, input_city.yaml)")
        nblocks_x = max(nblocks_x, 0)
        nblocks_y = max(nblocks_y, 0)
    nbuildings_x = nblocks_x * 3
    nbuildings_y = nblocks_y * 9

    i = np.arange(g.nx)
    j = np.arange(g.ny)
    k = np.arange(g.nz)
    if nbuildings_x > 0 and nbuildings_y > 0:
        heights = _city_height_stream(nbuildings_y * nbuildings_x).reshape(
            nbuildings_y, nbuildings_x)
        inorm = i // cells_per_building - buildings_pad
        jnorm = j // cells_per_building - buildings_pad
        in_x = (inorm >= 0) & (inorm < nbuildings_x) & (inorm % 3 < 2)
        in_y = (jnorm >= 0) & (jnorm < nbuildings_y) & (jnorm % 9 < 8)
        jj, ii = np.meshgrid(np.clip(jnorm, 0, nbuildings_y - 1),
                             np.clip(inorm, 0, nbuildings_x - 1),
                             indexing="ij")
        hmap = np.where(in_y[:, None] & in_x[None, :], heights[jj, ii], -1.0)
    else:
        hmap = np.full((g.ny, g.nx), -1.0)
    kmax = np.ceil(hmap / g.dz)  # immersed when k <= ceil(h/dz)
    imm = (k[:, None, None] <= kmax[None, :, :]) & (hmap[None] >= 0.0)
    return _immersed_case(state, imm)


def init_building(state: CouplerState):
    """Single box building (reference dynamics...h:1549-1652)."""
    state = state.set_options(bc_x=BC_PERIODIC, bc_y=BC_PERIODIC, bc_z=BC_WALL,
                              use_immersed_boundaries=True)
    g = state.grid
    x0, y0 = 0.3 * g.nx, 0.5 * g.ny
    xr = yr = 0.05 * g.ny
    i = np.arange(g.nx)
    j = np.arange(g.ny)
    k = np.arange(g.nz)
    box = (np.abs(i[None, :] - x0) <= xr) & (np.abs(j[:, None] - y0) <= yr)
    imm = box[None, :, :] & (k[:, None, None] <= 0.2 * g.nz)
    return _immersed_case(state, imm)

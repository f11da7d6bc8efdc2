"""The supercell initial state, derived again from the configuration.

Frozen from ``miniweatherml_tpu_torch/dycore/init_cases.py``
(``init_supercell`` and the profile helpers it calls) and
``miniweatherml_tpu_torch/ops/gll.py`` at commit b9c5862; the thermal bubble
from ``miniweatherml_tpu_torch/physics/perturb.py``.  Reference:
dynamics_euler_stratified_wenofv.h:1687-1887 and perturb_temperature.h:43-65.
Frozen: later edits of those files do not reach it, and it imports nothing
of the program.

Every supercell integrand depends only on z, so the profiles are 1-D
float64 numpy arrays on the host, broadcast over (y, x) on the device in
the run's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from numpy.polynomial import legendre as npleg

from .dycore import BC_PERIODIC, BC_WALL, IDU


def _gll_nodes_unit(n):
    c = np.zeros(n)
    c[n - 1] = 1.0
    interior = npleg.legroots(npleg.legder(c))
    return np.concatenate(([-1.0], np.sort(interior), [1.0]))


def gll_points(n):
    """GLL points on [-1/2, 1/2]."""
    return 0.5 * _gll_nodes_unit(n)


def gll_weights(n):
    """GLL weights normalized to sum to 1."""
    x = _gll_nodes_unit(n)
    c = np.zeros(n)
    c[n - 1] = 1.0
    w = 2.0 / (n * (n - 1) * npleg.legval(x, c) ** 2)
    return w / w.sum()


def _temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top):
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    return np.where(z <= z_trop, T_0 - lapse_lo * (z - z_0),
                    T_trop - lapse_hi * (z - z_trop))


def _pressure_dry(z, z_0, z_trop, z_top, T_0, T_trop, T_top, p_0, R_d, grav):
    T = _temperature(z, z_0, z_trop, z_top, T_0, T_trop, T_top)
    lapse_lo = -(T_trop - T_0) / (z_trop - z_0)
    p_lo = p_0 * (T / T_0) ** (grav / (R_d * lapse_lo))
    p_trop = p_0 * (T_trop / T_0) ** (grav / (R_d * lapse_lo))
    lapse_hi = -(T_top - T_trop) / (z_top - z_trop)
    if lapse_hi != 0.0:
        p_hi = p_trop * (T / T_trop) ** (grav / (R_d * lapse_hi))
    else:
        p_hi = p_trop * np.exp(-grav * (z - z_trop) / (R_d * T_trop))
    return np.where(z <= z_trop, p_lo, p_hi)


def _relhum(z, z_0, z_trop):
    return np.where(z <= z_trop, 1.0 - 0.75 * (z / z_trop) ** 1.25, 0.25)


def _sat_mix_dry(press, T):
    return 380.0 / press * np.exp(17.27 * (T - 273.0) / (T - 36.0))


def constants(micro):
    """The dycore's constants for a microphysics module's gas constants
    (dynamics...h:1227-1248)."""
    c = dict(R_d=micro.R_D, cp_d=micro.CP_D, R_v=micro.R_V, p0=micro.P0,
             grav=micro.GRAV)
    cv_d = c["cp_d"] - c["R_d"]
    gamma = c["cp_d"] / cv_d
    kappa = c["R_d"] / c["cp_d"]
    c.update(gamma=gamma, C0=(c["R_d"] * c["p0"] ** (-kappa)) ** gamma,
             fcor=2.0 * 7.292115e-5 * math.sin(0.0), bc_x=BC_PERIODIC,
             bc_y=BC_PERIODIC, bc_z=BC_WALL)
    return c


def profiles(grid, c, ord_: int = 5):
    """(hyc, hyt, hye, hyte, ru_c, vap_c): the hydrostatic background at
    cells and faces, and the cell averages of rho u and of the vapor
    density, float64 (nz,) or (nz + 1,) arrays."""
    z_0, z_trop, T_0, T_trop, T_top, p_0 = (0.0, 12000.0, 300.0, 213.0,
                                            213.0, 100000.0)
    ztop = grid.zlen
    R_d, R_v, grav = c["R_d"], c["R_v"], c["grav"]
    gp, gw = gll_points(ord_), gll_weights(ord_)

    def qv_of(z, press_dry):
        temp = _temperature(z, z_0, z_trop, ztop, T_0, T_trop, T_top)
        qvs = _sat_mix_dry(press_dry, temp)
        relhum = _relhum(z, z_0, z_trop)
        relhum = np.where(relhum * qvs > 0.014, 0.014 / qvs, relhum)
        return np.minimum(0.014, qvs * relhum), temp

    k = np.arange(grid.nz)
    cellmid = (k + 0.5) * grid.dz
    seg_b = cellmid[:, None] + gp[None, :-1] * grid.dz
    seg_t = cellmid[:, None] + gp[None, 1:] * grid.dz
    seg_m = 0.5 * (seg_b + seg_t)
    seg_dz = grid.dz * (gp[1:] - gp[:-1])[None, :]
    zloc = seg_m[:, :, None] + seg_dz[:, :, None] * gp[None, None, :]
    press_dry = _pressure_dry(zloc, z_0, z_trop, ztop, T_0, T_trop, T_top,
                              p_0, R_d, grav)
    qv, temp = qv_of(zloc, press_dry)
    integrand = -(1.0 + qv) * grav / (R_d + qv * R_v) / temp
    tot = (integrand * gw[None, None, :]).sum(-1) * seg_dz
    logp = np.log(p_0) + np.concatenate([[0.0], np.cumsum(tot.ravel())])
    idx = k[:, None] * (ord_ - 1) + np.arange(ord_)[None, :]
    press_gll = np.exp(logp[idx])

    z_gll = cellmid[:, None] + gp[None, :] * grid.dz
    press_tmp = _pressure_dry(z_gll, z_0, z_trop, ztop, T_0, T_trop, T_top,
                              p_0, R_d, grav)
    qv_g, temp_g = qv_of(z_gll, press_tmp)
    dens_dry = press_gll / (R_d + qv_g * R_v) / temp_g
    dens_vap = qv_g * dens_dry
    dens = dens_dry + dens_vap
    dens_theta = (press_gll / c["C0"]) ** (1.0 / c["gamma"])

    hye = np.concatenate([dens[:, 0], dens[-1:, -1]])
    hyte = np.concatenate([dens_theta[:, 0], dens_theta[-1:, -1]])
    hyc = (dens * gw).sum(1)
    hyt = (dens_theta * gw).sum(1)
    vap_c = (dens_vap * gw).sum(1)
    zs, us, uc = 5000.0, 30.0, 15.0
    uvel = np.where(z_gll < zs, us * (z_gll / zs) - uc, us - uc)
    ru_c = (dens * uvel * gw).sum(1)
    return hyc, hyt, hye, hyte, ru_c, vap_c


def thermal_bubble(grid, dtype, device):
    """The +5 K cos^2 bubble at the domain centre, z = 1.5 km
    (perturb_temperature.h:43-65), (nz, ny, nx)."""
    x = (torch.arange(grid.nx, dtype=dtype, device=device) + 0.5) * grid.dx
    y = (torch.arange(grid.ny, dtype=dtype, device=device) + 0.5) * grid.dy
    z = (torch.arange(grid.nz, dtype=dtype, device=device) + 0.5) * grid.dz
    xn = (x - grid.xlen / 2) / 10000.0
    yn = (y - grid.ylen / 2) / 10000.0
    zn = (z - 1500.0) / 1500.0
    rad = torch.sqrt(xn[None, None, :] ** 2 + yn[None, :, None] ** 2
                     + zn[:, None, None] ** 2)
    return torch.where(rad < 1.0, 5.0 * torch.cos(math.pi * rad / 2.0) ** 2,
                       0.0)


def perturb(f, grid, dtype, device):
    """The thermal bubble, added to the built state after the steps' own
    set-up (the nudging column is taken before it, driver.cpp:60-61)."""
    f["temp"] = f["temp"] + thermal_bubble(grid, dtype, device)[None]
    return f


def column(prof, grid, dtype, device):
    """A z profile as a (nens, nz, ny, nx) tensor."""
    t = torch.as_tensor(np.asarray(prof, np.float64), dtype=dtype,
                        device=device)
    return t[None, :, None, None].expand(grid.nens, grid.nz, grid.ny,
                                         grid.nx).contiguous()


def ensemble(prof, grid, dtype, device):
    """A profile as (nens, len) in the run's dtype."""
    t = torch.as_tensor(np.asarray(prof, np.float64), dtype=dtype,
                        device=device)
    return t[None, :].expand(grid.nens, -1).contiguous()


def initial_dynamics(grid, c, ntr, idwv, dtype, device):
    """(hy, s, tr): the backgrounds (nens, nz[+1]) and the dynamics state
    and tracers of the supercell (rho' = (rho theta)' = 0, rho u and the
    vapor from the z quadrature)."""
    hyc, hyt, hye, hyte, ru_c, vap_c = profiles(grid, c)
    hy = tuple(ensemble(p, grid, dtype, device) for p in (hyc, hyt, hye,
                                                          hyte))
    shape = (grid.nens, grid.nz, grid.ny, grid.nx)
    s = torch.zeros((5,) + shape, dtype=dtype, device=device)
    tr = torch.zeros((ntr,) + shape, dtype=dtype, device=device)
    s[IDU] = column(ru_c, grid, dtype, device)
    tr[idwv] = column(vap_c, grid, dtype, device)
    return hy, s, tr

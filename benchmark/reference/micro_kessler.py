"""Plain PyTorch reference of the Kessler module's step.

The scheme is frozen from ``tests/oracle_kessler.py`` at commit b9c5862
(the loop-ordered transliteration of the reference
model/modules/microphysics_kessler.h:234-339), vectorized over columns: the
loops over cells become tensor operations in the same order.  The module
wrapper (densities to mixing ratios and back, theta against the pre-micro
exner) follows microphysics_kessler.h:99-162.  Frozen: it does not follow
later edits of those files, and it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

# gas constants (microphysics_kessler.h:30-41)
R_D, CP_D, R_V, CP_V, P0, GRAV = 287.0, 1003.0, 461.0, 1859.0, 1.0e5, 9.81
# (name, positive, adds_mass), in the order the module registers them
TRACERS = (("water_vapor", True, True), ("cloud_liquid", True, True),
           ("precip_liquid", True, True))
# the module's other fields: name -> shape kind ("surface": (nens, ny, nx))
FIELDS = {"precl": "surface"}


def kessler(theta, qv, qc, qr, rho, dz, pk, dt, Rd, cp, p0):
    """One Kessler call on (nens, nz, ny, nx) fields, bottom-up, uniform
    ``dz``: the oracle's loops as tensor operations.  Returns (theta, qv,
    qc, qr, precl) and the sub-cycle count."""
    psl = p0 / 100.0
    rhoqr, lv = 1000.0, 2.5e6
    nz = theta.shape[1]
    r = 0.001 * rho
    rhalf = torch.sqrt(rho[:, :1] / rho)
    pc = 3.8 / (pk ** (cp / Rd) * psl)
    velqr = 36.34 * (qr * r) ** 0.1364 * rhalf
    # the global minimum stable step over interior cells (:262-280)
    v_lo = velqr[:, :nz - 1]
    dt_cells = torch.where(v_lo > 1.0e-10, 0.8 * dz / v_lo,
                           torch.full_like(v_lo, dt))
    dt_max = min(dt, float(dt_cells.min()))
    rainsplit = math.ceil(dt / dt_max)
    dt0 = dt / float(rainsplit)
    precl = torch.zeros_like(theta[:, 0])
    for _ in range(rainsplit):
        precl = precl + rho[:, 0] * qr[:, 0] * velqr[:, 0] / rhoqr
        sed = torch.empty_like(qr)
        sed[:, nz - 1] = -dt0 * qr[:, nz - 1] * velqr[:, nz - 1] / (0.5 * dz)
        flux = r * qr * velqr
        sed[:, :nz - 1] = dt0 * (flux[:, 1:] - flux[:, :-1]) / (
            r[:, :nz - 1] * dz)
        del flux
        qrprod = qc - (qc - dt0 * torch.clamp(0.001 * (qc - 0.001), min=0.0)
                       ) / (1.0 + dt0 * 2.2 * qr ** 0.875)
        qc = torch.clamp(qc - qrprod, min=0.0)
        qr = torch.clamp(qr + qrprod + sed, min=0.0)
        del qrprod, sed
        tmp = pk * theta - 36.0
        qvs = pc * torch.exp(17.27 * (pk * theta - 273.0) / tmp)
        prod = (qv - qvs) / (1.0 + qvs * (4093.0 * lv / cp) / (tmp * tmp))
        rq = r * qr
        tmp1 = dt0 * ((1.6 + 124.9 * rq ** 0.2046) * rq ** 0.525
                      / (2550000.0 * pc / (3.8 * qvs) + 540000.0)) * (
            torch.clamp(qvs - qv, min=0.0) / (r * qvs))
        tmp2 = torch.clamp(-prod - qc, min=0.0)
        ern = torch.minimum(tmp1, torch.minimum(tmp2, qr))
        cond = torch.maximum(prod, -qc)
        theta = theta + lv / (cp * pk) * (cond - ern)
        qv = torch.clamp(qv - cond + ern, min=0.0)
        qc = qc + cond
        qr = qr - ern
        velqr = 36.34 * (qr * r) ** 0.1364 * rhalf
    return theta, qv, qc, qr, precl / float(rainsplit), rainsplit


class Micro:
    """The Kessler module's step on a dict of coupler fields."""

    name = "kessler"

    def __init__(self, cfg: dict, root: str, dtype, device):
        self.dtype, self.device = dtype, device
        self.rainsplit: list[int] = []

    def time_step(self, f: dict, dt: float, grid) -> dict:
        rho_d, temp = f["density_dry"], f["temp"]
        rho_v = f["water_vapor"]
        qv = rho_v / rho_d
        qc = f["cloud_liquid"] / rho_d
        qr = f["precip_liquid"] / rho_d
        pressure = R_D * rho_d * temp + R_V * rho_v * temp
        exner = (pressure / P0) ** (R_D / CP_D)
        theta, qv, qc, qr, precl, nsub = kessler(
            temp / exner, qv, qc, qr, rho_d, grid.dz, exner, dt, R_D, CP_D,
            P0)
        self.rainsplit.append(nsub)
        out = dict(f)
        out.update(water_vapor=qv * rho_d, cloud_liquid=qc * rho_d,
                   precip_liquid=qr * rho_d, temp=theta * exner, precl=precl)
        return out

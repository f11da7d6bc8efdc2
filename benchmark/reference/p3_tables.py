"""The P3 lookup tables of the plain reference: the parser of the v4.1.1
ASCII table, the table indices and the multilinear interpolation, and the
generated rain tables.

Translated into NumPy and PyTorch from the JAX package's
``miniweatherml_tpu/physics/p3_tables.py`` at commit b9c5862 (its gather
path: ``load_p3_tables``, ``ice_table_indices``,
``rain_collection_index``, ``interp_ice``, ``interp_collect``,
``generate_rain_tables``, ``rain_size_index``, ``interp_rain``), and
frozen here: a later change to either package does not move it.  The
reference's Fortran citations (micro_p3.F90) are the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

ISIZE, RIMSIZE, DENSIZE, RCOLLSIZE = 50, 4, 5, 30
DUM1_C = 1.0 / (0.1 * math.log10(261.7))   # micro_p3_utils.F90:34
QSMALL = 1.0e-14
RHO_H2O = 1000.0
MU_R = 1.0                 # constant rain shape (micro_p3_utils.F90:33)
F1R, F2R = 0.78, 0.32      # ventilation coefficients (:138-139)


@dataclass
class Tables:
    """ice: (densize, rimsize, isize, 12); collect: (densize, rimsize,
    isize, rcollsize, 2) as log10 (p3_init_a:192-194); on a device in a
    dtype once ``to`` has run."""

    ice: object
    collect: object

    def to(self, device, dtype) -> "Tables":
        return Tables(torch.as_tensor(self.ice).to(device, dtype),
                      torch.as_tensor(self.collect).to(device, dtype))


def _tokens(f, n: int) -> list:
    vals: list = []
    while len(vals) < n:
        line = f.readline()
        if not line:
            raise ValueError("truncated P3 lookup table")
        vals += line.split()
    return vals


def load_tables(path: str) -> Tables:
    """Parse the v4.1.1 table (p3_init_a's row layout): per density and
    rime fraction, 50 ice rows of 17 values (i, ?, dum, dum, k1..k8, dum,
    k9..k12), then 50 x 30 collection rows of 8 (i, j, dum x3, k1, k2,
    dum)."""
    ice = np.zeros((DENSIZE, RIMSIZE, ISIZE, 12))
    coll = np.zeros((DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, 2))
    with open(path) as f:
        f.readline()                               # version header
        for jj in range(DENSIZE):
            for ii in range(RIMSIZE):
                for i in range(ISIZE):
                    v = [float(x) for x in _tokens(f, 17)]
                    ice[jj, ii, i, :8] = v[4:12]
                    ice[jj, ii, i, 8:] = v[13:17]
                for i in range(ISIZE):
                    for j in range(RCOLLSIZE):
                        v = [float(x) for x in _tokens(f, 8)]
                        coll[jj, ii, i, j, 0] = math.log10(v[5])
                        coll[jj, ii, i, j, 1] = math.log10(v[6])
    return Tables(ice, coll)


def _floor_int(x):
    return torch.floor(x).to(torch.int64)


def ice_indices(qi, ni, qm, rhop):
    """find_lookupTable_indices_1a (micro_p3.F90:1620-1677): 0-based base
    indices and fractions on the size, rime-fraction and density axes."""
    dum1 = (torch.log10(qi.clamp(min=QSMALL) / ni.clamp(min=1e-30))
            + 18.0) * DUM1_C - 10.0
    dumi = _floor_int(dum1).clamp(1, ISIZE - 1)
    dum1 = dum1.clamp(1.0, float(ISIZE))
    dum4 = (qm / qi.clamp(min=QSMALL)) * 3.0 + 1.0
    dumii = _floor_int(dum4).clamp(1, RIMSIZE - 1)
    dum4 = dum4.clamp(1.0, float(RIMSIZE))
    dum5 = torch.where(rhop <= 650.0, (rhop - 50.0) * 0.005 + 1.0,
                       (rhop - 650.0) * 0.004 + 4.0)
    dumjj = _floor_int(dum5).clamp(1, DENSIZE - 1)
    dum5 = dum5.clamp(1.0, float(DENSIZE))
    return (dumi - 1, dum1 - dumi.to(dum1.dtype),
            dumii - 1, dum4 - dumii.to(dum4.dtype),
            dumjj - 1, dum5 - dumjj.to(dum5.dtype))


def rain_collection_index(qr, nr):
    """find_lookupTable_indices_1b (micro_p3.F90:1681-1720)."""
    has_rain = (qr >= QSMALL) & (nr > 0.0)
    dumlr = (qr.clamp(min=QSMALL)
             / (math.pi * RHO_H2O * nr.clamp(min=1e-30))) ** (1.0 / 3.0)
    dum3 = (torch.log10(dumlr) + 5.0) * 10.70415
    dumj = _floor_int(dum3).clamp(1, RCOLLSIZE - 1)
    dum3 = dum3.clamp(1.0, float(RCOLLSIZE))
    dumj = torch.where(has_rain, dumj, 1)
    dum3 = torch.where(has_rain, dum3, 1.0)
    return dumj - 1, dum3 - dumj.to(dum3.dtype)


def interp_ice(tab: Tables, col: int, i0, fi, ii0, fii, jj0, fjj):
    """Trilinear interpolation of ice column ``col`` (1-based, as the
    Fortran's ``index``; access_lookup_table, micro_p3.F90:1508-1545)."""
    t = tab.ice[..., col - 1]

    def lin_i(jj, ii):
        a = t[jj, ii, i0]
        return a + fi * (t[jj, ii, i0 + 1] - a)

    def lin_ii(jj):
        a = lin_i(jj, ii0)
        return a + fii * (lin_i(jj, ii0 + 1) - a)

    a = lin_ii(jj0)
    return a + fjj * (lin_ii(jj0 + 1) - a)


def interp_collect(tab: Tables, col: int, i0, fi, ii0, fii, jj0, fjj, j0,
                   fj):
    """Quadrilinear interpolation of the ice-rain collection table, stored
    as log10 and exponentiated after (access_lookup_table_coll)."""
    t = tab.collect[..., col - 1]

    def lin_j(jj, ii, i):
        a = t[jj, ii, i, j0]
        return a + fj * (t[jj, ii, i, j0 + 1] - a)

    def lin_i(jj, ii):
        a = lin_j(jj, ii, i0)
        return a + fi * (lin_j(jj, ii, i0 + 1) - a)

    def lin_ii(jj):
        a = lin_i(jj, ii0)
        return a + fii * (lin_i(jj, ii0 + 1) - a)

    a = lin_ii(jj0)
    return 10.0 ** (a + fjj * (lin_ii(jj0 + 1) - a))


@lru_cache(maxsize=None)
def rain_tables():
    """p3_init_b's integrals over the rain PSD at mu_r = 1
    (micro_p3.F90:236-345): (vn, vm, revap), each (300,) float64."""
    jj = np.arange(1, 301, dtype=np.float64)
    dm = np.where(jj <= 20, (jj * 10.0 - 5.0) * 1e-6,
                  ((jj - 20) * 30.0 + 195.0) * 1e-6)
    lamr = (MU_R + 1.0) / dm
    dd = 2.0
    kk = np.arange(1, 10001, dtype=np.float64)
    dia = (kk * dd - dd * 0.5) * 1e-6
    amg = np.pi / 6.0 * 997.0 * dia ** 3 * 1000.0
    vt = np.where(
        dia * 1e6 <= 134.43, 4.5795e3 * amg ** (2.0 / 3.0),
        np.where(dia * 1e6 < 1511.64, 4.962e1 * amg ** (1.0 / 3.0),
                 np.where(dia * 1e6 < 3477.84, 1.732e1 * amg ** (1.0 / 6.0),
                          9.17)))
    w_n = 10.0 ** (MU_R * np.log10(dia) + 4.0 * MU_R)
    w_m = 10.0 ** ((MU_R + 3.0) * np.log10(dia) + 4.0 * MU_R)
    w_v = np.sqrt(vt * dia) * 10.0 ** ((MU_R + 1.0) * np.log10(dia)
                                       + 3.0 * MU_R)
    e = np.exp(-np.outer(lamr, dia)) * (dd * 1e-6)
    vn = (e @ (vt * w_n)) / np.maximum(e @ w_n, 1e-30)
    vm = (e @ (vt * w_m)) / np.maximum(e @ w_m, 1e-30)
    revap = 10.0 ** (np.log10(np.maximum(e @ w_v, 1e-30))
                     + (MU_R + 1.0) * np.log10(lamr) - 3.0 * MU_R)
    return vn, vm, revap


def rain_size_index(dm):
    """find_lookupTable_indices_3's size mapping (micro_p3.F90:1725-1770):
    0-based index into the 300-entry rain tables and its fraction."""
    small = dm <= 195.0e-6
    rd_small = ((dm * 1e6 + 5.0) * 0.1).clamp(1.0, 20.0)
    rd_large = ((dm * 1e6 - 195.0) / 30.0 + 20.0).clamp(20.0, 300.0)
    rdum = torch.where(small, rd_small, rd_large)
    idum = torch.where(small, _floor_int(rd_small).clamp(1, 20),
                       _floor_int(rd_large).clamp(20, 299))
    return idum - 1, rdum - idum.to(rdum.dtype)


def interp_rain(row, i0, fi):
    """Linear interpolation into a (300,) rain table on the device."""
    i0 = i0.clamp(0, row.shape[0] - 2)
    a = row[i0]
    return a + fi * (row[i0 + 1] - a)

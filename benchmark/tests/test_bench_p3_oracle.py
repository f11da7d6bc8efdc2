"""The reference's P3 scheme against an independent transliteration of the
Fortran P3 (``tests/oracle_p3.py``, written from the vendored SCREAM P3
v4.1.1 ``micro_p3.F90``, column by column in NumPy): one whole step of
part1, part2, sedimentation, homogeneous freezing and part3 on canned
columns of every regime, in float64, at the table tier with the
benchmark's own table parser.  The columns keep every sedimentation
Courant number under 0.9, so both take one upwind sub-step."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmark.reference import p3_scheme as S
from benchmark.reference import p3_tables as T

from conftest import ROOT

NZ = 24
KINDS = ("warm", "cold", "mixed", "wetgrowth", "capped", "clearsky")
SCALES = dict(qc=1e-3, nc=1e8, qr=1e-3, nr=1e5, qi=1e-3, ni=1e5, qm=1e-3,
              bm=1e-6, qv=1e-2, theta=300.0)


@pytest.fixture(scope="module")
def oracle():
    path = os.path.join(ROOT, "tests", "oracle_p3.py")
    spec = importlib.util.spec_from_file_location("oracle_p3_column", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tables():
    return T.load_tables(os.path.join(
        ROOT, "miniweatherml_tpu", "assets", "p3_lookup_table_1.dat-v4.1.1"))


def _magnus(t, ice=False):
    tc = t - 273.15
    if ice:
        return 611.21 * np.exp(22.587 * tc / (273.86 + tc))
    return 610.94 * np.exp(17.625 * tc / (243.04 + tc))


def _column(kind):
    """Bottom-up columns at 500 m: warm rain; cold ice-supersaturated
    rimed ice; supercooled liquid, rain and rimed ice; wet growth with an
    out-of-range rime density; the in-cloud caps with warm ice; clear air
    with nucleation aloft over a level-skip layer."""
    z = (np.arange(NZ) + 0.5) * 500.0
    base = dict(warm=(295.0, 6.0e-3, 1.0e5), cold=(260.0, 4.0e-3, 6.0e4),
                mixed=(271.0, 5.0e-3, 8.0e4), wetgrowth=(268.0, 4.0e-3, 8.5e4),
                capped=(287.0, 5.0e-3, 9.5e4), clearsky=(284.0, 6.5e-3, 9.8e4))
    t0, lapse, p0 = base[kind]
    temp = t0 - lapse * z
    pres = p0 * (temp / t0) ** (9.80616 / (287.042 * lapse))
    rho_d = pres / (287.042 * temp)
    qsl = _magnus(temp) / (461.505 * temp * rho_d)
    zero = np.zeros(NZ)
    qc = qr = nr = qi = ni = qm = bm = zero
    if kind == "warm":
        qv = 0.85 * qsl
        qc = np.where((z > 1500) & (z < 5000), 8.0e-4, 0.0)
        qr = np.where((z > 500) & (z < 4000), 5.0e-4, 0.0)
        nr = np.where(qr > 0, 8.0e4, 0.0)
    elif kind == "cold":
        qv = 1.10 * _magnus(temp, True) / (461.505 * temp * rho_d)
        qi = np.where((z > 2000) & (z < 9000), 2.0e-4, 0.0)
        ni = np.where(qi > 0, 8.0e4, 0.0)
        qm = 0.3 * qi
        bm = qm / 400.0
    elif kind == "mixed":
        qv = 0.95 * qsl
        qc = np.where((z > 1000) & (z < 6000), 6.0e-4, 0.0)
        qr = np.where(z < 3000, 4.0e-4, 0.0)
        nr = np.where(qr > 0, 6.0e4, 0.0)
        qi = np.where(z > 3500, 3.0e-4, 0.0)
        ni = np.where(qi > 0, 1.0e5, 0.0)
        qm = 0.5 * qi
        bm = qm / 300.0
    elif kind == "wetgrowth":
        qv = 1.0 * qsl
        qc = np.where((z > 500) & (z < 8000), 2.5e-3, 0.0)
        qr = np.where(z < 6000, 2.0e-3, 0.0)
        nr = np.where(qr > 0, 2.0e5, 0.0)
        qi = np.where((z > 1000) & (z < 9000), 4.0e-3, 0.0)
        ni = np.where(qi > 0, 4.0e5, 0.0)
        qm = 0.8 * qi
        bm = np.where(z < 5000, qm / 20.0, qm / 300.0)
    elif kind == "capped":
        qv = 0.9 * qsl
        qc = np.where((z > 1000) & (z < 5000), 7.0e-3, 0.0)
        qr = np.where(z < 4000, 2.0e-2, 0.0)
        nr = np.where(qr > 0, 2.0e6, 0.0)
        qi = np.where(z < 2500, 5.0e-4, 0.0)
        ni = np.where(qi > 0, 2.0e5, 0.0)
        qm = 0.4 * qi
        bm = qm / 500.0
    else:
        e_i = S.qv_sat_ice(torch.tensor(temp), torch.tensor(pres)).numpy()
        qv = np.where(z > 8000, 1.2 * e_i,
                      np.where(z > 4000, 0.3 * e_i, 0.7 * qsl))
    exner = (pres / 1.0e5) ** (287.042 / 1004.64)
    return dict(temp=temp, pres=pres, rho_d=rho_d, qv=qv, qc=qc, qr=qr,
                nr=nr, qi=qi, ni=ni, qm=qm, bm=bm, exner=exner)


@pytest.mark.parametrize("kind", KINDS)
def test_p3_step_matches_the_fortran_transliteration(oracle, tables, kind):
    c = _column(kind)
    dt, dz = 10.0, 500.0
    theta = c["temp"] / c["exner"]
    qv_prev, t_prev = 0.98 * c["qv"], c["temp"] - 0.1

    def col(a):
        return torch.tensor(np.asarray(a, dtype=np.float64)).reshape(
            1, NZ, 1, 1)
    tab = tables.to("cpu", torch.float64)
    out = S.p3_scheme(
        col(c["qc"]), col(np.zeros(NZ)), col(c["qr"]), col(c["nr"]),
        col(c["qi"]), col(c["ni"]), col(c["qm"]), col(c["bm"]),
        col(c["qv"]), col(theta), col(c["exner"]), col(c["pres"]),
        col(c["rho_d"]), dz, dt, tab, qv_prev=col(qv_prev),
        t_prev=col(t_prev))
    ora = oracle.p3_main_step(
        tables, c["qc"], np.zeros(NZ), c["qr"], c["nr"], c["qi"], c["ni"],
        c["qm"], c["bm"], c["qv"], theta, c["exner"], c["pres"],
        c["rho_d"], np.full(NZ, dz), dt, qv_prev=qv_prev, t_prev=t_prev)
    for i, name in enumerate(SCALES):
        np.testing.assert_allclose(
            out[i].reshape(NZ).numpy(), ora[i], rtol=1e-9,
            atol=1e-9 * SCALES[name], err_msg=f"{kind}: {name}")
    for i in (10, 11):
        assert float(out[i]) == pytest.approx(ora[i], rel=1e-9, abs=1e-18)

"""The port's Kessler microphysics against the JAX package and the
independent NumPy oracle (tests/oracle_kessler.py), float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.core.coupler import Grid as JGrid
from miniweatherml_tpu.core.coupler import make_coupler_state as jax_state
from miniweatherml_tpu.physics.kessler import MicrophysicsKessler as JKessler
from miniweatherml_tpu.physics.kessler import \
    kessler_column as jax_kessler_column
from miniweatherml_tpu.physics.kessler import \
    kessler_rainsplit as jax_rainsplit
from miniweatherml_tpu_torch.core.coupler import Grid, make_coupler_state
from miniweatherml_tpu_torch.physics.kessler import (MicrophysicsKessler,
                                                     kessler_column,
                                                     kessler_rainsplit)
from miniweatherml_tpu_torch.physics.kessler_cuda import (
    kessler_step, kessler_step_plain, kessler_subcycle_plain)
from tests.oracle_kessler import kessler_oracle

torch.set_num_threads(1)

RD, CP, P0 = 287.0, 1003.0, 1e5


def _column(nz=32, ncol=4, dz=500.0, seed=0):
    """A moist unstable column (as tests/test_kessler.py), numpy f64."""
    rng = np.random.default_rng(seed)
    z = ((np.arange(nz) + 0.5) * dz)[:, None] * np.ones((1, ncol))
    rho = 1.2 * np.exp(-z / 8000.0)
    p = 1e5 * np.exp(-z / 8000.0)
    exner = (p / 1e5) ** (287.0 / 1003.0)
    theta = 300.0 + 10.0 * z / 20000.0 + rng.uniform(0, 1, (nz, ncol))
    qv = 0.016 * np.exp(-z / 3000.0)
    qc = np.where(z < 5000.0, 1e-4, 0.0) * np.ones((1, ncol))
    qr = np.where(z < 3000.0, 5e-4, 0.0) * np.ones((1, ncol))
    return theta, qv, qc, qr, rho, z, exner


def test_kessler_column_matches_jax_and_oracle():
    """Multi-subcycle (rainsplit > 1), every output and precl."""
    cols = _column()
    dt = 120.0  # long enough to sub-cycle
    t = [torch.as_tensor(a) for a in cols]
    got = kessler_column(*t, dt=dt, Rd=RD, cp=CP, p0=P0)
    ref = jax_kessler_column(*map(jnp.asarray, cols), dt=dt, Rd=RD, cp=CP,
                             p0=P0)
    orc = kessler_oracle(*cols, dt, RD, CP, P0)
    theta, qv, qc, qr, rho, z, pk = cols
    assert int(kessler_rainsplit(t[3], t[4], t[5], dt, z_axis=0)) > 1
    for g, r, o in zip(got, ref, orc):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-18)
        np.testing.assert_allclose(g.numpy(), o, rtol=1e-12, atol=1e-18)


def test_rainsplit_matches_jax():
    theta, qv, qc, qr, rho, z, pk = (a.T[:, :, None, None]
                                     for a in _column(nz=20, ncol=3))
    # (nens=ncol, nz, 1, 1) with the vertical on axis 1
    qr = qr + 5e-3
    for dt in (5.0, 60.0, 300.0):
        a = jax_rainsplit(jnp.asarray(qr), jnp.asarray(rho),
                          jnp.asarray(z), dt)
        b = kessler_rainsplit(torch.as_tensor(qr), torch.as_tensor(rho),
                              torch.as_tensor(z), dt)
        assert b.dtype == torch.int32 and int(b) == int(a)


def test_subcycle_plain_matches_column():
    """The kernel's plain version (uniform dz, given rainsplit) reproduces
    kessler_column on a uniform grid, laid out (nens, nz, ny, nx)."""
    cols = [a.T.reshape(2, 2, 32).transpose(0, 2, 1)[:, :, :, None].copy()
            for a in _column(nz=32, ncol=4)]
    theta, qv, qc, qr, rho, z, pk = map(torch.as_tensor, cols)
    dt = 120.0
    ref = kessler_column(theta, qv, qc, qr, rho, z, pk, dt, RD, CP, P0,
                         z_axis=1)
    rs = kessler_rainsplit(qr, rho, z, dt)
    got = kessler_subcycle_plain(theta, qv, qc, qr, rho, pk, rs, dt, 500.0,
                                 RD, CP, P0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-13,
                                   atol=1e-20)


# Coupler fields of the Kessler time step and the grid they lie on:
# (nens, nz, ny, nx) = (2, 32, 2, 3), 500 m levels.
_STEP_FIELDS = ("density_dry", "temp", "water_vapor", "cloud_liquid",
                "precip_liquid")
_STEP_GRID = dict(nx=3, ny=2, nz=32, nens=2, xlen=3000.0, ylen=2000.0,
                  zlen=16000.0)


def _coupler_fields(seed=5):
    """Moist columns with rain as the coupler holds them (densities and
    temperature), numpy f64, (nens, nz, ny, nx)."""
    rng = np.random.default_rng(seed)
    shape = (2, 32, 2, 3)
    z = ((np.arange(32) + 0.5) * 500.0)[None, :, None, None]
    rho = 1.2 * np.exp(-z / 8000.0) * np.ones(shape)
    temp = 300.0 - 0.0065 * z + rng.uniform(0, 1, shape)
    qv = 0.016 * np.exp(-z / 3000.0) * (0.9 + 0.2 * rng.random(shape))
    qc = np.where(z < 5000.0, 1e-4, 0.0) * rng.random(shape)
    qr = np.where(z < 3000.0, 5e-4, 0.0) + 5e-3 * rng.random(shape)
    return dict(zip(_STEP_FIELDS, (rho, temp, qv * rho, qc * rho, qr * rho)))


def _rainsplit(fields, dt):
    t = {k: torch.as_tensor(v) for k, v in fields.items()}
    z = torch.as_tensor(((np.arange(32) + 0.5) * 500.0)[None, :, None, None])
    return kessler_rainsplit(t["precip_liquid"] / t["density_dry"],
                             t["density_dry"], z, dt)


@pytest.mark.parametrize("dt,nsub", [(2.0, 1), (120.0, 5)])
def test_kessler_step_plain_matches_jax_time_step(dt, nsub):
    """The plain version of the fused step against the JAX package's
    MicrophysicsKessler.time_step on the same coupler fields, f64, rtol
    1e-12: one sub-cycle and several."""
    fields = _coupler_fields()
    rs = _rainsplit(fields, dt)
    assert int(rs) == nsub
    js = JKessler().init(jax_state(JGrid(**_STEP_GRID), dtype="float64"))
    js = js.replace_fields(**{k: jnp.asarray(v) for k, v in fields.items()})
    js = JKessler().time_step(js, dt)
    got = kessler_step_plain(*(torch.as_tensor(fields[k])
                               for k in _STEP_FIELDS), rs, dt, 500.0, RD,
                             461.0, CP, P0)
    names = ("water_vapor", "cloud_liquid", "precip_liquid", "temp", "precl")
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(js[name]),
                                   rtol=1e-12, atol=1e-18, err_msg=name)


def test_kessler_time_step_is_the_plain_step_on_cpu():
    """On the CPU, MicrophysicsKessler.time_step is kessler_step_plain (the
    wrapper's CPU route), bit for bit, with the rainsplit it computes."""
    fields = _coupler_fields(seed=9)
    dt = 120.0
    micro = MicrophysicsKessler()
    ps = micro.init(make_coupler_state(Grid(**_STEP_GRID), dtype="float64",
                                       device="cpu"))
    ps = ps.replace_fields(**{k: torch.as_tensor(v)
                              for k, v in fields.items()})
    out = micro.time_step(ps, dt)
    args = [torch.as_tensor(fields[k]) for k in _STEP_FIELDS]
    rs = _rainsplit(fields, dt)
    assert int(rs) > 1
    want = kessler_step_plain(*args, rs, dt, 500.0, RD, 461.0, CP, P0)
    same = kessler_step(*args, rs, dt, 500.0, RD, 461.0, CP, P0)
    names = ("water_vapor", "cloud_liquid", "precip_liquid", "temp", "precl")
    for name, w, s in zip(names, want, same):
        assert torch.equal(out[name], w), name
        assert torch.equal(s, w), name

"""The port's P3 native twin (``miniweatherml_tpu_torch/native``, the
``p3_backend: native`` path) against the JAX package's twin, on the CPU.

Bounds:
  * the port's library against the JAX package's library, both built from
    the same C++ with the same g++ flags: bit for bit (``np.array_equal``),
    with the lookup tables installed on both sides and with neither;
  * the port's ``_p3_scheme_native`` against JAX's
    ``_p3_scheme_native_callback`` run eagerly: bit for bit;
  * the twin against the port's vectorized ``p3_scheme``: rtol 1e-9, atol
    1e-12 of each field's scale (the JAX suite's bar,
    tests/test_p3_native.py:75-83);
  * chains (the native micro inside the supercell_p3 chain, 2 steps; and one
    step on a (1, 2, 2) mesh): rtol 1e-9 plus 1e-7 of scale, the port's
    chain bar (tests/test_torch_dycore.py); the micro alone on the mesh
    against JAX's: rtol 1e-9 plus 1e-12 of scale; the mesh step against the
    port's undecomposed step: 1e-12 of scale (tests/test_torch_spmd.py).
"""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu import native as JN
from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments.supercell_p3 import build as jax_build
from miniweatherml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from miniweatherml_tpu.parallel.mesh import shard_state as jax_shard_state
from miniweatherml_tpu.parallel.spmd import \
    make_spmd_step as jax_make_spmd_step
from miniweatherml_tpu.physics import p3 as JP
from miniweatherml_tpu.physics.column_nudging import ColumnNudger as JNudger
from miniweatherml_tpu.physics.p3 import R_V, saturation_vapor_pressure
from miniweatherml_tpu_torch import native as PN
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                                   shard_state)
from miniweatherml_tpu_torch.parallel.spmd import make_spmd_step
from miniweatherml_tpu_torch.physics import p3 as PP
from miniweatherml_tpu_torch.physics.column_nudging import ColumnNudger
from miniweatherml_tpu_torch.physics.p3_tables import load_p3_tables
from tests.test_p3_oracle import NZ_FULL, _column_profile
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, to_port)

torch.set_num_threads(1)

OUT = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv", "theta",
       "precip_liq", "precip_ice")
PROG = OUT[:10]
CONST = ("exner", "pres", "rho_d", "dz")
KINDS = ("warm", "cold", "mixed", "wetgrowth", "capped")


def _adjust_cells(n=256):
    """The JAX suite's random cells (tests/test_p3_native.py:23-30)."""
    rng = np.random.default_rng(0)
    temp = rng.uniform(250.0, 305.0, n)
    rho_d = rng.uniform(0.4, 1.2, n)
    qsat = np.asarray(saturation_vapor_pressure(temp)) / (R_V * temp)
    rho_v = qsat * rng.uniform(0.2, 2.5, n)
    rho_c = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0, 3e-3, n), 0.0)
    return rho_d + rho_v + rho_c, rho_d, rho_v, rho_c, temp


def _mixed_column(nz=24, ncol=8, seed=1):
    """tests/test_p3_native.py::_mixed_column as numpy (1, nz, 1, ncol)."""
    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) * 450.0
    temp = 300.0 - 7.5e-3 * z
    pres = 1.0e5 * (temp / 300.0) ** 6.0
    rho_d = pres / (287.042 * temp)
    shape = (1, nz, 1, ncol)

    def tile(v):
        return np.broadcast_to(v.reshape(1, nz, 1, 1), shape).copy()

    def rand(hi):
        return rng.uniform(0, hi, shape)
    exner = tile((pres / 1e5) ** (287.042 / 1004.64))
    return dict(
        qc=rand(2e-3), nc=tile(100e6 / rho_d), qr=rand(1e-3),
        nr=rand(1e5), qi=rand(1e-3), ni=rand(1e5), qm=rand(2e-4),
        bm=rand(1e-6), qv=rand(0.015),
        theta=tile(temp) / exner, exner=exner, pres=tile(pres),
        rho_d=tile(rho_d), dz=np.full(shape, 450.0))


def _oracle_column(kind):
    """One of tests/test_p3_oracle.py's canned columns as (1, nz, 1, 1)."""
    c = _column_profile(kind)
    shape = (1, NZ_FULL, 1, 1)

    def col(a):
        return np.asarray(a, np.float64).reshape(shape)
    return dict(
        qc=col(c["qc"]), nc=col(np.zeros(NZ_FULL)), qr=col(c["qr"]),
        nr=col(c["nr"]), qi=col(c["qi"]), ni=col(c["ni"]), qm=col(c["qm"]),
        bm=col(c["bm"]), qv=col(c["qv"]), theta=col(c["temp"] / c["exner"]),
        exner=col(c["exner"]), pres=col(c["pres"]), rho_d=col(c["rho_d"]),
        dz=col(np.full(NZ_FULL, 500.0)))


def _columns(d):
    """(1, nz, 1, ncol) fields as the twin's (ncol, nz) columns."""
    return {k: np.ascontiguousarray(np.moveaxis(v, 1, -1).reshape(
        -1, v.shape[1])) for k, v in d.items()}


def _inputs(case):
    """(scheme inputs, dt, history) of a named case; the history is a
    qv_prev / t_prev pair for the mixed columns, None for the oracle ones."""
    if case == "mixed_columns":
        d = _mixed_column()
        temp = d["theta"] * d["exner"]
        return d, 15.0, (0.95 * d["qv"], temp - 0.2)
    return _oracle_column(case), 10.0, None


def _assert_equal(a, b, names):
    for name, x, y in zip(names, a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


def test_adjust_state_matches_jax_library():
    cells = _adjust_cells()
    _assert_equal(PN.p3_adjust_state_native(*cells),
                  JN.p3_adjust_state_native(*cells), ("rv", "rc", "temp"))


@pytest.mark.parametrize("case", ["mixed_columns", *KINDS])
def test_column_step_matches_jax_library(case):
    """Both libraries with the lookup tables the asset gives them."""
    assert PN.load_p3_library().p3_has_tables() == \
        JN.load_p3_library().p3_has_tables()
    d, dt, hist = _inputs(case)
    cols = _columns(d)
    args = [cols[k] for k in (*PROG, *CONST)]
    for h in (None, hist):
        kw = {} if h is None else dict(
            qv_prev=_columns({"a": h[0]})["a"],
            t_prev=_columns({"a": h[1]})["a"])
        _assert_equal(PN.p3_column_step_native(*args, dt, **kw),
                      JN.p3_column_step_native(*args, dt, **kw), OUT)


def _fresh_library(path, tmp_path, name):
    """A second load of a built library, copied to a file of its own so the
    loader maps it anew: its tables are not installed."""
    copy = tmp_path / name
    shutil.copy(path, copy)
    lib = PN.bind(ctypes.CDLL(str(copy)))
    assert lib.p3_has_tables() == 0
    return lib


@pytest.mark.parametrize("case", ["mixed_columns", "mixed"])
def test_column_step_without_tables_matches_jax_library(case, tmp_path):
    """Both libraries at the continuous tier (no tables on either side)."""
    libs = [_fresh_library(PN.load_p3_library()._name, tmp_path, "port.so"),
            _fresh_library(JN.load_p3_library()._name, tmp_path, "jax.so")]
    d, dt, hist = _inputs(case)
    cols = _columns(d)
    outs = []
    for lib in libs:
        prog = [cols[k].copy() for k in PROG]
        h = (None, None) if hist is None else [
            _columns({"a": a})["a"] for a in hist]
        srf = PN.column_step(lib, prog, [cols[k] for k in CONST], dt, *h)
        outs.append((*prog, *srf))
    _assert_equal(outs[0], outs[1], OUT)
    # the continuous tier differs from the table tier on these columns
    with_tables = PN.p3_column_step_native(
        *(cols[k] for k in (*PROG, *CONST)), dt)
    assert not all(np.array_equal(a, b) for a, b in zip(outs[0], with_tables))


def test_native_available_and_a_failed_build(tmp_path, monkeypatch):
    """Both packages find the twin here; a source that does not compile
    makes ``load_p3_library`` raise with g++'s output and
    ``native_available`` say False."""
    assert PN.native_available() is True
    assert PN.native_available() == JN.native_available()
    bad = tmp_path / "p3_native.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(PN, "_SRC", str(bad))
    monkeypatch.setattr(PN, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(PN, "_lib", None)
    with pytest.raises(RuntimeError, match="native P3 build failed") as err:
        PN.load_p3_library()
    assert "p3_native.cpp" in str(err.value) and "error" in str(err.value)
    assert PN.native_available() is False


def test_install_tables_follows_the_asset(tmp_path, monkeypatch):
    """No asset: the continuous tier; an asset that fails to parse raises
    (the JAX loader would drop to the continuous tier silently)."""
    from miniweatherml_tpu_torch.physics import p3_tables
    lib = _fresh_library(PN.load_p3_library()._name, tmp_path, "port.so")
    monkeypatch.setattr(p3_tables, "default_table_path", lambda: None)
    PN.install_tables(lib)
    assert lib.p3_has_tables() == 0
    bad = tmp_path / "table.dat"
    bad.write_text("version v4.1.1\n1 2 3\n")
    monkeypatch.setattr(p3_tables, "default_table_path", lambda: str(bad))
    with pytest.raises(ValueError, match="truncated"):
        PN.install_tables(lib)
    assert lib.p3_has_tables() == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["mixed_columns", "wetgrowth"])
def test_scheme_native_matches_jax_callback(case, dtype):
    """The port's host-staged call against JAX's pure_callback, eagerly:
    the same columns, casts and defaults, bit for bit."""
    d, dt, hist = _inputs(case)
    d = {k: v.astype(dtype) for k, v in d.items()}
    kw = {} if hist is None else dict(qv_prev=hist[0].astype(dtype),
                                      t_prev=hist[1].astype(dtype))
    want = JP._p3_scheme_native_callback(
        *(jnp.asarray(d[k]) for k in (*PROG, *CONST)), dt,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = PP._p3_scheme_native(
        *(torch.as_tensor(d[k]) for k in (*PROG, *CONST)), dt,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    for name, a, b in zip(OUT, want, got):
        assert b.dtype == (torch.float64 if dtype == np.float64
                           else torch.float32), name
        assert b.is_contiguous(), name
        assert np.array_equal(np.asarray(a), b.numpy()), name


@pytest.mark.parametrize("case", ["mixed_columns", *KINDS])
def test_twin_matches_port_scheme(case):
    """The twin against the port's vectorized scheme at the same tier."""
    tables = load_p3_tables() if PN.load_p3_library().p3_has_tables() \
        else None
    d, dt, hist = _inputs(case)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    kw = {} if hist is None else dict(qv_prev=torch.as_tensor(hist[0]),
                                      t_prev=torch.as_tensor(hist[1]))
    want = PP.p3_scheme(**t, dt=dt, z_axis=1, tables=tables, **kw)
    got = PP._p3_scheme_native(*(t[k] for k in (*PROG, *CONST)), dt, **kw)
    for name, a, b in zip(OUT, want, got):
        a = a.numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-9,
                                   atol=1e-12 * scale, err_msg=f"{case}: "
                                   f"{name}")


def _chain_raw(**kw):
    raw = dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=1, nz=12,
               xlen=50000.0, ylen=50000.0, zlen=16000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0, dtype="float64", p3_backend="native")
    raw.update(kw)
    return raw


def _seeded_pair(raw):
    """Both packages' native supercell_p3 chains from one state seeded with
    ``supercell_p3.seed_layers``."""
    js, jmods, jd = jax_build(jax_config(raw))
    ps, pmods, pd = supercell_p3.build(config_from_dict(raw), "cpu")
    assert pmods[1].__self__.backend == "native"
    ps = supercell_p3.seed_layers(to_port(js))
    js = js.replace_fields(**{t[0]: jnp.asarray(ps[t[0]].numpy())
                              for t in JP.MicrophysicsP3.TRACERS[:8]})
    dt = jd.compute_time_step(js)
    assert pd.compute_time_step(ps) == dt
    return (js, jmods, jd), (ps, pmods, pd), dt


def test_native_chain_matches_jax():
    """Two steps of the 16x1x12 f64 chain with the native micro."""
    (js, jmods, _), (ps, pmods, _), dt = _seeded_pair(_chain_raw())
    for _ in range(2):
        for m in jmods:
            js = m(js, dt)
        for m in pmods:
            ps = m(ps, dt)
    assert ps.validate() == {}
    assert float(ps["ice"].max()) > 0 and float(ps["precl"].max()) > 0
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)


MESH_RAW = dict(nx_glob=16, ny_glob=8, nz=10, xlen=40000.0, ylen=40000.0)


def _jax_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    return jax_make_mesh(devices=jax.devices()[:4], y=2, x=2)


def _port_mesh_step(state, dycore, dt, **kw):
    """One ``make_spmd_step`` step of ``state`` on a (1, 2, 2) CPU mesh,
    gathered."""
    mesh = make_mesh(["cpu"] * 4, y=2, x=2)
    step = make_spmd_step(state, mesh, dycore, **kw)
    try:
        return gather_state(step(shard_state(state, mesh), dt), "cpu")
    finally:
        step.close()


def test_native_chain_on_mesh_matches_jax():
    """One step of the native chain on a (1, 2, 2) mesh against JAX's
    jitted ``make_spmd_step`` with the native micro, on the supercell init
    (as tests/test_torch_spmd.py's Kessler chain).  On the seeded state
    JAX's jitted dycore step differs from its own eager step by 2.5e-7 of
    w's scale (ROADMAP Queue 3) and its eager shard_map step takes ~9 min,
    so the twin on seeded shards is held by the two tests below."""
    jmesh = _jax_mesh()
    raw = _chain_raw(**MESH_RAW)
    js, jmods, jd = jax_build(jax_config(raw))
    ps, pmods, pd = supercell_p3.build(config_from_dict(raw), "cpu")
    dt = jd.compute_time_step(js)
    jstep = jax_make_spmd_step(js, jmesh, jd, micro=jmods[1].__self__,
                               nudger=JNudger())
    jout = jax.jit(lambda s: jstep(s, dt))(jax_shard_state(js, jmesh))
    out = _port_mesh_step(ps, pd, dt, micro=pmods[1].__self__,
                          nudger=ColumnNudger())
    assert out.validate() == {}
    assert_fields_close(jout, out, STEP_RTOL, STEP_ATOL_OF_SCALE)


class _Still:
    """A dycore that leaves the state as it is: the mesh step is then the
    micro alone, on the state both packages are handed."""

    def time_step(self, state, dt, spmd=None):
        return state


def test_native_micro_on_mesh_matches_jax_per_shard():
    """The native micro alone on a (1, 2, 2) mesh, JAX's jitted
    ``make_spmd_step`` (the twin through pure_callback on each shard's
    columns) against the port's (each shard's thread), on seeded layers
    with no rain or ice in the x < 8 shards and a 200 s step: those shards
    take one sedimentation sub-cycle, the others more, so the mesh result
    differs from the undecomposed one (one count over every column) and
    equals JAX's within the twin's bar."""
    jmesh = _jax_mesh()
    (js, jmods, _), (ps, pmods, _), _ = _seeded_pair(_chain_raw(**MESH_RAW))
    keep = (torch.arange(16) >= 8).double()
    dry = ("rain", "rain_num", "ice", "ice_num", "ice_rime", "ice_rime_vol")
    ps = ps.replace_fields(**{k: ps[k] * keep for k in dry})
    js = js.replace_fields(**{k: jnp.asarray(ps[k].numpy()) for k in dry})
    dt = 200.0
    jstep = jax_make_spmd_step(js, jmesh, _Still(), micro=jmods[1].__self__,
                               sponge_time_scale=None)
    jout = jax.jit(lambda s: jstep(s, dt))(jax_shard_state(js, jmesh))
    out = _port_mesh_step(ps, _Still(), dt, micro=pmods[1].__self__,
                          sponge_time_scale=None)
    assert out.validate() == {}
    assert_fields_close(jout, out, 1e-9, 1e-12)
    whole = pmods[1](ps, dt)
    assert not all(torch.equal(whole[k], out[k]) for k in whole.fields)


def test_native_chain_on_mesh_matches_undecomposed():
    """One step of the seeded native chain on a (1, 2, 2) mesh against the
    port's undecomposed native chain, within 1e-12 of each field's scale
    (tests/test_torch_spmd.py's one-step bar: the sponge and nudging means
    are summed shard by shard)."""
    raw = _chain_raw(**MESH_RAW)
    ps, pmods, pd = supercell_p3.build(config_from_dict(raw), "cpu")
    ps = supercell_p3.seed_layers(ps)
    dt = pd.compute_time_step(ps)
    out = _port_mesh_step(ps, pd, dt, micro=pmods[1].__self__,
                          nudger=ColumnNudger())
    ref = ps
    for m in pmods:
        ref = m(ref, dt)
    assert float(out["ice"].max()) > 0.0 and out.validate() == {}
    for name in ref.fields:
        a, b = ref[name].numpy(), out[name].numpy()
        np.testing.assert_allclose(b, a, rtol=0.0,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)

"""The port's city / building chain against the JAX package, on the CPU in
float64: the building-height stream, the horizontal sponge, the time
averager and its file, the ``simple_city`` chain, and the in-step
validation flags.  Modules are held at rel 1e-12; the 2-step chain at the
step bounds of tests/test_torch_dycore.py (rtol 1e-9 plus 1e-7 of each
field's scale), with a uniform cross-flow for the reason given there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.core.validate import check_flags as jax_check_flags
from miniweatherml_tpu.core.validate import \
    validation_flags as jax_validation_flags
from miniweatherml_tpu.dycore.init_cases import \
    _city_height_stream as jax_height_stream
from miniweatherml_tpu.experiments.simple_city import build as jax_build
from miniweatherml_tpu.physics.horizontal_sponge import \
    HorizontalSponge as JSponge
from miniweatherml_tpu.physics.time_averager import TimeAverager as JAverager
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.core.validate import (check_flags,
                                                   validated_step,
                                                   validation_flags)
from miniweatherml_tpu_torch.dycore.init_cases import _city_height_stream
from miniweatherml_tpu_torch.experiments import simple_city
from miniweatherml_tpu_torch.experiments.community_benchmark import \
    run_benchmark
from miniweatherml_tpu_torch.physics.horizontal_sponge import HorizontalSponge
from miniweatherml_tpu_torch.physics.time_averager import TimeAverager
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, crossflow, to_port)

torch.set_num_threads(1)

FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor")


def _raw(case="city", nx=64, ny=64, nz=12, **kw):
    """The city of inputs/input_city.yaml on a 64x64x12 grid (buildings of
    one cell), or the building of inputs/input_building.yaml."""
    raw = dict(sim_time=10.0, nens=2, nx_glob=nx, ny_glob=ny, nz=nz,
               xlen=2000.0, ylen=2000.0, zlen=300.0, init_data=case,
               out_prefix="t", dt_phys=0.0, out_freq=-1.0,
               enable_gravity=False, dtype="float64")
    if case == "building":
        raw.update(nens=1, zlen=500.0)
    raw.update(kw)
    return raw


@pytest.fixture(scope="module")
def city():
    """Both packages' city chains, built from the same YAML keys."""
    raw = _raw()
    js, jmods, jd, jav = jax_build(jax_config(raw))
    ps, pmods, pd, pav = simple_city.build(config_from_dict(raw), "cpu")
    return raw, (js, jmods, jd, jav), (ps, pmods, pd, pav)


def _noisy(jstate, seed):
    """The JAX state with the chain's fields perturbed by seeded noise, so
    the modules see a non-trivial state."""
    rng = np.random.default_rng(seed)
    upd = {}
    for n in FIELDS:
        a = np.asarray(jstate[n])
        upd[n] = jnp.asarray(a + 0.01 * (np.abs(a).max() + 1e-3)
                             * rng.standard_normal(a.shape))
    return jstate.replace_fields(**upd)


def test_city_height_stream_matches_jax():
    for n in (0, 432, 65536):
        np.testing.assert_array_equal(_city_height_stream(n),
                                      jax_height_stream(n))
    with pytest.raises(ValueError, match="stream has 65536"):
        _city_height_stream(65537)


def test_city_build_matches_jax(city):
    """simple_city.build: init, sponge column and averager fields, exact
    immersed mask with buildings in it."""
    _, (js, *_), (ps, *_) = city
    assert set(ps.fields) == set(js.fields)
    assert dict(ps.options) == dict(js.options)
    assert_fields_close(js, ps, rtol=1e-12, atol_of_scale=1e-14)
    imm = np.asarray(js["immersed_proportion"])
    np.testing.assert_array_equal(ps["immersed_proportion"].numpy(), imm)
    assert 0 < imm.mean() < 0.5
    assert ps["time_avg_etime"].shape == ()


@pytest.mark.parametrize("walls", [(True, True, False, False),
                                   (True, True, True, True),
                                   (False, True, True, False)])
def test_horizontal_sponge_matches_jax(walls, city):
    _, (js, *_), _ = city
    js = _noisy(js, seed=1)
    x1, x2, y1, y2 = walls
    jsp, psp = JSponge(sponge_cells=10, time_scale=1.0), HorizontalSponge(
        sponge_cells=10, time_scale=1.0)
    # the column captured from the noisy state, one value overridden
    jst = jsp.override(jsp.init(js), uvel=15.0)
    pst = psp.override(psp.init(to_port(js)), uvel=15.0)
    assert float(pst["horiz_sponge_column"][1].min()) == 15.0
    dt = 0.03
    out = jsp.apply(jst, dt, x1=x1, x2=x2, y1=y1, y2=y2)
    pout = psp.apply(pst, dt, x1=x1, x2=x2, y1=y1, y2=y2)
    assert_fields_close(out, pout, rtol=1e-12, atol_of_scale=1e-14,
                        names=list(FIELDS) + ["horiz_sponge_column"])


def test_time_averager_matches_jax(city, tmp_path):
    """Three accumulations of different states and steps, then the file."""
    from scipy.io import netcdf_file

    _, (js, *_), _ = city
    jav, pav = JAverager(), TimeAverager()
    jst, pst = js, to_port(js)
    for i, dt in enumerate((0.03, 0.05, 0.02)):
        src = _noisy(js, seed=10 + i)
        jst = jav.accumulate(jst.replace_fields(
            **{n: src[n] for n in FIELDS}), dt)
        pst = pav.accumulate(to_port(src).replace_fields(
            **{k: pst[k] for k in pst.fields if k.startswith("time_avg_")}),
            dt)
    names = ["time_avg_" + n for n in FIELDS] + ["time_avg_etime"]
    assert_fields_close(jst, pst, rtol=1e-12, atol_of_scale=1e-14,
                        names=names)
    assert float(pst["time_avg_etime"]) == pytest.approx(0.1, rel=1e-15)
    paths = [str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")]
    jav.finalize(jst, paths[0])
    assert pav.finalize(pst, paths[1]) == paths[1]
    with netcdf_file(paths[0], "r", mmap=False) as a, \
            netcdf_file(paths[1], "r", mmap=False) as b:
        assert set(a.variables) == set(b.variables) == set(FIELDS) | {
            "x", "y", "z"}
        for name in a.variables:
            np.testing.assert_allclose(b.variables[name][:],
                                       a.variables[name][:], rtol=1e-12,
                                       err_msg=name)
        assert b.variables["temp"].shape == (12, 64, 64)


def test_simple_city_chain_matches_jax(city):
    """simple_city.build + 2 chained steps (sponges, immersed dycore,
    averager), every field."""
    _, (js, jmods, jd, _), _ = city
    js = crossflow(js)
    ps = to_port(js)
    pmods = city[2][1]
    dt = jd.compute_time_step(js)

    def jstep(s):
        for m in jmods:
            s = m(s, dt)
        return s

    jstep = jax.jit(jstep)
    for _ in range(2):
        js = jstep(js)
        for m in pmods:
            ps = m(ps, dt)
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)
    assert check_flags(validation_flags(ps)) == {}


def test_validation_flags_match_jax(city):
    _, (js, *_), _ = city
    bad = np.asarray(js["temp"]).copy()
    bad[0, 1, 2, 3] = np.nan
    wv = np.asarray(js["water_vapor"]).copy()
    wv[1, 0, 0, 0] = -1e-9
    u = np.asarray(js["uvel"]).copy()
    u[0, 0, 5, 5] = np.inf
    u[0, 0, 5, 6] = np.nan
    js = js.replace_fields(temp=jnp.asarray(bad), water_vapor=jnp.asarray(wv),
                           uvel=jnp.asarray(u), wvel=-js["wvel"] - 1.0)
    want = {k: int(v) for k, v in jax_validation_flags(js).items()}
    got = validation_flags(to_port(js))
    assert set(got) == set(want)
    assert {k: int(v) for k, v in got.items()} == want
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in got.values())
    assert check_flags(got) == jax_check_flags(want) == {
        "temp": "nan", "water_vapor": "negative", "uvel": "nan+inf"}
    assert to_port(js).validate() == check_flags(got)
    step = validated_step(lambda s, dt: s)
    state, flags = step(to_port(js), 0.1)
    assert check_flags(flags) == check_flags(got)


def test_simple_city_run_writes_outputs(tmp_path, capsys):
    """The building case end to end: heartbeat, NetCDF, averaged file."""
    from scipy.io import netcdf_file

    prefix = str(tmp_path / "bld")
    cfg = config_from_dict(_raw("building", 24, 16, 10, sim_time=0.2,
                                out_freq=0.1, out_prefix=prefix,
                                validate=True))
    avg = str(tmp_path / "avg.nc")
    state = simple_city.run(cfg, "cpu", avg_path=avg)
    out = capsys.readouterr().out
    assert f"wrote {avg}" in out
    assert len([l for l in out.splitlines()
                if l.startswith("Etime , dtphys, maxw:")]) == 2
    assert state.validate() == {}
    with netcdf_file(prefix + ".nc", "r", mmap=False) as nc:
        assert nc.variables["uvel"].shape == (3, 10, 16, 24)
    with netcdf_file(avg, "r", mmap=False) as nc:
        np.testing.assert_allclose(nc.variables["uvel"][:],
                                   state["time_avg_uvel"][0].numpy(),
                                   rtol=1e-15)
    # file_per_process: the one shard's file, <prefix>_task_0.nc, holds
    # what the single file holds, with the shard's offsets
    cfg.file_per_process = True
    simple_city.run(cfg, "cpu", avg_path=avg)
    with netcdf_file(prefix + ".nc", "r", mmap=False) as one, \
            netcdf_file(prefix + "_task_0.nc", "r", mmap=False) as shard:
        assert (shard.i_beg, shard.j_beg) == (0, 0)
        assert set(shard.variables) == set(one.variables)
        for name in one.variables:
            np.testing.assert_array_equal(shard.variables[name][:],
                                          one.variables[name][:])


def test_run_benchmark_takes_the_city_chain():
    cfg = config_from_dict(_raw("building", 24, 16, 10, sim_time=0.1,
                                dtype="float32"))
    state, res = run_benchmark(cfg, "cpu", quiet=True,
                               build=simple_city.build_chain)
    dt = 0.6 * min(cfg.grid.dx, cfg.grid.dy, cfg.grid.dz) / 430.0
    assert res["steps"] == int(np.ceil(0.1 / dt))
    assert check_flags(validation_flags(state)) == {}
    assert float(state["time_avg_etime"]) == pytest.approx(0.1, rel=1e-6)

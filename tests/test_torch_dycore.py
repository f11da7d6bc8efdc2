"""The PyTorch port's state, init, dycore and whole main path against the JAX
package, on the CPU in float64 (the port's wrappers take their plain
PyTorch versions for CPU tensors).

Tolerances.  One f64 dycore step of the JAX package differs between its
own jit and eager forms by up to 1.8e-8 of a field's scale (the thermal
bubble's u beside its symmetry plane, where the WENO weights switch
stencils and amplify last-bit differences of pow() and of the operation
order).  The port's flux divergences agree with JAX's to ~3e-13 per call
(test_torch_ops.py), so a step and the 3-step slice are held to rtol 1e-9
plus an atol of 1e-7 of each field's scale.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.core.coupler import Grid as JGrid
from miniweatherml_tpu.core.coupler import make_coupler_state as jax_state
from miniweatherml_tpu.dycore.euler import Dycore as JDycore
from miniweatherml_tpu.experiments.supercell_example import build as jax_build
from miniweatherml_tpu.physics.kessler import MicrophysicsKessler as JKessler
from miniweatherml_tpu.physics.perturb import perturb_temperature as jax_perturb
from miniweatherml_tpu_torch.config import config_from_dict, load_config
from miniweatherml_tpu_torch.core.coupler import (Grid, make_coupler_state,
                                                  state_from_numpy,
                                                  state_to_numpy)
from miniweatherml_tpu_torch.dycore.euler import Dycore
from miniweatherml_tpu_torch.experiments.community_benchmark import \
    run_benchmark
from miniweatherml_tpu_torch.experiments.supercell_example import build, run
from miniweatherml_tpu_torch.physics.kessler import MicrophysicsKessler
from miniweatherml_tpu_torch.physics.perturb import perturb_temperature
from tests.test_golden import _GOLDEN_MAXW

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A step or the slice: see the module docstring.
STEP_RTOL, STEP_ATOL_OF_SCALE = 1e-9, 1e-7


def to_port(jstate, device="cpu"):
    """A JAX CouplerState as a port state (fields through numpy)."""
    return state_from_numpy(
        {k: np.array(v) for k, v in jstate.fields.items()}, jstate.grid,
        jstate.options, jstate.meta.tracers, jstate.meta.dtype, device=device)


def assert_fields_close(jstate, pstate, rtol, atol_of_scale, names=None):
    names = names or sorted(jstate.fields)
    assert set(names) <= set(pstate.fields)
    for name in names:
        a = np.asarray(jstate[name])
        b = pstate[name].detach().cpu().numpy()
        assert a.shape == b.shape, name
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=atol_of_scale * scale, err_msg=name)


def _raw(nx, ny, nz, xlen, ylen, zlen, **kw):
    raw = dict(sim_time=100.0, nens=1, nx_glob=nx, ny_glob=ny, nz=nz,
               xlen=xlen, ylen=ylen, zlen=zlen, init_data="supercell",
               out_prefix="t", dt_phys=0.0, out_freq=-1.0, dtype="float64")
    raw.update(kw)
    return raw


# Domain (xlen, ylen, zlen, nens) and options of a case beyond the defaults:
# the city case needs the reference's 2 km domain for its buildings
# (inputs/input_city.yaml, without gravity); the building case keeps it.
_DOMAIN = {"city": ((2000.0, 2000.0, 300.0, 2), {"enable_gravity": False})}


def _case(case, nx, ny, nz):
    """The same perturbed initial state built by both packages."""
    (xlen, ylen, zlen, nens), extra = _DOMAIN.get(
        case, ((40000.0, 40000.0, 10000.0, 1), {}))
    opts = {"init_data": case, "out_freq": -1.0, **extra}
    jg = JGrid(nx=nx, ny=ny, nz=nz, nens=nens, xlen=xlen, ylen=ylen,
               zlen=zlen)
    js = JKessler().init(jax_state(jg, dtype="float64", options=opts))
    jd = JDycore(ord=5)
    js = jax_perturb(jd.init(js))
    g = Grid(nx=nx, ny=ny, nz=nz, nens=nens, xlen=xlen, ylen=ylen, zlen=zlen)
    ps = MicrophysicsKessler().init(
        make_coupler_state(g, dtype="float64", options=opts, device="cpu"))
    pd = Dycore(ord=5)
    ps = perturb_temperature(pd.init(ps))
    return js, jd, ps, pd


def test_state_roundtrip_is_exact():
    js, _, _, _ = _case("supercell", 12, 4, 8)
    ps = to_port(js)
    back = state_to_numpy(ps)
    assert set(back) == set(js.fields)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(js[k]), err_msg=k)
    assert ps.meta.tracer_names == js.meta.tracer_names
    assert dict(ps.options) == dict(js.options)
    assert ps.validate() == js.validate() == {}


CASES = [("thermal", 24, 1, 12), ("supercell", 16, 8, 10),
         ("building", 48, 16, 16), ("city", 64, 64, 12)]


@pytest.mark.parametrize("case,nx,ny,nz", CASES)
def test_init_matches_jax(case, nx, ny, nz):
    js, _, ps, _ = _case(case, nx, ny, nz)
    assert set(ps.fields) == set(js.fields)
    assert dict(ps.options) == dict(js.options)
    assert_fields_close(js, ps, rtol=1e-12, atol_of_scale=1e-14)
    # the immersed-boundary mask is exact (and not empty for city/building)
    imm = np.asarray(js["immersed_proportion"])
    np.testing.assert_array_equal(ps["immersed_proportion"].numpy(), imm)
    assert (imm.any() and ps.options["use_immersed_boundaries"]) == (
        case in ("city", "building"))


def crossflow(jstate):
    """A JAX state with uniform v = 2 and w = 0.5 m/s.  The city case starts
    with v = w = 0 exactly; there the Riemann solver's upwind choice
    (ruL + ruR > 0) is decided by round-off next to the buildings, and the
    JAX package's own jit and eager forms differ by 2.1e-5 of v's scale
    after one step.  A cross-flow takes the choice off zero, so the step is
    compared at the usual bounds."""
    shape = jstate["vvel"].shape
    return jstate.replace_fields(vvel=jnp.full(shape, 2.0),
                                 wvel=jnp.full(shape, 0.5))


@pytest.mark.parametrize("case,nx,ny,nz", CASES)
def test_dycore_step_matches_jax(case, nx, ny, nz):
    js, jd, _, pd = _case(case, nx, ny, nz)
    if case == "city":
        js = crossflow(js)
    dt = jd.compute_time_step(js)
    assert pd.compute_time_step(to_port(js)) == dt
    out = jax.jit(lambda s: jd.time_step(s, dt))(js)
    pout = pd.time_step(to_port(js), dt)
    assert_fields_close(out, pout, STEP_RTOL, STEP_ATOL_OF_SCALE,
                        names=["density_dry", "uvel", "vvel", "wvel", "temp",
                               "water_vapor", "cloud_liquid",
                               "precip_liquid"])


@pytest.fixture(scope="module")
def advanced_chain():
    """Both packages' module chains and JAX's supercell state after one
    dycore + micro step (rain and cloud present)."""
    raw = _raw(16, 8, 10, 40000.0, 40000.0, 10000.0)
    js, jmods, jd = jax_build(jax_config(raw))
    _, pmods, _ = build(config_from_dict(raw), "cpu")
    dt = jd.compute_time_step(js)
    js = jax.jit(lambda s: jmods[1](jmods[0](s, dt), dt))(js)
    return js, jmods, pmods, dt


@pytest.mark.parametrize("module", ["micro", "sponge", "nudge", "perturb"])
def test_physics_module_matches_jax(module, advanced_chain):
    """Each physics module of the chain from one shared (advanced) state."""
    js, jmods, pmods, dt = advanced_chain
    ps = to_port(js)
    if module == "perturb":
        out, pout = jax_perturb(js), perturb_temperature(ps)
    else:
        i = {"micro": 1, "sponge": 2, "nudge": 3}[module]
        out, pout = jmods[i](js, dt), pmods[i](ps, dt)
    assert_fields_close(out, pout, rtol=1e-12, atol_of_scale=1e-14)


def test_slice_three_steps_matches_jax():
    """supercell_example.build + 3 chained steps, every field."""
    raw = _raw(16, 8, 10, 40000.0, 40000.0, 10000.0)
    js, jmods, jd = jax_build(jax_config(raw))
    ps, pmods, pd = build(config_from_dict(raw), "cpu")
    assert_fields_close(js, ps, rtol=1e-12, atol_of_scale=1e-14)
    dt = jd.compute_time_step(js)

    def jstep(s):
        for m in jmods:
            s = m(s, dt)
        return s

    jstep = jax.jit(jstep)
    for _ in range(3):
        js = jstep(js)
        for m in pmods:
            ps = m(ps, dt)
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)
    assert ps.validate() == {}


def test_golden_maxw_trajectory():
    """The JAX package's pinned 20-step maxw trajectory of the 50x1x20
    supercell (tests/test_golden.py), through the port."""
    cfg = config_from_dict(_raw(50, 1, 20, 100000.0, 100000.0, 20000.0))
    state, mods, dycore = build(cfg, "cpu")
    dt = dycore.compute_time_step(state)
    for i, expect in enumerate(_GOLDEN_MAXW):
        for m in mods:
            state = m(state, dt)
        got = float(state["wvel"].abs().max())
        assert got == pytest.approx(expect, rel=1e-6), f"step {i}"


def test_supercell_example_heartbeat_and_netcdf(tmp_path, capsys):
    from scipy.io import netcdf_file

    prefix = str(tmp_path / "sc")
    cfg = config_from_dict(_raw(24, 1, 12, 40000.0, 40000.0, 10000.0,
                                sim_time=4.0, out_freq=2.0, out_prefix=prefix,
                                dtype="float32"))
    state = run(cfg, "cpu")
    beats = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Etime , dtphys, maxw:")]
    assert len(beats) == 2
    assert state.validate() == {}
    with netcdf_file(prefix + ".nc", "r", mmap=False) as nc:
        assert nc.variables["temp"].shape == (3, 12, 1, 24)
        assert set(state.meta.tracer_names) <= set(nc.variables)
        np.testing.assert_allclose(nc.variables["temp"][-1],
                                   state["temp"][0].numpy(), rtol=1e-6)


def test_community_benchmark_counts_steps():
    cfg = config_from_dict(_raw(16, 4, 12, 16000.0, 16000.0, 10000.0,
                                sim_time=3.0, dtype="float32"))
    state, res = run_benchmark(cfg, "cpu", quiet=True)
    dt = 0.6 * cfg.grid.dz / 430.0
    assert res["steps"] == int(np.ceil(3.0 / dt))
    assert res["mcellups"] > 0
    assert state.validate() == {}


def test_random_perturbation_is_seeded():
    """random=True draws from the caller's torch.Generator: the same seed
    gives the same field, bounded by 3 K scaled to 0 at nz/4."""
    _, _, ps, _ = _case("supercell", 12, 4, 16)
    outs = []
    for seed in (5, 5, 6):
        gen = torch.Generator().manual_seed(seed)
        outs.append(perturb_temperature(ps, thermal=False, random=True,
                                        generator=gen)["temp"] - ps["temp"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    d = outs[0][0]
    assert float(d[:4].abs().max()) <= 3.0 and float(d[:4].abs().max()) > 1.0
    assert float(d[4:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="Generator"):
        perturb_temperature(ps, random=True)


def test_coupler_registry():
    g = Grid(nx=4, ny=3, nz=2)
    st = make_coupler_state(g, dtype="float64",
                            device="cpu").add_tracer("water_vapor")
    st = st.add_tracer("cloud_liquid", positive=False).register_field("temp")
    with pytest.raises(ValueError):
        st.register_field("temp")
    with pytest.raises(ValueError):
        st.add_tracer("water_vapor")
    tr = st.tracer_stack()
    assert tuple(tr.shape) == (2, 1, 2, 3, 4) and st.meta.idWV == 0
    st2 = st.with_tracer_stack(tr - 1.0)
    assert st2.validate() == {"water_vapor": "negative"}
    assert st.validate() == {}
    st3 = st2.clone()
    st3["temp"].fill_(float("nan"))
    assert st3.validate()["temp"] == "nan" and "temp" not in st2.validate()


def test_load_config_matches_jax():
    from miniweatherml_tpu.config import load_config as jax_load

    path = os.path.join(REPO, "inputs", "supercell_short.yaml")
    a, b = jax_load(path), load_config(path)
    assert b.grid == Grid(**vars(a.grid))
    assert (b.sim_time, b.dt_phys, b.out_freq, b.dtype, b.extras) == (
        a.sim_time, a.dt_phys, a.out_freq, a.dtype, a.extras)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import miniweatherml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'miniweatherml_tpu']\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith(p.__name__)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 25
    pkg = "miniweatherml_tpu_torch."
    assert {pkg + m for m in (
        "physics.p3", "physics.p3_tables", "physics.p3_lookup_cuda",
        "physics.p3_cellwise_cuda", "experiments.supercell_p3", "ops.fct",
        "io.checkpoint", "core.validate", "physics.horizontal_sponge",
        "physics.time_averager", "experiments.simple_city")} <= mods

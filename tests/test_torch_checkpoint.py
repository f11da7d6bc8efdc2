"""Checkpoint / restart of the port: a restarted run equals a straight one
bit for bit on the CPU, checkpoints cross-load between the two packages,
and ``supercell_example.run`` honours the YAML's ``restart_file`` and
``checkpoint_freq`` keys as the JAX package's ``main`` does.
"""

import numpy as np
import pytest
import torch

from miniweatherml_tpu.io.checkpoint import load_checkpoint as jax_load
from miniweatherml_tpu.io.checkpoint import save_checkpoint as jax_save
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import simple_city, supercell_example
from miniweatherml_tpu_torch.experiments.driver import run_main_loop
from miniweatherml_tpu_torch.io.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from tests.test_torch_dycore import _case

torch.set_num_threads(1)

DT = 0.25  # a fixed physics step below the CFL step of the grids here


def _cfg(nsteps, **kw):
    raw = dict(sim_time=nsteps * DT, nens=1, nx_glob=16, ny_glob=4, nz=10,
               xlen=40000.0, ylen=40000.0, zlen=10000.0,
               init_data="supercell", out_prefix="t", dt_phys=DT,
               out_freq=-1.0, dtype="float64")
    raw.update(kw)
    return config_from_dict(raw)


def _assert_states_equal(a, b, options=True):
    assert set(a.fields) == set(b.fields)
    for k in a.fields:
        assert torch.equal(a[k], b[k]), k
    assert a.meta.tracers == b.meta.tracers and a.grid == b.grid
    if options:
        assert dict(a.options) == dict(b.options)


@pytest.mark.parametrize("chain", ["supercell", "city"])
def test_restart_equals_straight_run(chain, tmp_path):
    """2 steps, checkpoint, restart from the file, 2 more == 4 straight
    steps; for the city chain the averager's 0-d time rides along."""
    if chain == "supercell":
        build = supercell_example.build
        kw = {}
    else:
        build = simple_city.build_chain
        kw = dict(init_data="city", nx_glob=32, ny_glob=32, nz=10,
                  xlen=2000.0, ylen=2000.0, zlen=300.0, dt_phys=2.0 ** -8,
                  enable_gravity=False)
    dt = kw.get("dt_phys", DT)
    path = str(tmp_path / "chk.npz")
    cfg4 = _cfg(4, **kw)
    cfg4.sim_time = 4 * dt
    state, mods, dycore = build(cfg4, "cpu")
    if chain == "city":
        assert float(state["immersed_proportion"].max()) == 1.0
    straight = run_main_loop(state.clone(), cfg4, mods, dycore, quiet=True)

    cfg2 = _cfg(2, **kw)
    cfg2.sim_time = 2 * dt
    run_main_loop(state.clone(), cfg2, mods, dycore, quiet=True,
                  checkpoint_freq=2 * dt, checkpoint_path=path)
    restored, etime = load_checkpoint(path, "cpu")
    assert etime == 2 * dt
    steps = []
    resumed = run_main_loop(restored, cfg4, mods, dycore, quiet=True,
                            etime0=etime,
                            on_step=lambda s, d, e: steps.append(e))
    assert steps == [2 * dt + dt, 2 * dt + dt + dt]
    _assert_states_equal(straight, resumed)


def test_checkpoint_crossloads_between_packages(tmp_path):
    js, _, ps, _ = _case("supercell", 12, 4, 10)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save(jpath, js, etime=12.5)
    save_checkpoint(ppath, ps, etime=7.25)

    port_from_jax, e1 = load_checkpoint(jpath, "cpu")
    jax_from_port, e2 = jax_load(ppath)
    assert (e1, e2) == (12.5, 7.25)
    for src, dst in ((js, port_from_jax), (ps, jax_from_port)):
        assert set(src.fields) == set(dst.fields)
        for k in src.fields:
            a = np.asarray(src[k]) if not torch.is_tensor(src[k]) \
                else src[k].numpy()
            b = dst[k].numpy() if torch.is_tensor(dst[k]) \
                else np.asarray(dst[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)
        assert dict(src.options) == dict(dst.options)
        assert src.meta.tracer_names == dst.meta.tracer_names
        assert src.meta.dtype == dst.meta.dtype
    assert port_from_jax.device == torch.device("cpu")
    assert port_from_jax.grid.nx == js.grid.nx
    assert jax_from_port.grid.nz == ps.grid.nz


def test_supercell_example_restart_file(tmp_path, capsys):
    """``checkpoint_freq`` writes ``<out_prefix>_chkpt.npz``; a run with
    ``restart_file`` resumes at the saved etime and ends where a straight
    run ends, bit for bit."""
    prefix = str(tmp_path / "sc")
    first = supercell_example.run(_cfg(2, out_prefix=prefix,
                                       checkpoint_freq=2 * DT), "cpu")
    chk = prefix + "_chkpt.npz"
    saved, etime = load_checkpoint(chk, "cpu")
    assert etime == 2 * DT
    _assert_states_equal(first, saved)
    capsys.readouterr()

    resumed = supercell_example.run(
        _cfg(4, out_prefix=str(tmp_path / "r"), restart_file=chk), "cpu")
    assert f"restarted from {chk} at etime={2 * DT:g}" in \
        capsys.readouterr().out
    straight = supercell_example.run(_cfg(4, out_prefix=str(tmp_path / "s")),
                                     "cpu")
    # the options differ by out_prefix: a restarted run keeps the saved run's
    _assert_states_equal(straight, resumed, options=False)
    assert not torch.equal(straight["temp"], first["temp"])

"""The port's Kessler MLP surrogate and its inference experiment against the
JAX package, on the CPU.

Both packages start from the same state (the JAX package's, carried across
through numpy) and the same weights: the shipped example model, loaded as
f32 by each package.  Tolerances, as max |port - JAX| over max |JAX| of
each field ("of scale"):
  * the surrogate forward: 1e-12 of scale in f64.  In f32, 1e-6 of each
    output's scaling range (max - min of its table row): the two packages'
    f32 matmuls round the normalized output differently by an ulp or so,
    and denormalizing scales that by the range, which for cloud and rain
    is ~1e3 times the largest value the state holds;
  * the mean NN - Kessler diffs: 1e-12 of the scale of the difference
    field each one averages (sums over every cell, in each package's
    reduction order);
  * the 2-step inference chain in f64: rtol 1e-9 plus 1e-7 of scale, the
    bound of the port's other chains (tests/test_torch_dycore.py).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch
import yaml

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments import inference_surrogate as JI
from miniweatherml_tpu.ml import mlp as JM
from miniweatherml_tpu.physics.kessler import MicrophysicsKessler as JKessler
from miniweatherml_tpu.physics.kessler_surrogate import \
    MicrophysicsKesslerSurrogate as JSurrogate
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import inference_surrogate as TI
from miniweatherml_tpu_torch.ml import mlp as TM
from miniweatherml_tpu_torch.physics.kessler_surrogate import \
    MicrophysicsKesslerSurrogate
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, to_port)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "inputs", "examples")
WEIGHTS = os.path.join(EX, "supercell_kessler_example_weights.npz")
H5 = os.path.join(EX, "supercell_kessler_singlecell_model_weights.h5")
SCL_IN = os.path.join(EX, "supercell_kessler_input_scaling.txt")
SCL_OUT = os.path.join(EX, "supercell_kessler_output_scaling.txt")
OUTPUTS = ("temp", "water_vapor", "cloud_liquid", "precip_liquid")


def _raw(dtype="float64", **kw):
    """A 16x8x10 supercell (the card-vs-CPU slice's grid)."""
    raw = dict(sim_time=100.0, nens=1, nx_glob=16, ny_glob=8, nz=10,
               xlen=40000.0, ylen=40000.0, zlen=10000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0, dtype=dtype)
    raw.update(kw)
    return raw


def _surrogates(online, compare):
    """The JAX and port surrogates with the shipped example weights."""
    jm = JM.load_mlp(WEIGHTS)
    si, so = JM.load_scaling(SCL_IN, 5), JM.load_scaling(SCL_OUT, 4)
    pm = TM.mlp_from_numpy([(np.asarray(W), np.asarray(b))
                            for W, b in jm.weights], "cpu")
    return (JSurrogate(jm, si, so, online=online, compare=compare),
            MicrophysicsKesslerSurrogate(pm, np.asarray(si), np.asarray(so),
                                         online=online, compare=compare))


@functools.lru_cache(maxsize=None)
def _jax_state(dtype):
    """The JAX chain's state after one online, compare step (so that cloud
    and rain are about) and its dt."""
    state, mods, dycore = JI.build(jax_config(_raw(dtype)),
                                   micro=_surrogates(True, True)[0])
    dt = float(dycore.compute_time_step(state))
    for m in mods:
        state = m(state, dt)
    return state, dt


def _jax_stepped(dtype, online=True, compare=True):
    """``_jax_state`` with both surrogates in the given mode."""
    return (*_jax_state(dtype), *_surrogates(online, compare))


def _of_scale(got, want):
    a = np.asarray(want, np.float64)
    b = got.detach().cpu().numpy().astype(np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_nn_forward_matches_jax(dtype):
    """_nn_forward's four fields on the same 16x8x10 state: weights and
    tables loaded as f32 and computed in the state's dtype."""
    jstate, _, jmicro, pmicro = _jax_stepped(dtype)
    pstate = to_port(jstate)
    want = jmicro._nn_forward(jstate)
    got = pmicro._nn_forward(pstate)
    rng = np.diff(np.asarray(jmicro.scl_out, np.float64), axis=1)[:, 0]
    for v, (name, a, b) in enumerate(zip(OUTPUTS, want, got)):
        assert b.dtype == pstate.meta.tdtype, name
        if dtype == "float64":
            err = _of_scale(b, a)
            assert err <= 1e-12, (name, err)
        else:
            err = np.abs(b.numpy().astype(np.float64)
                         - np.asarray(a, np.float64)).max() / rng[v]
            assert err <= 1e-6, (name, err)
    assert float(got[1].min()) >= 0.0 and float(got[3].min()) >= 0.0


@pytest.mark.parametrize("online", [False, True], ids=["compare", "online"])
def test_time_step_matches_jax(online):
    """One surrogate time_step in f64: the compare mode keeps Kessler's
    result, the online mode the NN's; both store the mean diffs."""
    jstate, dt, jmicro, pmicro = _jax_stepped("float64", online=online,
                                              compare=True)
    pstate = to_port(jstate)
    jout = jmicro.time_step(jstate, dt)
    pout = pmicro.time_step(pstate, dt)
    assert_fields_close(jout, pout, 0.0, 1e-12)
    want = np.asarray(jout["surrogate_diffs"])
    got = pout["surrogate_diffs"].numpy()
    assert np.any(want != 0.0)
    nn = jmicro._nn_forward(jstate)
    truth = JKessler.time_step(jmicro, jstate, dt)
    for v, name in enumerate(OUTPUTS):
        scale = np.abs(np.asarray(nn[v]) - np.asarray(truth[name])).max()
        assert abs(got[v] - want[v]) <= 1e-12 * scale, (name, got, want)


def test_online_only_keeps_diffs():
    """online without compare runs no Kessler step: the diffs stay as the
    state holds them, and precl is untouched."""
    jstate, dt, _, pmicro = _jax_stepped("float64", online=True,
                                         compare=False)
    pstate = to_port(jstate)
    pout = pmicro.time_step(pstate, dt)
    assert torch.equal(pout["surrogate_diffs"], pstate["surrogate_diffs"])
    assert pout["precl"] is pstate["precl"]
    assert not torch.equal(pout["temp"], pstate["temp"])


def test_init_registers_diffs_and_option():
    """init adds the Kessler tracers, the (4,) diffs field and the micro
    option, and casts the weights once to the state's device and dtype."""
    _, pmicro = _surrogates(True, False)
    state, _, _ = TI.build(config_from_dict(_raw()), "cpu", micro=pmicro)
    assert state.get_option("micro") == "kessler_surrogate"
    assert state["surrogate_diffs"].shape == (4,)
    assert state["surrogate_diffs"].dtype == torch.float64
    net, scl_in, _ = pmicro._params(state)
    assert net.W[0].dtype == torch.float64 and scl_in.dtype == torch.float64
    assert not net.W[0].requires_grad
    # f32-rounded weights, computed in f64
    assert torch.equal(net.W[0], pmicro.model.W[0].double())


def test_inference_chain_matches_jax():
    """Two steps of the inference_surrogate chain (online, compare) in f64
    from the same carried state."""
    jmicro, pmicro = _surrogates(True, True)
    jstate, jmods, jdycore = JI.build(jax_config(_raw()), micro=jmicro)
    pstate, pmods, pdycore = TI.build(config_from_dict(_raw()), "cpu",
                                      micro=pmicro)
    assert_fields_close(jstate, pstate, 1e-12, 1e-14)
    dt = float(jdycore.compute_time_step(jstate))
    assert pdycore.compute_time_step(pstate) == pytest.approx(dt, rel=1e-14)
    for _ in range(2):
        for jm, pm in zip(jmods, pmods):
            jstate, pstate = jm(jstate, dt), pm(pstate, dt)
    assert_fields_close(jstate, pstate, STEP_RTOL, STEP_ATOL_OF_SCALE)
    assert pstate.validate() == {}


def test_inference_main_prints_diffs(tmp_path, monkeypatch, capsys):
    """The port's inference_surrogate entry point on the CPU, with the
    shipped Keras HDF5 weights: one diff line per step in the JAX package's
    format, then the final mean diffs, at least one of them nonzero."""
    cfg = _raw("float32", nx_glob=50, ny_glob=1, nz=20, xlen=100000.0,
               ylen=100000.0, zlen=20000.0, sim_time=3.0,
               out_prefix=str(tmp_path / "s"), keras_weights_h5=H5,
               nn_input_scaling=SCL_IN, nn_output_scaling=SCL_OUT,
               surrogate_compare=True)
    path = tmp_path / "in.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    state = TI.main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "mean diff NN - Kessler" in ln]
    assert len(lines) >= 2
    pat = (r"Etime: +\S+  mean diff NN - Kessler \[temp, rho_v, rho_c, "
           r"rho_r\]: \[( ?-?\d\.\d{6}e[+-]\d\d, ){3} ?-?\d\.\d{6}e[+-]\d\d\]")
    assert all(re.fullmatch(pat, ln) for ln in lines), lines
    final = [ln for ln in out.splitlines() if ln.startswith("Mean diff")]
    assert final and any(v != 0.0 for v in state["surrogate_diffs"].tolist())
    assert state.validate() == {}


def test_build_needs_weights():
    with pytest.raises(ValueError, match="nn_weights"):
        TI.build(config_from_dict(_raw()), "cpu")

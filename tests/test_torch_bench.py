"""The port's headline benchmark (``miniweatherml_tpu_torch/bench.py``)
against the root ``bench.py``, on the CPU.

* ``main()`` under MWML_BENCH_CPU=1 at a 16x8x10 grid for one step, per
  chain: the last printed line is the returned payload, with ``bench.py``'s
  four keys (and ``ms_per_step``, ``peak_mem_gib``).
* The configuration each switch builds, against ``bench.py``'s keys
  (``bench.py:129-133`` supercell, ``:158-168`` city with its
  ``riemann_impl`` and ``fast_weights``, written out here) and the
  all-active P3 seeds, read from ``bench.py``'s source.
* The dycore each chain runs under MWML_BENCH_PALLAS / FASTW, dtype and
  order, on the card's defaults and the CPU's, against ``bench.py``'s
  choice (``:150-168``, ``:212-238``, written out here).
* One f64 step of each chain against the JAX package's build of the same
  configuration, run eagerly with its CPU defaults (XLA Riemann solver,
  exact WENO weights): rtol 1e-9 plus 1e-7 of each field's scale, the
  port's step bar (tests/test_torch_dycore.py).  The city starts from rest,
  where round-off decides the upwind choice beside the buildings; both
  packages step it with the cross-flow of ``test_torch_dycore.crossflow``.
"""

import ast
import json
import os

import jax.numpy as jnp
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments import inference_surrogate as JI
from miniweatherml_tpu.experiments import simple_city as JC
from miniweatherml_tpu.experiments import supercell_example as JE
from miniweatherml_tpu.experiments import supercell_p3 as JP
from miniweatherml_tpu.ml import mlp as JM
from miniweatherml_tpu.physics.kessler_surrogate import \
    MicrophysicsKesslerSurrogate as JSurrogate
from miniweatherml_tpu_torch import bench
from miniweatherml_tpu_torch.experiments import supercell_p3
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, crossflow, to_port)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "inputs", "examples")

TINY = {"MWML_BENCH_CPU": "1", "MWML_BENCH_NX": "16", "MWML_BENCH_NY": "8",
        "MWML_BENCH_NZ": "10"}
CHAINS = {
    "kessler": {},
    "p3": {"MWML_BENCH_MICRO": "p3"},
    "p3_active": {"MWML_BENCH_MICRO": "p3", "MWML_BENCH_P3_ACTIVE": "1"},
    "city": {"MWML_BENCH_CASE": "city"},
    "surrogate": {"MWML_BENCH_MICRO": "surrogate"},
}
KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step",
        "peak_mem_gib"}


@pytest.mark.parametrize("chain", CHAINS)
def test_main_prints_the_result_line_on_the_cpu(chain, capsys):
    payload = bench.main({**TINY, "MWML_BENCH_STEPS": "1", **CHAINS[chain]})
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == payload
    assert set(payload) == KEYS
    assert payload["unit"] == "Mcellups"
    assert payload["value"] > 0
    assert payload["vs_baseline"] == payload["value"] / 10.0
    assert payload["ms_per_step"] > 0 and payload["peak_mem_gib"] is None
    assert payload["metric"].startswith(
        "supercell cell-updates/sec/chip (16x8x10, 1 steps, cpu")
    label = {"kessler": None, "p3": "p3", "p3_active": "p3, all cells active",
             "city": "city", "surrogate": "surrogate"}[chain]
    assert payload["metric"].endswith(f", {label})" if label else "cpu)")


def _bench_py_supercell(nx, ny, nz, nens, dtype):
    """bench.py:129-133."""
    return dict(
        sim_time=1.0e9, nens=nens, nx_glob=nx, ny_glob=ny, nz=nz,
        xlen=400.0 * nx, ylen=400.0 * ny, zlen=200.0 * nz,
        init_data="supercell", out_prefix="bench", dt_phys=0.0, out_freq=-1.0,
        dtype=dtype,
    )


def _bench_py_city(nx, ny, nz, nens, dtype, ordv, use_pallas=False,
                   fastw="1"):
    """bench.py:158-168."""
    return dict(
        sim_time=1.0e9, nens=nens, nx_glob=nx, ny_glob=ny, nz=nz,
        xlen=2000.0, ylen=2000.0, zlen=300.0,
        init_data="city", out_prefix="bench", dt_phys=0.0,
        out_freq=-1.0, enable_gravity=False, dtype=dtype,
        dyn_order=ordv, riemann_impl="pallas" if use_pallas else "xla",
        fast_weights=use_pallas and fastw == "1",
    )


@pytest.mark.parametrize("chain", CHAINS)
def test_config_is_bench_py_s(chain):
    env = {**TINY, "MWML_BENCH_NENS": "2", "MWML_BENCH_DTYPE": "float64",
           "MWML_BENCH_ORD": "3", **CHAINS[chain]}
    got = bench.config_dict(bench.settings(env))
    want = (_bench_py_city(16, 8, 10, 2, "float64", 3) if chain == "city"
            else _bench_py_supercell(16, 8, 10, 2, "float64"))
    assert got == want


def _bench_py_dycore(env, case, on_card):
    """(riemann_impl, fast_weights) of the dycore bench.py runs, or None
    where it keeps the chain's own (``Dycore()``, the XLA path): the city's
    config keys (:153-167), else the rebuild of :226-238."""
    default = "1" if on_card else "0"
    fastw = env.get("MWML_BENCH_FASTW", "1") == "1"
    use_pallas = env.get("MWML_BENCH_PALLAS", default) == "1"
    if case == "city":
        return ("pallas" if use_pallas else "xla", use_pallas and fastw)
    if env.get("MWML_BENCH_DTYPE", "float32") == "float64":
        use_pallas = False
    if int(env.get("MWML_BENCH_ORD", 5)) != 5 or use_pallas:
        return ("pallas" if use_pallas else "xla", use_pallas and fastw)
    return None


PALLAS_ENVS = {
    "default": {}, "pallas0": {"MWML_BENCH_PALLAS": "0"},
    "fastw0": {"MWML_BENCH_FASTW": "0"},
    "pallas1_fastw0": {"MWML_BENCH_PALLAS": "1", "MWML_BENCH_FASTW": "0"},
    "f64": {"MWML_BENCH_DTYPE": "float64"},
    "f64_pallas1": {"MWML_BENCH_DTYPE": "float64", "MWML_BENCH_PALLAS": "1"},
    "ord3_pallas0": {"MWML_BENCH_ORD": "3", "MWML_BENCH_PALLAS": "0"}}


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("env", list(PALLAS_ENVS))
@pytest.mark.parametrize("chain", ["kessler", "city"])
def test_pallas_switches_are_bench_py_s(chain, env, on_card, monkeypatch):
    """The dycore a run steps with, and the city's config keys, as
    ``bench.py`` picks them (PALLAS defaults to 1 on the device and 0 on
    the host; float64 turns it off for the supercell; FASTW follows it);
    the metric names the form."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    e = {**TINY, **CHAINS[chain], **PALLAS_ENVS[env]}
    if on_card:
        del e["MWML_BENCH_CPU"]
    s = bench.settings(e)
    s["device"] = "cpu"  # build on the host either way
    want = _bench_py_dycore(e, "city" if chain == "city" else "supercell",
                            on_card)
    _, mods, dycore = bench.build_chain(s, "cpu")
    got = (dycore.riemann_impl, dycore.fast_weights)
    assert got == (want or ("xla", False))
    assert mods[0] == dycore.time_step or chain == "city"
    if chain == "city":
        cfg = bench.config_dict(s)
        assert (cfg["riemann_impl"], cfg["fast_weights"]) == want
    form = {("pallas", True): ", opt WENO, fast weights",
            ("pallas", False): ", opt WENO"}.get(got, "")
    assert bench._metric(s, "cpu") == (
        f"supercell cell-updates/sec/chip (16x8x10, {s['steps']} steps, "
        f"cpu{form}" + (", city" if chain == "city" else "")
        + (", float64" if "f64" in env else "")
        + (", ord 3" if "ord3" in env else "") + ")")


def test_defaults_are_bench_py_s(monkeypatch):
    cpu = bench.settings({"MWML_BENCH_CPU": "1"})
    assert (cpu["device"], cpu["nx"], cpu["ny"], cpu["nz"], cpu["steps"]) == (
        "cpu", 64, 64, 32, 3)
    assert (cpu["dtype"], cpu["nens"], cpu["ord"], cpu["micro"]) == (
        "float32", 1, 5, "kessler")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = bench.settings({})
    assert (card["device"], card["nx"], card["ny"], card["nz"],
            card["steps"]) == ("cuda", 512, 512, 64, 10)
    fast = bench.settings({"MWML_BENCH_FAST": "1"})
    assert (fast["nx"], fast["ny"], fast["nz"], fast["steps"]) == (
        256, 256, 64, 4)


def test_without_cuda_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main({"MWML_BENCH_NX": "16"})


@pytest.mark.parametrize("switch", [{"MWML_BENCH_MICRO": "kesler"},
                                    {"MWML_BENCH_CASE": "town"},
                                    {"MWML_BENCH_STEPS": "0"}])
def test_bad_switches_raise(switch):
    with pytest.raises(ValueError):
        bench.settings({**TINY, **switch})


def _bench_py_seeds():
    """The all-active seeds dict of bench.py's P3_ACTIVE branch, read from
    its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    found = [ast.literal_eval(node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Assign)
             and [getattr(t, "id", None) for t in node.targets] == ["seeds"]]
    assert len(found) == 1
    return found[0]


def test_active_seeds_are_bench_py_s():
    assert supercell_p3.ACTIVE_SEEDS == _bench_py_seeds()
    assert supercell_p3.ACTIVE_SEEDS == {
        "cloud_water": 1.0e-4, "cloud_water_num": 1.0e7, "rain": 1.0e-4,
        "rain_num": 1.0e5, "ice": 1.0e-4, "ice_num": 1.0e5,
        "ice_rime": 5.0e-5, "ice_rime_vol": 1.0e-7}


def _jax_chain(chain, raw):
    """The JAX package's build of ``raw`` for the chain, as bench.py makes
    it: (state, step_modules, dycore)."""
    cfg = jax_config(raw)
    if chain == "city":
        return JC.build(cfg)[:3]
    if chain.startswith("p3"):
        state, mods, dycore = JP.build(cfg)
        if chain == "p3_active":
            state = state.replace_fields(**{
                k: jnp.maximum(state[k], v)
                for k, v in _bench_py_seeds().items()})
        return state, mods, dycore
    if chain == "surrogate":
        micro = JSurrogate(
            JM.load_mlp(os.path.join(
                EX, "supercell_kessler_example_weights.npz")),
            JM.load_scaling(os.path.join(
                EX, "supercell_kessler_input_scaling.txt"), 5),
            JM.load_scaling(os.path.join(
                EX, "supercell_kessler_output_scaling.txt"), 4),
            online=True, compare=False)
        return JI.build(cfg, micro=micro)
    return JE.build(cfg)


@pytest.mark.parametrize("chain", CHAINS)
def test_one_f64_step_matches_jax(chain):
    s = bench.settings({**TINY, "MWML_BENCH_DTYPE": "float64",
                        **CHAINS[chain]})
    js, jmods, jd = _jax_chain(chain, bench.config_dict(s))
    ps, pmods, pd = bench.build_chain(s, "cpu")
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)
    if chain == "p3_active":
        assert float(ps["ice"].min()) == supercell_p3.ACTIVE_SEEDS["ice"]
    if chain == "city":
        js = crossflow(js)
        ps = to_port(js)
    dt = jd.compute_time_step(js)
    assert pd.compute_time_step(ps) == pytest.approx(dt, rel=1e-12)
    for m in jmods:
        js = m(js, dt)
    for m in pmods:
        ps = m(ps, dt)
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)
    assert ps.validate() == {}

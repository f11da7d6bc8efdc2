"""The port's entry points of ``miniweatherml_tpu_torch/dryrun.py`` against
the root ``__graft_entry__.py``, on the CPU.

* ``entry()``: the tiny 2-D supercell configuration is JAX's, and one f32
  step of it is held against JAX's ``entry()`` step, run eagerly, within
  the JAX package's own spread on that step: each field within the larger
  of 1e-5 of its scale (the JAX suite's f32 bound between its paths,
  tests/test_pallas.py) and the difference between JAX's jitted and eager
  forms of the same step (4.3e-5 of w's scale; the port is 2.2e-5 from the
  eager step, measured on the CPU); the same step in f64 at the
  port's step bar, rtol 1e-9 plus 1e-7 of scale (tests/test_torch_dycore.py).
* ``dryrun_multichip``: n CPU shards against 1 within 2e-5 of each field's
  scale (the JAX dry run's bound, which ``dryrun_multichip`` checks itself):
  4 shards for 2 steps here, and 8 shards (ens 2 x 2 x 2) for the full 20
  steps in the slow tier.  Measured on the CPU: 1.3e-7 of v's scale for the
  20-step Kessler chain, 0 for P3 and the surrogate step.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config as jax_tiny_config
from __graft_entry__ import entry as jax_entry
from miniweatherml_tpu.experiments.supercell_example import build as jax_build
from miniweatherml_tpu_torch import dryrun
from miniweatherml_tpu_torch.experiments.supercell_example import build
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close)

torch.set_num_threads(1)

F32_OF_SCALE = 1e-5


def test_tiny_config_is_jax_s():
    for kw in ({}, dict(nx=32, ny=16, nz=16, nens=4, dtype="float64")):
        a, b = jax_tiny_config(**kw), dryrun._tiny_config(**kw)
        assert vars(b.grid) == vars(a.grid)
        assert (b.sim_time, b.dt_phys, b.init_data, b.out_freq, b.dtype,
                b.extras) == (a.sim_time, a.dt_phys, a.init_data, a.out_freq,
                              a.dtype, a.extras)


def test_entry_step_matches_jax_entry():
    jfn, (js,) = jax_entry()
    pfn, (ps,) = dryrun.entry("cpu")
    assert ps["temp"].dtype == torch.float32 and ps.grid.ny == 1
    assert_fields_close(js, ps, 0.0, F32_OF_SCALE)
    eager, jitted = jfn(js), jax.jit(jfn)(js)
    out = pfn(ps)
    assert out.validate() == {}
    for name in js.fields:
        want = np.asarray(eager[name], np.float64)
        scale = np.abs(want).max()
        spread = np.abs(np.asarray(jitted[name], np.float64) - want).max()
        got = out[name].double().numpy()
        np.testing.assert_allclose(
            got, want, rtol=0.0, atol=max(F32_OF_SCALE * scale, spread),
            err_msg=name)


def test_entry_config_step_in_f64_matches_jax():
    js, jmods, jd = jax_build(jax_tiny_config(dtype="float64"))
    ps, pmods, pd = build(dryrun._tiny_config(dtype="float64"), "cpu")
    dt = jd.compute_time_step(js)
    assert pd.compute_time_step(ps) == pytest.approx(dt, rel=1e-12)
    for m in jmods:
        js = m(js, dt)
    for m in pmods:
        ps = m(ps, dt)
    assert_fields_close(js, ps, STEP_RTOL, STEP_ATOL_OF_SCALE)


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)


def _shard_threads():
    return {t for t in threading.enumerate() if t.name.startswith("shard")}


def _check(res, mesh, steps):
    assert res["mesh"] == mesh
    for chain in ("kessler", "p3", "surrogate"):
        r = res[chain]
        assert r["steps"] == (1 if chain == "surrogate" else steps)
        assert 0.0 <= r["max_rel_err"] <= dryrun.INVARIANCE_RTOL, (chain, r)
        assert r["seconds"] > 0 and r["seconds_undecomposed"] > 0


def test_dryrun_four_cpu_devices():
    before = _shard_threads()
    res = dryrun.dryrun_multichip(4, ["cpu"] * 4, steps=2)
    _check(res, {"ens": 2, "y": 1, "x": 2}, 2)
    assert _shard_threads() <= before


def test_dryrun_failure_closes_the_workers(monkeypatch):
    """A chain outside the bound raises, naming it, and leaves no shard
    worker running."""
    before = _shard_threads()
    monkeypatch.setattr(dryrun, "INVARIANCE_RTOL", -1.0)
    with pytest.raises(AssertionError, match="Kessler: field .* differs "
                                             "between 4 shards and 1"):
        dryrun.dryrun_multichip(4, ["cpu"] * 4, steps=1)
    assert _shard_threads() <= before


def test_dryrun_rejects_too_few_devices():
    with pytest.raises(ValueError, match="needs 4 devices"):
        dryrun.dryrun_multichip(4, ["cpu"] * 3)


@pytest.mark.slow
def test_dryrun_eight_cpu_devices_twenty_steps():
    res = dryrun.dryrun_multichip(8, ["cpu"] * 8)
    _check(res, {"ens": 2, "y": 2, "x": 2}, dryrun.DRYRUN_STEPS)

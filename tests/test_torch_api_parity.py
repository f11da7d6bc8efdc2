"""The port's public API against the JAX package's, read from the sources.

``test_every_public_name_has_a_counterpart`` walks both trees with ``ast``
(nothing is imported, so no JAX either): every public module-level function
and class method of ``miniweatherml_tpu/`` must exist in the same module of
``miniweatherml_tpu_torch/`` and take each of its parameters by name (or
``**kwargs``), unless ``ALLOWED`` names it with its reason.  The other tests
hold the names ported for that guard to the JAX package's behaviour.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.core.coupler import Grid as JGrid
from miniweatherml_tpu.core.coupler import make_coupler_state as j_state
from miniweatherml_tpu.physics.kessler import MicrophysicsKessler as JKessler
from miniweatherml_tpu_torch.core.coupler import Grid, make_coupler_state
from miniweatherml_tpu_torch.physics.kessler import MicrophysicsKessler
from miniweatherml_tpu_torch.physics.kessler_surrogate import (
    MicrophysicsKesslerSurrogate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PALLAS = "a Pallas kernel: its port is a CUDA kernel behind another name"
_PYTREE = "JAX pytree mechanics; a PyTorch module needs none"
_SEED = "a JAX PRNG seed or key; the port takes a torch.Generator"
_JIT = "JAX compilation mechanics; PyTorch runs eagerly"
_SPMD = ("jax.sharding / shard_map mechanics; the port's mesh "
         "(parallel/) has its own")

# (module, name) -> reason, or (module, name, parameter) -> reason
ALLOWED = {
    ("ops/pallas_recon.py", "direction_fluxes_pallas"): _PALLAS,
    ("ops/pallas_recon.py", "direction_fluxes_pallas_sub"): _PALLAS,
    ("ops/pallas_recon.py", "fct_scale_div_pallas"): _PALLAS,
    ("ops/pallas_recon.py", "fct_scale_div_pallas_sub"): _PALLAS,
    ("ops/elementwise.py", "fused_cellwise"): _PALLAS,
    ("physics/kessler_pallas.py", "kessler_subcycle_pallas"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_ice_pallas"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_collect_pallas"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_rain_pallas"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_ice_lane"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_collect_lane"): _PALLAS,
    ("physics/p3_pallas_lookup.py", "interp_rain_lane"): _PALLAS,
    ("core/coupler.py", "CouplerState.tree_flatten"): _PYTREE,
    ("core/coupler.py", "CouplerState.tree_unflatten"): _PYTREE,
    ("ml/mlp.py", "MLP.tree_flatten"): _PYTREE,
    ("ml/mlp.py", "MLP.tree_unflatten"): _PYTREE,
    ("core/coupler.py", "CouplerMeta.jdtype"):
        "the jnp dtype; the port's is CouplerMeta.tdtype",
    ("dycore/euler.py", "Dycore.__init__", "recon_impl"):
        "the JAX XLA path's dense / fused reconstruction choice; the port "
        "has one reconstruction per algebra",
    ("experiments/driver.py", "run_main_loop", "jit_chain"): _JIT,
    ("physics/kessler.py", "kessler_column", "spmd_axes"): _SPMD,
    ("parallel/mesh.py", "field_pspec"): _SPMD,
    ("dycore/euler.py", "SpmdCtx.axis_names"): _SPMD,
    ("ml/mlp.py", "init_mlp", "key"): _SEED,
    ("physics/perturb.py", "perturb_temperature", "seed"): _SEED,
    ("physics/p3.py", "p3_scheme", "profile_stop"):
        "a JAX profiling hook that stops the scheme part-way; the port's "
        "tests stop at its kernel wrappers instead",
    ("experiments/community_benchmark.py", "run_benchmark",
     "warmup_steps"): "ignored by the JAX package too (one warm-up step)",
    ("physics/p3_tables.py", "lookup_dtype"):
        "the TPU table-lookup dtype; the port's lookups are CUDA kernels",
    ("ops/stencil.py", "gather_stencils"):
        "the JAX dense reconstruction's stencil gather; not ported",
    ("ops/weno.py", "reconstruct_edges"):
        "the dense reconstruction (recon_impl='dense'); not ported",
    ("ops/stencil.py", "pad_bc", "zero_halo"):
        "the JAX halo fill's option to zero the halo; not ported",
    ("parallel/halo.py", "exchange_halos", "zero_halo"):
        "the JAX halo exchange's option to zero the halo; not ported",
    ("utils/profiling.py", "annotate"):
        "the port names a region with span, which also keeps its host and "
        "device time",
}


def _defs(root):
    """{(module path, name): ast function} of the public module-level
    functions and class methods under ``root``."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(("_", ".")))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            for node in tree.body:
                if isinstance(node, ast.FunctionDef):
                    out[(rel, node.name)] = node
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, ast.FunctionDef):
                            out[(rel, f"{node.name}.{sub.name}")] = sub
    return out


def _public(name):
    return all(not part.startswith("_") or part == "__init__"
               for part in name.split("."))


def _params(fn):
    a = fn.args
    return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs],
            a.kwarg is not None)


def test_every_public_name_has_a_counterpart():
    jax_defs = _defs(os.path.join(REPO, "miniweatherml_tpu"))
    port_defs = _defs(os.path.join(REPO, "miniweatherml_tpu_torch"))
    missing, used = [], set()
    for (mod, name), fn in sorted(jax_defs.items()):
        if not _public(name):
            continue
        if (mod, name) in ALLOWED:
            used.add((mod, name))
            continue
        port = port_defs.get((mod, name))
        if port is None:
            missing.append(f"{mod}: {name}")
            continue
        names, kwargs = _params(port)
        for p in _params(fn)[0]:
            if p in ("self", "cls") or p in names or kwargs:
                continue
            if (mod, name, p) in ALLOWED:
                used.add((mod, name, p))
            else:
                missing.append(f"{mod}: {name}({p}=)")
    assert not missing, "no counterpart in the port: " + "; ".join(missing)
    # an allowance that matches nothing has gone stale
    assert set(ALLOWED) == used, sorted(set(ALLOWED) - used)


def _states():
    """The same small state in both packages: a tracer and a field."""
    jst = j_state(JGrid(nx=4, ny=3, nz=2, nens=2))
    pst = make_coupler_state(Grid(nx=4, ny=3, nz=2, nens=2), device="cpu")
    out = []
    for st in (jst, pst):
        st = st.add_tracer("water_vapor")
        out.append(st.register_field("temp"))
    return out


def test_dirty_field_tracking_as_jax():
    """dirty_fields / clear_dirty follow the same writes in both
    packages."""
    jst, pst = _states()
    for st, one in ((jst, jnp.ones(jst["temp"].shape)),
                    (pst, torch.ones(pst["temp"].shape, dtype=torch.float32))):
        st = st.clear_dirty()
        assert st.dirty_fields == frozenset()
        st2 = st.replace_fields(temp=st["temp"] + one)
        st3 = st2.replace_fields(water_vapor=st2["water_vapor"])
        assert st2.dirty_fields == {"temp"}
        assert st3.dirty_fields == {"temp", "water_vapor"}
        assert st3.clear_dirty().dirty_fields == frozenset()
        assert st3.set_options(a=1).dirty_fields == frozenset()


def test_lev_col_and_collapsed_as_jax():
    jst, pst = _states()
    vals = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    jst = jst.replace_fields(temp=jnp.asarray(vals))
    pst = pst.replace_fields(temp=torch.from_numpy(vals))
    np.testing.assert_array_equal(pst.get_lev_col("temp").numpy(),
                                  np.asarray(jst.get_lev_col("temp")))
    np.testing.assert_array_equal(pst.get_collapsed("temp").numpy(),
                                  np.asarray(jst.get_collapsed("temp")))


@pytest.mark.parametrize("flag", [True, False])
def test_validate_takes_positive_only_registered(flag):
    """The keyword is accepted, and both packages check positivity for the
    tracers registered positive only, either way."""
    jst, pst = _states()
    jst = jst.replace_fields(water_vapor=-jnp.ones(jst["temp"].shape),
                             temp=-jnp.ones(jst["temp"].shape))
    pst = pst.replace_fields(water_vapor=-torch.ones(pst["temp"].shape),
                             temp=-torch.ones(pst["temp"].shape))
    assert pst.validate(positive_only_registered=flag) == jst.validate(
        positive_only_registered=flag) == {"water_vapor": "negative"}


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas", "cuda"])
def test_kessler_impl_validates_as_jax(impl):
    """MicrophysicsKessler(impl=) takes and rejects what JAX's does; every
    accepted value runs the one kernel (its arithmetic is shared)."""
    if impl == "cuda":
        for cls in (JKessler, MicrophysicsKessler):
            with pytest.raises(ValueError, match="impl"):
                cls(impl=impl)
        return
    assert MicrophysicsKessler(impl=impl).impl == JKessler(impl=impl).impl
    assert MicrophysicsKessler().impl == "auto"
    assert MicrophysicsKesslerSurrogate.impl == "auto"


def test_inference_surrogate_main_takes_quiet(tmp_path, monkeypatch, capsys):
    """main(argv, quiet=True) runs without the per-step diff lines, as the
    JAX package's does; quiet=False prints them."""
    from miniweatherml_tpu_torch.experiments import inference_surrogate
    from tests.test_torch_cli import SURROGATE, _input
    path = _input(SURROGATE, tmp_path)
    monkeypatch.chdir(tmp_path)
    for quiet in (True, False):
        state = inference_surrogate.main([str(path), "--device", "cpu"],
                                         quiet=quiet)
        out = capsys.readouterr().out
        assert state.validate() == {}
        assert ("mean diff NN - Kessler" in out) == (not quiet)
        assert "Mean diff (NN - Kessler)" in out

"""The port's decomposed physics step (``parallel/spmd.py::make_spmd_step``)
on the CPU in float64: against the JAX package's ``make_spmd_step`` on the
same (2, 2, 2) mesh, and against the port's own undecomposed chain.

Bounds.  Against JAX: the port's chain bar, rtol 1e-9 plus 1e-7 of each
field's scale (tests/test_torch_dycore.py).  Against the undecomposed
chain: a dycore step is the same arithmetic on the same values (the strips
are the cells the global padding would give, the face overwrites and FCT
edges the global ones), and is expected bit for bit; the chain's horizontal
means are reduced shard by shard, which reorders their sums, so one step of
it is held at 1e-12 of each field's scale.  Past one step the microphysics'
thresholds amplify those last-bit differences: a second Kessler step gives
1.3e-11 of water vapour's scale, two P3 steps 1.1e-9 of w's in two cells
(P3's thresholds, ROADMAP Queue 3; P3 alone, without the sponge and nudging
means, stays within 5e-16 for two steps, the CPU's vectorised pow rounding
a shard's shorter rows apart in the second).  The two-step P3 chain is
therefore held at the port's chain bar, rtol 1e-9 plus 1e-7 of scale.
"""


import jax
import numpy as np
import pytest
import torch

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.experiments.supercell_example import build as jax_build
from miniweatherml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from miniweatherml_tpu.parallel.mesh import shard_state as jax_shard_state
from miniweatherml_tpu.parallel.spmd import \
    make_spmd_step as jax_make_spmd_step
from miniweatherml_tpu.physics.column_nudging import ColumnNudger as JNudger
from miniweatherml_tpu.physics.kessler import MicrophysicsKessler as JKessler
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.dycore.euler import SpmdCtx
from miniweatherml_tpu_torch.experiments import supercell_p3
from miniweatherml_tpu_torch.experiments.supercell_example import build
from miniweatherml_tpu_torch.ops.stencil import BC_OPEN, BC_WALL
from miniweatherml_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                                   shard_state)
from miniweatherml_tpu_torch.parallel.spmd import ShardRunner, make_spmd_step
from miniweatherml_tpu_torch.physics.column_nudging import ColumnNudger
from miniweatherml_tpu_torch.physics.kessler import MicrophysicsKessler
from miniweatherml_tpu_torch.physics.sponge import sponge_layer
from tests.test_torch_dycore import (STEP_ATOL_OF_SCALE, STEP_RTOL,
                                     assert_fields_close, to_port)

torch.set_num_threads(1)

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual JAX devices")

DECOMPOSED_OF_SCALE = 1e-12   # one chain step


def _raw(**kw):
    raw = dict(sim_time=100.0, nens=2, nx_glob=16, ny_glob=8, nz=10,
               xlen=40000.0, ylen=40000.0, zlen=10000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0, dtype="float64")
    raw.update(kw)
    return raw


def _mesh():
    mesh = make_mesh(["cpu"] * 8, ens=2)
    assert mesh.shape == {"ens": 2, "y": 2, "x": 2}
    return mesh


def _close(want, got, of_scale, exact=()):
    """Every field of ``got`` within ``of_scale`` of the field's scale of
    ``want``; the fields in ``exact`` bit for bit."""
    assert set(want.fields) == set(got.fields)
    for name in want.fields:
        a, b = want[name], got[name]
        if name in exact:
            assert torch.equal(a, b), name
            continue
        scale = a.abs().max().item()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.0,
                                   atol=of_scale * scale, err_msg=name)


def _chain(dycore, micro, nudger):
    return (dycore.time_step, micro.time_step, sponge_layer,
            nudger.nudge_to_column)


@needs8
def test_spmd_kessler_chain_matches_jax():
    """Kessler + sponge + nudging, one step, both decomposed over (2, 2,
    2): the port against JAX's shard_map step."""
    raw = _raw()
    js, _, jd = jax_build(jax_config(raw))
    dt = jd.compute_time_step(js)
    jmesh = jax_make_mesh(devices=jax.devices()[:8], ens=2)
    jstep = jax_make_spmd_step(js, jmesh, jd, micro=JKessler(),
                               nudger=JNudger())
    jout = jax.jit(lambda s: jstep(s, dt))(jax_shard_state(js, jmesh))

    state, _, dycore = build(config_from_dict(raw), "cpu")
    step = make_spmd_step(state, _mesh(), dycore, micro=MicrophysicsKessler(),
                          nudger=ColumnNudger())
    out = gather_state(step(shard_state(state, _mesh()), dt), "cpu")
    step.close()
    assert_fields_close(jout, out, STEP_RTOL, STEP_ATOL_OF_SCALE)


def test_spmd_matches_undecomposed_chain():
    """The same mesh against the port's own undecomposed run: a dycore
    step bit for bit, a chain step within 1e-12 of each field's scale."""
    state, _, dycore = build(config_from_dict(_raw()), "cpu")
    dt = dycore.compute_time_step(state)
    mesh = _mesh()
    sharded = shard_state(state, mesh)
    dyn = make_spmd_step(state, mesh, dycore, sponge_time_scale=None)
    _close(dycore.time_step(state, dt),
           gather_state(dyn(sharded, dt), "cpu"), 0.0, exact=state.fields)
    dyn.close()

    micro, nudger = MicrophysicsKessler(), ColumnNudger()
    ref = state
    for m in _chain(dycore, micro, nudger):
        ref = m(ref, dt)
    step = make_spmd_step(state, mesh, dycore, micro=micro, nudger=nudger)
    sharded = step(sharded, dt)
    step.close()
    assert sharded.validate() == {}
    _close(ref, gather_state(sharded, "cpu"), DECOMPOSED_OF_SCALE)


def test_spmd_wall_x_open_y_dycore_step():
    """Walls in x and open ends in y, split on both axes (2 x 4): the
    boundary shards fill their strips and overwrite their end faces, the
    interior ones take their neighbours'; bit for bit against the
    undecomposed step."""
    state, _, dycore = build(config_from_dict(_raw(nens=1, nx_glob=16,
                                                   ny_glob=12)), "cpu")
    state = state.set_options(bc_x=BC_WALL, bc_y=BC_OPEN)
    # a cross-flow, so that the wall's zeroed normal velocity shows
    state = state.replace_fields(vvel=state["vvel"] + 2.0)
    dt = dycore.compute_time_step(state)
    mesh = make_mesh(["cpu"] * 8, y=2, x=4)
    step = make_spmd_step(state, mesh, dycore, sponge_time_scale=None)
    out = gather_state(step(shard_state(state, mesh), dt), "cpu")
    step.close()
    _close(dycore.time_step(state, dt), out, 0.0, exact=state.fields)


def test_spmd_p3_chain_matches_undecomposed():
    """P3 (seeded smooth layers), two steps on (2, 2, 2): sedimentation's
    sub-step count is reduced over the shards, one host read per step."""
    cfg = config_from_dict(_raw(zlen=16000.0))
    state, _, dycore = supercell_p3.build(cfg, "cpu")
    state = supercell_p3.seed_layers(state)
    from miniweatherml_tpu_torch.physics.p3 import MicrophysicsP3
    micro, nudger = MicrophysicsP3(), ColumnNudger()
    dt = dycore.compute_time_step(state)
    mesh = _mesh()
    step = make_spmd_step(state, mesh, dycore, micro=micro, nudger=nudger)
    sharded = shard_state(state, mesh)
    ref = state
    for _ in range(2):
        sharded = step(sharded, dt)
        for m in _chain(dycore, micro, nudger):
            ref = m(ref, dt)
    step.close()
    assert float(ref["ice"].max()) > 0.0
    assert_fields_close(ref, gather_state(sharded, "cpu"), STEP_RTOL,
                        STEP_ATOL_OF_SCALE)


def test_spmd_surrogate_compare_matches_undecomposed():
    """The surrogate in compare mode: its mean NN - Kessler diffs are
    pmean'd over the horizontal shards (each ensemble shard keeps its
    own, as in the JAX package)."""
    from miniweatherml_tpu_torch.experiments.inference_surrogate import \
        build as sur_build
    from tests.test_torch_surrogate import _raw as sur_raw
    from tests.test_torch_surrogate import _surrogates
    micro = _surrogates(online=False, compare=True)[1]
    state, mods, dycore = sur_build(config_from_dict(sur_raw()), "cpu",
                                    micro=micro)
    dt = dycore.compute_time_step(state)
    mesh = make_mesh(["cpu"] * 4, y=2, x=2)
    step = make_spmd_step(state, mesh, dycore, micro=micro,
                          nudger=ColumnNudger())
    out = gather_state(step(shard_state(state, mesh), dt), "cpu")
    step.close()
    ref = state
    for m in mods:
        ref = m(ref, dt)
    _close(ref, out, DECOMPOSED_OF_SCALE)


def test_horizontal_sponge_spmd_matches_global():
    """HorizontalSponge wall bands use global indices under a mesh (the
    JAX package's test_horizontal_sponge_spmd_matches_global set-up)."""
    from miniweatherml_tpu.experiments.simple_city import build as jax_city
    from miniweatherml_tpu.physics.horizontal_sponge import \
        HorizontalSponge as JSponge
    from miniweatherml_tpu_torch.physics.horizontal_sponge import \
        HorizontalSponge
    raw = dict(sim_time=1.0, nens=1, nx_glob=48, ny_glob=16, nz=8,
               xlen=2000.0, ylen=2000.0, zlen=500.0, init_data="building",
               out_prefix="t", dt_phys=0.0, out_freq=-1.0,
               enable_gravity=False)
    js = jax_city(jax_config(raw))[0]
    js = js.replace_fields(uvel=js["uvel"] + 3.0)
    ref = JSponge(sponge_cells=5, time_scale=1.0).apply(
        js, 0.5, x1=True, x2=True, y1=True, y2=True)
    state = to_port(js)
    mesh = make_mesh(["cpu"] * 8, y=2, x=4)
    hs = HorizontalSponge(sponge_cells=5, time_scale=1.0)
    axes = {-1: ("x", 4), -2: ("y", 2)}
    runner = ShardRunner(mesh)
    sharded = shard_state(state, mesh)
    out = sharded.replace_shards(runner.run(
        lambda comm, s: hs.apply(s, 0.5, x1=True, x2=True, y1=True,
                                 y2=True, spmd=SpmdCtx(axes)),
        sharded.shards))
    runner.close()
    out = gather_state(out, "cpu")
    for name in ("uvel", "vvel", "temp", "density_dry"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)

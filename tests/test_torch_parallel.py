"""The port's domain decomposition (``miniweatherml_tpu_torch/parallel/``) and
the halo-strip forms of its flux and FCT functions, against the JAX
package, on the CPU in float64.

The JAX side runs on the conftest's eight virtual CPU devices; the port's
meshes are lists of CPU devices (``["cpu"] * 4``), one worker thread per
shard.  Mesh layout and halo exchange must equal the JAX package's exactly.
The strip-form plain flux is held to the JAX XLA path inside
``jax.shard_map`` at rtol 1e-12 plus 1e-12 of the scale (the bound of
tests/test_torch_ops.py: XLA's and libm's pow differ in the last bit) and
to the Pallas kernels in interpret mode at tests/test_pallas.py's rtol 1e-9
between paths; FCT's edge multipliers reproduce the JAX scaling exactly.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from scipy.io import netcdf_file

from miniweatherml_tpu.config import config_from_dict as jax_config
from miniweatherml_tpu.dycore.euler import SpmdCtx as JSpmdCtx
from miniweatherml_tpu.ops.pallas_recon import (direction_fluxes_pallas,
                                                direction_fluxes_pallas_sub)
from miniweatherml_tpu.ops.stencil import pad_bc as jax_pad_bc
from miniweatherml_tpu.parallel.mesh import field_pspec
from miniweatherml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from miniweatherml_tpu.parallel.mesh import \
    near_square_factors as jax_near_square_factors
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import simple_city, supercell_example
from miniweatherml_tpu_torch.experiments.supercell_example import build
from miniweatherml_tpu_torch.io.netcdf import ShardedStateWriter, StateWriter
from miniweatherml_tpu_torch.io.stitch import stitch_sharded
from miniweatherml_tpu_torch.ops.direction_fluxes import (
    direction_fluxes, direction_fluxes_plain)
from miniweatherml_tpu_torch.ops.fct import fct_scale_div, fct_scale_div_plain
from miniweatherml_tpu_torch.ops.weno import weno_matrices
from miniweatherml_tpu_torch.parallel.collectives import pmax, pmean, pmin
from miniweatherml_tpu_torch.parallel.halo import (exchange_face_scalar,
                                                   exchange_halo_strips,
                                                   exchange_halos)
from miniweatherml_tpu_torch.parallel.mesh import (field_split, gather_state,
                                                   local_grid, make_mesh,
                                                   near_square_factors,
                                                   shard_state)
from miniweatherml_tpu_torch.parallel.spmd import ShardRunner
from tests.test_torch_dycore import _case

torch.set_num_threads(1)

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual JAX devices")

DIRS = {"x": (-1, 1), "y": (-2, 2)}   # (axis, normal momentum)
HP = 3                                # halo strip width at ord 5


# -- mesh --------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 7])
def test_near_square_factors_matches_jax(n):
    assert near_square_factors(n) == jax_near_square_factors(n)


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(["cpu"] * 8, ens=2)
    assert mesh.shape == {"ens": 2, "y": 2, "x": 2}
    assert make_mesh(["cpu"] * 8).shape == {"ens": 1, "y": 2, "x": 4}
    assert make_mesh(["cpu"] * 4, y=1, x=4).shape == {"ens": 1, "y": 1,
                                                       "x": 4}
    assert [mesh.coords(r) for r in (0, 3, 5)] == [
        {"ens": 0, "y": 0, "x": 0}, {"ens": 0, "y": 1, "x": 1},
        {"ens": 1, "y": 0, "x": 1}]
    for kw, n in ((dict(ens=0), 4), (dict(ens=2), 1),
                  (dict(ens=1, y=2, x=4), 4)):
        with pytest.raises(ValueError) as port:
            make_mesh(["cpu"] * n, **kw)
        with pytest.raises(ValueError) as ref:
            jax_make_mesh(jax.devices()[:n], **kw)
        assert str(port.value).split(" (")[0] == str(ref.value).split(" (")[0]
    with pytest.raises(ValueError, match="non-positive"):
        near_square_factors(0)


def _states():
    """A supercell (Kessler), a P3 and a city state of the JAX package."""
    from miniweatherml_tpu.core.coupler import Grid, make_coupler_state
    from miniweatherml_tpu.experiments.simple_city import build as city_build
    from miniweatherml_tpu.experiments.supercell_example import \
        build as jax_build
    from miniweatherml_tpu.physics.p3 import MicrophysicsP3
    raw = dict(sim_time=1.0, nens=2, nx_glob=16, ny_glob=8, nz=10,
               xlen=40000.0, ylen=20000.0, zlen=10000.0,
               init_data="supercell", out_prefix="t", dt_phys=0.0,
               out_freq=-1.0)
    kessler = jax_build(jax_config(raw))[0]
    g = Grid(nx=16, ny=8, nz=10, nens=2, xlen=40000.0, ylen=20000.0,
             zlen=16000.0)
    p3 = MicrophysicsP3(use_tables=False).init(make_coupler_state(g))
    city = city_build(jax_config(dict(raw, init_data="city", nz=12,
                                      xlen=2000.0, ylen=2000.0,
                                      zlen=300.0)))[0]
    return kessler, p3, city


def test_field_split_matches_field_pspec():
    for js in _states():
        for name, arr in js.fields.items():
            shape = tuple(arr.shape)
            assert field_split(name, shape, js.grid) == \
                tuple(field_pspec(name, shape, js.grid)), name


def test_shard_and_gather_round_trip():
    state = build(config_from_dict(dict(
        sim_time=1.0, nens=2, nx_glob=16, ny_glob=8, nz=10, xlen=40000.0,
        ylen=20000.0, zlen=10000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0, dtype="float64")), "cpu")[0]
    mesh = make_mesh(["cpu"] * 8, ens=2)
    sharded = shard_state(state, mesh)
    g = sharded.shards[5].grid
    assert (g.nens, g.ny, g.nx, g.dx, g.dy) == (1, 4, 8, state.grid.dx,
                                                state.grid.dy)
    assert sharded.validate() == {}
    # shard (ens 1, y 0, x 1) holds its block
    np.testing.assert_array_equal(sharded.shards[5]["temp"].numpy(),
                                  state["temp"][1:, :, :4, 8:].numpy())
    back = gather_state(sharded, "cpu")
    assert set(back.fields) == set(state.fields)
    for name in state.fields:
        assert torch.equal(back[name], state[name]), name
    bad = sharded.shards[3].replace_fields(
        temp=sharded.shards[3]["temp"] * float("nan"))
    assert sharded.replace_shards(
        sharded.shards[:3] + [bad] + sharded.shards[4:]).validate() == \
        {"temp": "nan"}


def test_local_grid_errors():
    from miniweatherml_tpu_torch.core.coupler import Grid
    g = Grid(nx=16, ny=8, nz=10, nens=2)
    with pytest.raises(ValueError, match="not divisible"):
        local_grid(g, make_mesh(["cpu"] * 3, y=1, x=3))
    with pytest.raises(ValueError, match="sim2d"):
        local_grid(g, make_mesh(["cpu"] * 8, y=8, x=1))


# -- halo exchange -------------------------------------------------------------

def _on_mesh(mesh, fn, items):
    runner = ShardRunner(mesh, timeout=60.0)
    try:
        return runner.run(fn, items)
    finally:
        runner.close()


def _blocks(arr, axis, nshards):
    return list(torch.as_tensor(arr).chunk(nshards, dim=axis))


@pytest.mark.parametrize("bc,zero_var", [(0, None), (1, None), (2, 1)],
                         ids=["periodic", "open", "wall"])
@pytest.mark.parametrize("axis,name", [(-1, "x"), (-2, "y")])
def test_exchange_matches_jax_padding(bc, zero_var, axis, name):
    """Each shard's strips are the cells JAX's pad_bc puts beyond its block
    of the global array; the face planes its neighbours' boundary cells
    (1 at the global boundary)."""
    x = np.random.default_rng(bc - axis).standard_normal((4, 2, 3, 12, 16))
    ns = 4
    mesh = make_mesh(["cpu"] * ns, y=ns if name == "y" else 1,
                     x=ns if name == "x" else 1)
    pad = np.asarray(jax_pad_bc(jnp.asarray(x), axis, HP, bc,
                                zero_var=zero_var))
    nl = x.shape[axis] // ns

    def fn(comm, block):
        strips = exchange_halo_strips(block, axis, HP, name, ns, bc,
                                      zero_var=zero_var)
        padded = exchange_halos(block, axis, HP, name, ns, bc,
                                zero_var=zero_var)
        faces = exchange_face_scalar(block, axis, name, ns)
        return strips, padded, faces

    out = _on_mesh(mesh, fn, _blocks(x, axis, ns))
    for i, ((lo, hi), padded, (left, right)) in enumerate(out):
        want = np.take(pad, range(i * nl, (i + 1) * nl + 2 * HP), axis=axis)
        np.testing.assert_array_equal(padded.numpy(), want)
        np.testing.assert_array_equal(
            lo.numpy(), np.take(want, range(HP), axis=axis))
        np.testing.assert_array_equal(
            hi.numpy(), np.take(want, range(nl + HP, nl + 2 * HP), axis=axis))
        assert lo.is_contiguous() and hi.is_contiguous()
        wl = (np.ones_like(np.take(x, [0], axis=axis)) if i == 0
              else np.take(x, [i * nl - 1], axis=axis))
        wr = (np.ones_like(wl) if i == ns - 1
              else np.take(x, [(i + 1) * nl], axis=axis))
        np.testing.assert_array_equal(left.numpy(), wl)
        np.testing.assert_array_equal(right.numpy(), wr)


def test_exchange_rejects_a_block_narrower_than_the_halo():
    with pytest.raises(ValueError, match="smaller than the halo width"):
        exchange_halo_strips(torch.zeros(5, 1, 2, 4, 2), -1, HP, "x", 4)


def test_failing_shard_fails_the_run_without_hanging():
    """A shard that raises breaks the others' barrier: the run raises the
    shard's own exception at once, whether the shard fails before its
    first collective or between two."""
    mesh = make_mesh(["cpu"] * 4, y=2, x=2)

    def fn(comm, when):
        if comm.rank == 2 and when == 0:
            raise KeyError("shard 2 before the collectives")
        x = comm.pmean(torch.ones(3), "x")
        if comm.rank == 1 and when == 1:
            raise KeyError("shard 1 between collectives")
        return comm.pmax(x, "y")

    for when in (0, 1):
        t0 = time.perf_counter()
        runner = ShardRunner(mesh, timeout=120.0)
        with pytest.raises(KeyError, match="shard"):
            runner.run(fn, [when] * 4)
        assert time.perf_counter() - t0 < 30.0
        # the pool is still usable after the failure
        assert all(torch.equal(r, torch.ones(3))
                   for r in runner.run(fn, [2] * 4))
        runner.close()


def test_reductions_are_in_shard_order_and_group_by_axis():
    mesh = make_mesh(["cpu"] * 8, ens=2)
    vals = [torch.tensor([float(r) + 0.1 * r * r], dtype=torch.float64)
            for r in range(8)]

    def fn(comm, v):
        gen = comm._gen
        hmean = comm.pmean(v, ("y", "x"))
        meetings = comm._gen - gen  # a reduction over two axes: one
        return (comm.pmean(v, "x"), comm.pmin(v, "y"), comm.pmax(v, "y"),
                comm.host_ints((v * 10).to(torch.int64)[0]), hmean,
                meetings)

    out = _on_mesh(mesh, fn, vals)
    for r, (mean, mn, mx, h, hmean, meetings) in enumerate(out):
        c = mesh.coords(r)
        xs = [vals[mesh.rank(c["ens"], c["y"], i)] for i in range(2)]
        ys = [vals[mesh.rank(c["ens"], j, c["x"])] for j in range(2)]
        assert torch.equal(mean, (xs[0] + xs[1]) / 2.0)
        assert torch.equal(mn, torch.minimum(*ys))
        assert torch.equal(mx, torch.maximum(*ys))
        assert h == int(vals[r][0] * 10)
        hs = [vals[mesh.rank(c["ens"], j, i)] for j in range(2)
              for i in range(2)]
        assert torch.equal(hmean, (((hs[0] + hs[1]) + hs[2]) + hs[3]) / 4.0)
        assert meetings == 1


def test_reductions_outside_a_mesh_need_no_axes():
    """The module-level reductions pass ``x`` through for an empty tuple of
    axes (an unsplit run) and raise for a named axis outside a mesh run."""
    x = torch.tensor([1.0, 2.0])
    assert pmean(x, ()) is x and pmin(x, ()) is x and pmax(x, ()) is x
    with pytest.raises(RuntimeError, match="outside a shard"):
        pmean(x, ("x",))


def test_a_shard_that_timed_out_leaves_the_turn_with_its_holder():
    """A shard whose wait for the turn timed out does not hold it, so
    giving its turn up must not release the lock another shard holds."""
    from miniweatherml_tpu_torch.parallel.collectives import ShardGroup
    group = ShardGroup(make_mesh(["cpu"] * 2, x=2), timeout=0.05)
    a, b = group.comm(0), group.comm(1)
    a.take_turn()
    with pytest.raises(threading.BrokenBarrierError):
        b.take_turn()
    b.give_turn()
    assert group.turn.locked() and a.holds_turn and not b.holds_turn
    a.give_turn()
    assert not group.turn.locked()


def test_collectives_under_thread_stress():
    """16 shards (more than the cores) meet 200 times with a shortened
    thread switch interval: every all_gather sees every shard's value of
    that round (a slot overwritten early would show), every pmean is the
    exact mean, and launch counts taken from all threads add up."""
    import sys

    from miniweatherml_tpu_torch.utils.profiling import count, counter
    mesh = make_mesh(["cpu"] * 16, ens=2, y=2, x=4)
    rounds = 200
    name = "stress_test.launches"
    n0 = counter(name)

    def fn(comm, _):
        for k in range(rounds):
            got = comm.all_gather((k, comm.rank))
            assert got == [(k, r) for r in range(mesh.size)], (k, got)
            m = comm.pmean(torch.tensor([float(comm.rank + k)]), "x")
            x0 = comm.peer("x", 0)
            assert m.item() == k + x0 + 1.5, (k, m)
            count(name)
        return comm.rank

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.perf_counter()
    try:
        runner = ShardRunner(mesh, timeout=60.0)
        assert runner.run(fn, [None] * mesh.size) == list(range(mesh.size))
        runner.close()
    finally:
        sys.setswitchinterval(interval)
    assert time.perf_counter() - t0 < 60.0
    assert counter(name) - n0 == rounds * mesh.size


# -- the halo-strip form of the flux and FCT functions -------------------------

@pytest.fixture(scope="module")
def supercell_prim():
    """JAX's de-densitized 16x16x10 supercell state, its dycore, constants
    and background profiles; v (zero at init) gets a varying cross-flow, so
    that a y wall's zeroed normal momentum shows."""
    js, jd, _, _ = _case("supercell", 16, 16, 10)
    s, tr = jd.convert_coupler_to_dynamics(js)
    hy = jd._hy(js)
    full_r = s[0] + hy[0][:, :, None, None]
    prim = jnp.concatenate([s[0:1], s[1:4] / full_r, s[4:5], tr / full_r])
    y = jnp.arange(16.0)[:, None]
    prim = prim.at[2].add(2.0 + 0.5 * jnp.sin(0.7 * y + 0.3 * y.T))
    return jd, js.grid, jd._consts(js), hy, prim


def _shard_strips(prim, axis, bc, nid, ns, i):
    """Shard i's block of ``prim`` along ``axis`` and its strips, cut from
    JAX's padding of the global array."""
    zv = nid if bc == 2 else None
    pad = np.asarray(jax_pad_bc(prim, axis, HP, bc, zero_var=zv))
    nl = prim.shape[axis] // ns
    take = (lambda a, lo, hi: torch.as_tensor(
        np.ascontiguousarray(np.take(a, range(lo, hi), axis=axis))))
    block = take(np.asarray(prim), i * nl, (i + 1) * nl)
    lo = take(pad, i * nl, i * nl + HP)
    hi = take(pad, (i + 1) * nl + HP, (i + 1) * nl + 2 * HP)
    ends = (bc if i == 0 else 0, bc if i == ns - 1 else 0)
    return block, (lo, hi, *ends), nl


def _jax_spmd_fluxes(jd, g, consts, hy, prim, direction, bc, ns):
    """JAX's XLA path for one direction inside shard_map on a 1x1x4 (x) or
    1x4x1 (y) mesh: per shard (state divergence, tracer faces), the
    divergence formed in numpy as the port forms it."""
    axis, nid = DIRS[direction]
    mesh = jax_make_mesh(jax.devices()[:ns], ens=1,
                         y=ns if direction == "y" else 1,
                         x=ns if direction == "x" else 1)
    ctx = JSpmdCtx(axes={axis: (direction, ns)})
    if direction == "x":
        lg = dataclasses.replace(g, nx=g.nx // ns, xlen=g.xlen / ns)
        n, d = lg.nx, lg.dx
    else:
        lg = dataclasses.replace(g, ny=g.ny // ns, ylen=g.ylen / ns)
        n, d = lg.ny, lg.dy

    def local(p, *h):
        return jd._direction_fluxes(lg, consts, h, p, axis, n, bc, nid,
                                    spmd=ctx)

    spec = P(None, "ens", None, "y", "x")
    sf, tf = jax.jit(jax.shard_map(local, mesh=mesh,
                                   in_specs=(spec,) + (P("ens"),) * 4,
                                   out_specs=(spec, spec),
                                   check_vma=False))(prim, *hy)
    ax = tf.ndim + axis
    divs = [-(np.take(f, range(1, n + 1), axis=ax)
              - np.take(f, range(n), axis=ax)) * (1.0 / d)
            for f in np.split(np.asarray(sf), ns, axis=ax)]
    return divs, np.split(np.asarray(tf), ns, axis=ax), d


def _assert_close(got, want, rtol, of_scale):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=of_scale * np.abs(want).max())


@needs8
@pytest.mark.parametrize("bc", [0, 1, 2], ids=["periodic", "open", "wall"])
@pytest.mark.parametrize("direction", ["x", "y"])
def test_strip_form_plain_flux_matches_jax_shard_map(direction, bc,
                                                     supercell_prim):
    """Every shard of a 4-way split, interior and both boundary shards
    (the JAX side jitted; its divergence is formed outside, as the port's
    is)."""
    jd, g, consts, hy, prim = supercell_prim
    axis, nid = DIRS[direction]
    ns = 4
    jdivs, jtfs, d = _jax_spmd_fluxes(jd, g, consts, hy, prim, direction,
                                      bc, ns)
    t = lambda a: torch.as_tensor(np.array(a))
    sdivs, tfs = [], []
    for i in range(ns):
        block, strips, nl = _shard_strips(prim, axis, bc, nid, ns, i)
        sdiv, tf = direction_fluxes(block, axis, nl, bc, nid, consts.C0,
                                    consts.gamma, t(hy[0]), t(hy[1]),
                                    weno_matrices(5), 0.0, 1.0 / d, strips)
        sdivs.append(sdiv)
        tfs.append(tf)
    # the scale is the whole field's, as in tests/test_torch_ops.py
    sdiv, jdiv = torch.cat(sdivs, dim=axis), np.concatenate(jdivs, axis=axis)
    for v in range(5):
        _assert_close(sdiv[v], jdiv[v], 1e-12, 1e-12)
    _assert_close(torch.cat(tfs, dim=axis), np.concatenate(jtfs, axis=axis),
                  1e-12, 1e-12)


@pytest.mark.parametrize("case", ["interior", "wall_lo", "open_hi"])
@pytest.mark.parametrize("direction", ["x", "y"])
def test_strip_form_plain_flux_matches_pallas(direction, case,
                                              supercell_prim):
    """The strip-form plain flux against the JAX package's Pallas kernels
    (interpret mode, exact weights, the XLA path's operation order) given
    the same strips and end modes: face fluxes differenced in numpy."""
    jd, g, consts, hy, prim = supercell_prim
    axis, nid = DIRS[direction]
    ns = 4
    bc, i = {"interior": (2, 1), "wall_lo": (2, 0), "open_hi": (1, 3)}[case]
    block, strips, nl = _shard_strips(prim, axis, bc, nid, ns, i)
    lo, hi, bc_lo, bc_hi = strips
    nvar, nens, nz, ny, nx = block.shape
    hyc, hyt = np.array(hy[0]), np.array(hy[1])
    args = (jd.mats, 0.0, nid, consts.C0, consts.gamma)
    # the Pallas kernels' end modes: 0 none, 1 wall, 2 open
    mode = {0: 0, 2: 1, 1: 2}
    kw = dict(fast_weights=False, opt=False, bc=(mode[bc_lo], mode[bc_hi]))
    j = lambda a, shape: jnp.asarray(a.numpy().reshape(shape))
    if direction == "x":
        B = nens * nz * ny
        rows = np.broadcast_to(hyc[:, :, None], (nens, nz, ny)).reshape(-1)
        rowt = np.broadcast_to(hyt[:, :, None], (nens, nz, ny)).reshape(-1)
        SF, TF = direction_fluxes_pallas(
            j(block, (nvar, B, nl)), j(lo, (nvar, B, HP)),
            j(hi, (nvar, B, HP)),
            jnp.asarray(np.broadcast_to(rows[:, None], (B, nl + 1))),
            jnp.asarray(np.broadcast_to(rowt[:, None], (B, nl + 1))),
            nl, *args, **kw)
        d = g.dx
    else:
        R = nens * nz
        SF, TF = direction_fluxes_pallas_sub(
            j(block, (nvar, R, nl, nx)), j(lo, (nvar, R, HP, nx)),
            j(hi, (nvar, R, HP, nx)), jnp.asarray(hyc.reshape(-1, 1)),
            jnp.asarray(hyt.reshape(-1, 1)), nl, *args, **kw)
        d = g.dy
    fshape = list(block.shape)
    fshape[axis] += 1
    SF = np.asarray(SF).reshape([5] + fshape[1:])
    TF = np.asarray(TF).reshape([nvar - 5] + fshape[1:])
    ax = SF.ndim + axis
    jdiv = -(np.take(SF, range(1, nl + 1), axis=ax)
             - np.take(SF, range(nl), axis=ax)) / d
    sdiv, tf = direction_fluxes_plain(
        block, axis, nl, bc, nid, consts.C0, consts.gamma,
        torch.as_tensor(hyc), torch.as_tensor(hyt), weno_matrices(5), 0.0,
        1.0 / d, strips)
    for v in range(5):
        _assert_close(sdiv[v], jdiv[v], 1e-9, 1e-9)
    _assert_close(tf, TF, 1e-9, 1e-9)


@pytest.mark.parametrize("case", ["interior", "wall_lo", "open_hi"])
@pytest.mark.parametrize("direction", ["x", "y"])
def test_strip_form_plain_opt_flux_matches_pallas(direction, case,
                                                  supercell_prim):
    """The strip form in the reduced-operation algebra (``opt=True``, the
    Pallas kernels' default) against the Pallas kernels in it, exact
    weights, same strips and end modes, at the bound of the reference
    form's test above."""
    jd, g, consts, hy, prim = supercell_prim
    axis, nid = DIRS[direction]
    bc, i = {"interior": (2, 1), "wall_lo": (2, 0), "open_hi": (1, 3)}[case]
    block, strips, nl = _shard_strips(prim, axis, bc, nid, 4, i)
    lo, hi, bc_lo, bc_hi = strips
    nvar, nens, nz, ny, nx = block.shape
    hyc, hyt = np.array(hy[0]), np.array(hy[1])
    args = (jd.mats, 0.0, nid, consts.C0, consts.gamma)
    mode = {0: 0, 2: 1, 1: 2}
    kw = dict(fast_weights=False, opt=True, bc=(mode[bc_lo], mode[bc_hi]))
    j = lambda a, shape: jnp.asarray(a.numpy().reshape(shape))  # noqa: E731
    if direction == "x":
        B = nens * nz * ny
        rows = np.broadcast_to(hyc[:, :, None], (nens, nz, ny)).reshape(-1)
        rowt = np.broadcast_to(hyt[:, :, None], (nens, nz, ny)).reshape(-1)
        SF, TF = direction_fluxes_pallas(
            j(block, (nvar, B, nl)), j(lo, (nvar, B, HP)),
            j(hi, (nvar, B, HP)),
            jnp.asarray(np.broadcast_to(rows[:, None], (B, nl + 1))),
            jnp.asarray(np.broadcast_to(rowt[:, None], (B, nl + 1))),
            nl, *args, **kw)
        d = g.dx
    else:
        R = nens * nz
        SF, TF = direction_fluxes_pallas_sub(
            j(block, (nvar, R, nl, nx)), j(lo, (nvar, R, HP, nx)),
            j(hi, (nvar, R, HP, nx)), jnp.asarray(hyc.reshape(-1, 1)),
            jnp.asarray(hyt.reshape(-1, 1)), nl, *args, **kw)
        d = g.dy
    fshape = list(block.shape)
    fshape[axis] += 1
    SF = np.asarray(SF).reshape([5] + fshape[1:])
    TF = np.asarray(TF).reshape([nvar - 5] + fshape[1:])
    ax = SF.ndim + axis
    jdiv = -(np.take(SF, range(1, nl + 1), axis=ax)
             - np.take(SF, range(nl), axis=ax)) / d
    sdiv, tf = direction_fluxes_plain(
        block, axis, nl, bc, nid, consts.C0, consts.gamma,
        torch.as_tensor(hyc), torch.as_tensor(hyt), weno_matrices(5), 0.0,
        1.0 / d, strips, opt=True)
    for v in range(5):
        _assert_close(sdiv[v], jdiv[v], 1e-9, 1e-9)
    _assert_close(tf, TF, 1e-9, 1e-9)


def test_strip_form_wants_its_strips_on_the_card():
    """A tensor on neither the CPU nor CUDA is refused, with or without
    strips (a CUDA tensor launches the kernel or raises: no fallback)."""
    prim = torch.zeros((8, 1, 4, 4, 4), device="meta")
    hy = torch.zeros((1, 4), device="meta")
    strips = (prim[..., :3], prim[..., :3], 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        direction_fluxes(prim, -1, 4, 0, 1, 1.0, 1.4, hy, hy,
                         weno_matrices(5), 0.0, 1.0, strips)
    mult = torch.zeros((3, 1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        fct_scale_div(torch.zeros((3, 1, 4, 4, 5), device="meta"), mult,
                      None, -1, 4, 1.0, edges=(mult[..., :1], mult[..., :1]))


@needs8
@pytest.mark.parametrize("form", ["first", "accumulate", "rk"])
@pytest.mark.parametrize("direction", ["x", "y"])
def test_fct_edges_match_jax_fct_scale_dir(direction, form):
    """fct_scale_div_plain with the neighbours' multipliers (the port's
    exchange_face_scalar) against JAX's _fct_scale_dir with its
    exchange_face_scalar inside shard_map, plus the divergence and the
    form's epilogue written out in numpy: equal bit for bit."""
    from miniweatherml_tpu.core.coupler import Grid as JGrid
    from miniweatherml_tpu.dycore.euler import Dycore as JDycore
    axis = DIRS[direction][0]
    ns = 4
    rng = np.random.default_rng(abs(axis))
    shape = (3, 2, 4, 8, 16)
    fshape = list(shape)
    fshape[axis] += ns        # every shard's n + 1 faces
    F = rng.standard_normal(fshape)
    F[rng.random(fshape) < 0.1] = 0.0
    mult = rng.uniform(0.05, 1.0, shape)
    mult[rng.random(shape) < 0.3] = 1.0
    t_prev = rng.standard_normal(shape)
    tr0, tr1 = rng.uniform(-0.2, 1.0, (2,) + shape)
    positive = (True, False, True)
    g = JGrid(nx=16, ny=8, nz=4, nens=2)
    jd = JDycore(ord=5)
    mesh = jax_make_mesh(jax.devices()[:ns], ens=1,
                         y=ns if direction == "y" else 1,
                         x=ns if direction == "x" else 1)
    ctx = JSpmdCtx(axes={axis: (direction, ns)})
    spec = P(None, "ens", None, "y", "x")
    Fs = jax.shard_map(lambda m, f: jd._fct_scale_dir(g, m, f, axis, ctx),
                       mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                       check_vma=False)(jnp.asarray(mult), jnp.asarray(F))
    Fs = np.split(np.asarray(Fs), ns, axis=axis)
    dxi = 1.0 / 250.0
    blocks = [_blocks(a, axis, ns) for a in (mult, t_prev, tr0, tr1)]
    Fb = _blocks(F, axis, ns)
    mesh_t = make_mesh(["cpu"] * ns, y=ns if direction == "y" else 1,
                       x=ns if direction == "x" else 1)
    edges = _on_mesh(mesh_t, lambda comm, m: exchange_face_scalar(
        m, axis, direction, ns), blocks[0])
    for i in range(ns):
        m, tp, t0, t1 = (b[i].contiguous() for b in blocks)
        nl = m.shape[axis]
        fs = Fs[i]
        acc = (np.take(fs, range(nl), axis=axis)
               - np.take(fs, range(1, nl + 1), axis=axis)) * dxi
        rk = None
        prev = None if form == "first" else tp.clone()
        if form != "first":
            acc = tp.numpy() + acc
        if form == "rk":
            rk = (0.75, 0.25, 0.1, t0, t1, positive)
            v = 0.75 * t0.numpy() + 0.25 * t1.numpy() + 0.1 * acc
            acc = np.stack([np.maximum(v[k], 0.0) if p else v[k]
                            for k, p in enumerate(positive)])
        got = fct_scale_div_plain(Fb[i].contiguous(), m, prev, axis, nl, dxi,
                                  rk, edges[i])
        np.testing.assert_array_equal(got.numpy(), acc)


# -- output ----------------------------------------------------------------------

def test_sharded_writer_and_stitch_round_trip_bitwise(tmp_path):
    """Shard-write a state on a 2x4 mesh, stitch, and compare bit for bit
    with what StateWriter writes from the gathered global state (the JAX
    package's tests/test_io.py check, in the port)."""
    state = build(config_from_dict(dict(
        sim_time=1.0, nens=1, nx_glob=32, ny_glob=16, nz=8, xlen=32000.0,
        ylen=16000.0, zlen=8000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0)), "cpu")[0]
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape == {"ens": 1, "y": 2, "x": 4}
    st = shard_state(state, mesh)
    sw = ShardedStateWriter(str(tmp_path / "sharded"), st)
    sw.write(st, 0.0)
    sw.write(st, 10.0)
    sw.close()
    gw = StateWriter(str(tmp_path / "global"), gather_state(st, "cpu"))
    gw.write(state, 0.0)
    gw.write(state, 10.0)
    gw.close()
    with netcdf_file(str(tmp_path / "sharded_task_5.nc"), "r",
                     mmap=False) as nc:
        assert (nc.i_beg, nc.j_beg) == (8, 8)
        assert nc.variables["temp"].shape == (2, 8, 8, 8)
    out = stitch_sharded(str(tmp_path / "sharded"))
    with netcdf_file(out, "r", mmap=False) as got, \
            netcdf_file(str(tmp_path / "global.nc"), "r", mmap=False) as want:
        assert set(got.variables) == set(want.variables)
        for name in want.variables:
            np.testing.assert_array_equal(got.variables[name][:],
                                          want.variables[name][:],
                                          err_msg=name)


def _read(path):
    with netcdf_file(path, "r", mmap=False) as nc:
        return ({k: v[:].copy() for k, v in nc.variables.items()},
                {k: getattr(nc, k) for k in ("i_beg", "j_beg")
                 if hasattr(nc, k)})


def _assert_same_file(port_path, jax_path, rtol=1e-9, of_scale=1e-7):
    (pv, pa), (jv, ja) = _read(port_path), _read(jax_path)
    assert pa == ja
    assert set(pv) == set(jv)
    for name, a in jv.items():
        assert pv[name].shape == a.shape, name
        np.testing.assert_allclose(pv[name], a, rtol=rtol,
                                   atol=of_scale * np.abs(a).max(),
                                   err_msg=name)


# supercell_example's tiny grid: one step, written at t=0 and after it
_SUPERCELL = dict(sim_time=1.0, nens=1, nx_glob=16, ny_glob=8, nz=10,
                  xlen=40000.0, ylen=40000.0, zlen=10000.0,
                  init_data="supercell", dt_phys=0.0, out_freq=0.5,
                  file_per_process=True, dtype="float64")


def test_supercell_example_file_per_process_matches_jax(tmp_path, capsys):
    """``file_per_process: true`` writes ``<out_prefix>_task_0.nc`` with the
    JAX package's names, offsets and values (step bound of
    tests/test_torch_dycore.py)."""
    from miniweatherml_tpu.experiments import supercell_example as jax_ex
    raw = dict(_SUPERCELL, out_prefix=str(tmp_path / "port"))
    supercell_example.run(config_from_dict(raw), "cpu")
    path = tmp_path / "in.yaml"
    import yaml
    path.write_text(yaml.safe_dump(dict(raw,
                                        out_prefix=str(tmp_path / "jax"))))
    jax_ex.main([str(path)])
    capsys.readouterr()
    assert sorted(p.name for p in tmp_path.glob("*.nc")) == [
        "jax_task_0.nc", "port_task_0.nc"]
    _assert_same_file(tmp_path / "port_task_0.nc", tmp_path / "jax_task_0.nc")


def test_simple_city_file_per_process_matches_jax(tmp_path, capsys,
                                                  monkeypatch):
    """The building case: ``file_per_process`` no longer raises and writes
    the JAX package's ``_task_0`` file.  Only the initial snapshot is
    written: from rest, the walls make the upwind choice a round-off tie
    after a step (ROADMAP Queue 3), and the experiment has no cross-flow
    to take it off the tie; the stepped chain's parity is
    tests/test_torch_city.py's."""
    from miniweatherml_tpu.experiments import simple_city as jax_city
    monkeypatch.chdir(tmp_path)
    raw = dict(sim_time=0.05, nens=1, nx_glob=48, ny_glob=16, nz=16,
               xlen=2000.0, ylen=2000.0, zlen=500.0, init_data="building",
               dt_phys=0.0, out_freq=1.0, enable_gravity=False,
               file_per_process=True, dtype="float64")
    port = simple_city.run(config_from_dict(dict(
        raw, out_prefix=str(tmp_path / "port"))), "cpu")
    import yaml
    path = tmp_path / "in.yaml"
    path.write_text(yaml.safe_dump(dict(raw,
                                        out_prefix=str(tmp_path / "jax"))))
    jax_state = jax_city.main([str(path)])
    capsys.readouterr()
    assert (tmp_path / "port_task_0.nc").exists()
    assert (tmp_path / "jax_task_0.nc").exists()
    assert not (tmp_path / "port.nc").exists()
    del port, jax_state
    _assert_same_file(tmp_path / "port_task_0.nc", tmp_path / "jax_task_0.nc",
                      rtol=1e-12, of_scale=1e-12)

"""The flux kernel's accumulator and SSPRK3 stage-update forms
(``direction_fluxes(..., acc=, rk=)``, the Pallas kernel's ``acc`` and
``rk``), on the CPU in float64 (and float32 for whole steps).

* Against the JAX package: the plain forms against JAX's
  ``direction_fluxes_pallas_sub(..., div_scale=, acc=, rk=)`` in interpret
  mode with exact weights (``fast_weights=False, opt=False``): z
  accumulating, y with the stage update in stage 1 (no ``b1``) and stages 2-3
  (with ``b1``), gravity on and off, a nonzero Coriolis parameter.  Bound:
  rtol 1e-9 plus 1e-9 of each variable's scale, the bound of the bare form
  against the Pallas kernels (tests/test_torch_parallel.py).  The two differ
  beyond rounding order in one place: JAX's epilogue takes Coriolis as
  fcor * (rho * v) of the prim block, the port as fcor * (rho v) of the
  stage's state (the XLA path's form), one rounding apart.
* Against the eager composition the dycore ran before the epilogues moved
  into the flux call (three bare divergences summed, then gravity,
  Coriolis, the 2-D v = 0, the immersed blend and the stage combination,
  rebuilt here from bare ``direction_fluxes_plain`` calls): bit for bit,
  for the building (immersed), the 2-D thermal (z last), the halo-strip
  form and 12 tracers (two groups, the epilogue applied once), and whole
  ``Dycore.time_step`` calls of the supercell (with and without Coriolis),
  thermal, building and city cases.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniweatherml_tpu.ops.pallas_recon import direction_fluxes_pallas_sub
from miniweatherml_tpu_torch.core.coupler import Grid, make_coupler_state
from miniweatherml_tpu_torch.dycore.euler import Dycore
from miniweatherml_tpu_torch.ops.direction_fluxes import (
    IDR, IDT, IDU, IDV, IDW, StageUpdate, direction_fluxes,
    direction_fluxes_plain, in_tracer_groups)
from miniweatherml_tpu_torch.physics.kessler import MicrophysicsKessler
from miniweatherml_tpu_torch.physics.perturb import perturb_temperature

torch.set_num_threads(1)

_AX_X, _AX_Y, _AX_Z = -1, -2, -3
# the Pallas kernels' boundary modes of the port's bc: 0 none, 1 wall, 2 open
_MODE = {0: 0, 2: 1, 1: 2}
# (c0, c1, cdt) of SSPRK3 stages 1-3 at dt = 0.6
_DT = 0.6
_STAGES = {1: (1.0, 0.0, _DT), 2: (0.75, 0.25, 0.25 * _DT),
           3: (1.0 / 3.0, 2.0 / 3.0, (2.0 / 3.0) * _DT)}


def _state(case, nx, ny, nz, dtype="float64", latitude=None):
    """A perturbed initial state of ``case`` and its dycore; ``latitude``
    sets a nonzero Coriolis parameter (the inits set latitude 0)."""
    xlen, ylen, zlen, nens = ((2000.0, 2000.0, 300.0, 2) if case == "city"
                              else (40000.0, 40000.0, 10000.0, 1))
    opts = {"init_data": case, "out_freq": -1.0}
    if case == "city":
        opts["enable_gravity"] = False
    g = Grid(nx=nx, ny=ny, nz=nz, nens=nens, xlen=xlen, ylen=ylen, zlen=zlen)
    ps = MicrophysicsKessler().init(
        make_coupler_state(g, dtype=dtype, options=opts, device="cpu"))
    pd = Dycore(ord=5)
    ps = perturb_temperature(pd.init(ps))
    if latitude is not None:
        ps = ps.set_options(latitude=latitude)
    if case == "city":  # off the upwind tie at rest (test_torch_dycore.py)
        ps = ps.replace_fields(vvel=torch.full_like(ps["vvel"], 2.0),
                               wvel=torch.full_like(ps["wvel"], 0.5))
    return ps, pd


def _prim(s, tr, hyc):
    """The de-densitized variables the dycore hands each direction."""
    full_r = s[IDR] + hyc[:, :, None, None]
    return torch.cat([s[IDR:IDU], s[IDU:IDT] / full_r, s[IDT:IDT + 1],
                      tr / full_r])


def _stage_inputs(ps, pd, stage, seed=5):
    """(prim, b0, b1): the step's base b0 (the state), the previous stage's
    state b1 (b0 with seeded relative noise of 1e-3; None in stage 1), and
    the prim of the state the tendency is taken of (b1, else b0)."""
    s, tr = pd.convert_coupler_to_dynamics(ps)
    b1 = None
    if stage > 1:
        rng = np.random.default_rng(seed)
        b1 = s * (1.0 + 1e-3 * torch.as_tensor(rng.standard_normal(s.shape),
                                                dtype=s.dtype))
    cur = s if b1 is None else b1
    return _prim(cur, tr, ps["hy_dens_cells"]).contiguous(), s, b1


def _dirs(ps, pd):
    """(axis, n, bc, normal id, cell width, hy_r, hy_t) of x, z, y."""
    g, c = ps.grid, pd._consts(ps)
    hyc, hyt, hye, hyte = pd._hy(ps)
    return {_AX_X: (_AX_X, g.nx, c.bc_x, IDU, g.dx, hyc, hyt),
            _AX_Z: (_AX_Z, g.nz, c.bc_z, IDW, g.dz, hye, hyte),
            _AX_Y: (_AX_Y, g.ny, c.bc_y, IDV, g.dy, hyc, hyt)}


def _call(fn, prim, d, pd, c, **kw):
    axis, n, bc, nid, width, hr, ht = d
    return fn(prim, axis, n, bc, nid, c.C0, c.gamma, hr, ht, pd.mats,
              pd.cutoff, 1.0 / width, **kw)


def _rk(ps, pd, stage, b0, b1, grav=True, fcor=None):
    c = pd._consts(ps)
    return StageUpdate(
        *_STAGES[stage], b0, b1, ps["hy_dens_cells"],
        c.grav if (grav and c.enable_gravity) else None,
        c.fcor if fcor is None else fcor,
        ps["immersed_proportion"] if c.use_immersed else None,
        _DT, ps.grid.sim2d)


# -- against the JAX package's Pallas kernel ---------------------------------

def _assert_close(got, want, rtol, of_scale):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=of_scale * np.abs(want).max())


def _jax_sub(prim, d, ps, pd, acc, rk=None):
    """JAX's ``direction_fluxes_pallas_sub`` on the layout its dycore hands
    it (``Dycore._direction_fluxes``, whole axis: in-kernel halos), the
    state output reshaped back to (5, nens, nz, ny, nx)."""
    axis, n, bc, nid, width, hr, ht = d
    g, c = ps.grid, pd._consts(ps)
    nvar = prim.shape[0]
    if axis == _AX_Y:
        shape = (g.nens * g.nz, n, g.nx)
        hy_r = hr.numpy().reshape(-1, 1)
        hy_t = ht.numpy().reshape(-1, 1)
    else:
        shape = (g.nens, n, g.ny * g.nx)
        hy_r, hy_t = hr.numpy(), ht.numpy()

    def j(a, rows):
        return None if a is None else jnp.asarray(
            a.numpy().reshape((rows,) + shape))
    mode = _MODE[bc]
    kw = dict(fast_weights=False, opt=False, bc=(mode, mode),
              div_scale=1.0 / width, self_bc=mode, acc=j(acc, 5))
    if rk is not None:
        kw["rk"] = (np.array([rk.c0, rk.c1, rk.cdt]), j(rk.b0, 5),
                    j(rk.b1, 5), 0.0 if rk.grav is None else rk.grav,
                    rk.fcor)
    sf, _ = direction_fluxes_pallas_sub(
        j(prim, nvar), None, None, jnp.asarray(hy_r), jnp.asarray(hy_t), n,
        pd.mats, pd.cutoff, nid, c.C0, c.gamma, **kw)
    return np.asarray(sf).reshape((5,) + tuple(prim.shape[1:]))


# (direction, stage, gravity, Coriolis parameter or None for the case's 0)
JAX_FORMS = {"z_acc": (_AX_Z, None, True, None),
             "y_stage1": (_AX_Y, 1, True, None),
             "y_stage1_no_gravity": (_AX_Y, 1, False, None),
             "y_stage2": (_AX_Y, 2, True, None),
             "y_stage3_coriolis": (_AX_Y, 3, True, 1.0e-3)}


@pytest.fixture(scope="module")
def supercell():
    return _state("supercell", 16, 8, 10)


@pytest.mark.parametrize("form", list(JAX_FORMS))
def test_plain_form_matches_jax_kernel(form, supercell):
    ps, pd = supercell
    axis, stage, grav, fcor = JAX_FORMS[form]
    prim, b0, b1 = _stage_inputs(ps, pd, stage or 1)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    # the running tendency: x's divergence (and z's, before y)
    acc = _call(direction_fluxes_plain, prim, dirs[_AX_X], pd, c)[0]
    if axis == _AX_Y:
        acc = acc + _call(direction_fluxes_plain, prim, dirs[_AX_Z], pd,
                          c)[0]
    rk = None if stage is None else _rk(ps, pd, stage, b0, b1, grav, fcor)
    want = _jax_sub(prim, dirs[axis], ps, pd, acc, rk)
    buf = acc.clone()
    got, _ = _call(direction_fluxes_plain, prim, dirs[axis], pd, c, acc=buf,
                   rk=rk)
    assert got is buf
    if rk is not None:
        assert (rk.grav is not None) == grav
    for v in range(5):
        _assert_close(got[v], want[v], 1e-9, 1e-9)


# -- against the eager composition --------------------------------------------

def _eager_stage(st, s, rk, stage):
    """The dycore's former eager sources, blend and stage combination
    (``_tendencies`` + ``_ssprk3`` before the epilogues): ``s`` is the state
    the tendency ``st`` was taken of."""
    if rk.grav is not None:
        st[IDW] = st[IDW] - rk.grav * (s[IDR] + rk.hy_r[:, :, None, None])
    if rk.fcor != 0.0:
        st[IDU] = st[IDU] + rk.fcor * s[IDV]
        st[IDV] = st[IDV] - rk.fcor * s[IDU]
    if rk.sim2d:
        st[IDV] = 0.0
    if rk.immersed is not None:
        tau = 1.0e3 * rk.dt
        fac = -min(1.0, rk.dt / tau) / rk.dt
        imm_tend = fac * s
        prop = rk.immersed[None]
        st = prop * imm_tend + (1.0 - prop) * st
    if stage == 1:
        return rk.b0 + _DT * st
    if stage == 2:
        return 0.75 * rk.b0 + 0.25 * rk.b1 + 0.25 * _DT * st
    return (1.0 / 3.0) * rk.b0 + (2.0 / 3.0) * rk.b1 + (2.0 / 3.0) * _DT * st


def _chain(fn, prim, dirs, pd, c, rk, strips=None):
    """x (writes), z (accumulates; the stage in 2-D), y (the stage)."""
    sx = strips.get(_AX_X) if strips else None
    sy = strips.get(_AX_Y) if strips else None
    acc, _ = _call(fn, prim, dirs[_AX_X], pd, c, strips=sx)
    out, _ = _call(fn, prim, dirs[_AX_Z], pd, c, acc=acc,
                   rk=rk if rk.sim2d else None)
    if not rk.sim2d:
        out, _ = _call(fn, prim, dirs[_AX_Y], pd, c, strips=sy, acc=acc,
                       rk=rk)
    assert out is acc
    return out


def _eager(prim, dirs, pd, c, rk, stage, strips=None):
    sx = strips.get(_AX_X) if strips else None
    sy = strips.get(_AX_Y) if strips else None
    bare = lambda ax, st=None: _call(direction_fluxes_plain, prim,  # noqa
                                     dirs[ax], pd, c, strips=st)[0]
    st = bare(_AX_X, sx) + bare(_AX_Z)
    if not rk.sim2d:
        st = st + bare(_AX_Y, sy)
    return _eager_stage(st, rk.b0 if rk.b1 is None else rk.b1, rk, stage)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("case", ["building", "thermal", "supercell"])
def test_chain_equals_eager_composition(case, stage):
    """x, z accumulating and the last direction's stage update equal the
    eager sum, sources, blend and combination bit for bit: the building's
    immersed blend, the 2-D thermal's z-last stage with v = 0, and the
    supercell with a Coriolis parameter."""
    dims = {"building": (48, 16, 16), "thermal": (24, 1, 12),
            "supercell": (16, 8, 10)}[case]
    ps, pd = _state(case, *dims,
                    latitude=0.7 if case == "supercell" else None)
    prim, b0, b1 = _stage_inputs(ps, pd, stage)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    rk = _rk(ps, pd, stage, b0, b1)
    assert (rk.immersed is not None) == (case == "building")
    assert rk.sim2d == (case == "thermal")
    assert (rk.fcor != 0.0) == (case == "supercell")
    want = _eager(prim, dirs, pd, c, rk, stage)
    assert torch.equal(_chain(direction_fluxes_plain, prim, dirs, pd, c, rk),
                       want)
    # the wrapper takes the same plain forms for CPU tensors
    assert torch.equal(_chain(direction_fluxes, prim, dirs, pd, c, rk), want)


def _strips(prim, axis, hp):
    """Halo strips of a split axis: the cells the ring neighbours would send
    on a periodic axis (its other end), contiguous."""
    n = prim.shape[axis]
    return (prim.narrow(axis, n - hp, hp).contiguous(),
            prim.narrow(axis, 0, hp).contiguous(), 0, 0)


@pytest.mark.parametrize("stage", [1, 3])
def test_strip_form_chain_equals_eager_composition(stage):
    """The halo-strip form on x and y (a mesh shard's split axes) with the
    stage update on y."""
    ps, pd = _state("building", 48, 16, 16)
    prim, b0, b1 = _stage_inputs(ps, pd, stage)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    rk = _rk(ps, pd, stage, b0, b1)
    hp = (pd.ord - 1) // 2 + 1
    strips = {ax: _strips(prim, ax, hp) for ax in (_AX_X, _AX_Y)}
    want = _eager(prim, dirs, pd, c, rk, stage, strips)
    got = _chain(direction_fluxes_plain, prim, dirs, pd, c, rk, strips)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["supercell", "thermal"])
def test_tracer_groups_apply_the_epilogue_once(case):
    """12 tracers (two groups of the card's launch): the accumulator and the
    stage update reach the first group only, and the result equals one call
    and the eager composition bit for bit."""
    dims = {"thermal": (24, 1, 12), "supercell": (16, 8, 10)}[case]
    ps, pd = _state(case, *dims)
    prim, b0, b1 = _stage_inputs(ps, pd, 2)
    rng = np.random.default_rng(12)
    extra = torch.as_tensor(rng.uniform(0.0, 1e-3, (9,) + prim.shape[1:]))
    prim = torch.cat([prim, extra])
    assert prim.shape[0] == 17
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    rk = _rk(ps, pd, 2, b0, b1)
    seen = []

    def launch(p, *a, strips=None, acc=None, rk=None):
        seen.append((p.shape[0], acc is not None, rk is not None))
        return direction_fluxes_plain(p, *a, strips=strips, acc=acc, rk=rk)
    last = _AX_Z if rk.sim2d else _AX_Y
    acc = _call(direction_fluxes_plain, prim, dirs[_AX_X], pd, c)[0]
    if not rk.sim2d:
        acc = acc + _call(direction_fluxes_plain, prim, dirs[_AX_Z], pd,
                          c)[0]
    one = _call(direction_fluxes_plain, prim, dirs[last], pd, c,
                acc=acc.clone(), rk=rk)
    got = _call(lambda *a, **k: in_tracer_groups(launch, *a, **k), prim,
                dirs[last], pd, c, acc=acc.clone(), rk=rk)
    assert seen == [(14, True, True), (8, False, False)]
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    assert torch.equal(got[0], _eager(prim, dirs, pd, c, rk, 2))


def test_stage_update_needs_the_accumulator():
    ps, pd = _state("supercell", 16, 8, 10)
    prim, b0, _ = _stage_inputs(ps, pd, 1)
    dirs, c = _dirs(ps, pd), pd._consts(ps)
    with pytest.raises(ValueError, match="accumulator"):
        _call(direction_fluxes_plain, prim, dirs[_AX_Y], pd, c,
              rk=_rk(ps, pd, 1, b0, None))


# -- whole dycore steps ---------------------------------------------------------

class _EagerDycore(Dycore):
    """The dycore as it composed a stage before the epilogues: bare
    divergences summed, the sources, the immersed blend and the state's
    stage combinations as eager tensor code."""

    def _ssprk3(self, grid, consts, hy, immersed, positive, s, tr, dt,
                spmd=None):
        def tend(s_, tr_, dt_, c0, c1, cdt, tr1):
            return self._eager_tendencies(grid, consts, hy, immersed,
                                          positive, s_, tr_, dt_,
                                          (c0, c1, cdt, tr, tr1))

        st, t1 = tend(s, tr, dt, 1.0, 0.0, dt, None)
        s1 = s + dt * st
        st, t2 = tend(s1, t1, dt / 4.0, 0.75, 0.25, 0.25 * dt, t1)
        s2 = 0.75 * s + 0.25 * s1 + 0.25 * dt * st
        st, t3 = tend(s2, t2, 2.0 * dt / 3.0, 1.0 / 3.0, 2.0 / 3.0,
                      (2.0 / 3.0) * dt, t2)
        s3 = (1.0 / 3.0) * s + (2.0 / 3.0) * s2 + (2.0 / 3.0) * dt * st
        return s3, t3

    def _eager_tendencies(self, grid, consts, hy, immersed, positive, s, tr,
                          dt, rk):
        full_r = s[IDR] + hy[0][:, :, None, None]
        prim = _prim(s, tr, hy[0])
        SDx, TFx = self._direction(consts, hy, prim, _AX_X, grid.nx,
                                   consts.bc_x, IDU, grid.dx)
        SDz, TFz = self._direction(consts, hy, prim, _AX_Z, grid.nz,
                                   consts.bc_z, IDW, grid.dz)
        SDy = TFy = None
        if not grid.sim2d:
            SDy, TFy = self._direction(consts, hy, prim, _AX_Y, grid.ny,
                                       consts.bc_y, IDV, grid.dy)
        c0, c1, cdt, tr0, tr1 = rk
        t_new = self._fct(grid, tr, positive, TFx, TFy, TFz, dt,
                          (c0, c1, cdt, (None, tr0),
                           None if tr1 is None else (None, tr1)))
        s_tend = SDx + SDz
        if not grid.sim2d:
            s_tend = s_tend + SDy
        if consts.enable_gravity:
            s_tend[IDW] = s_tend[IDW] - consts.grav * full_r
        if consts.fcor != 0.0:
            s_tend[IDU] = s_tend[IDU] + consts.fcor * s[IDV]
            s_tend[IDV] = s_tend[IDV] - consts.fcor * s[IDU]
        if grid.sim2d:
            s_tend[IDV] = 0.0
        if consts.use_immersed:
            tau = 1.0e3 * dt
            fac = -min(1.0, dt / tau) / dt
            imm_tend = fac * s
            prop = immersed[None]
            s_tend = prop * imm_tend + (1.0 - prop) * s_tend
        return s_tend, t_new


STEP_CASES = {"supercell": ((16, 8, 10), None),
              "supercell_coriolis": ((16, 8, 10), 0.7),
              "thermal": ((24, 1, 12), None),
              "building": ((48, 16, 16), None),
              "city": ((64, 64, 12), None)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dycore_step_equals_eager_composition(case, dtype):
    """Two CFL sub-cycles of ``Dycore.time_step``: every field equal bit
    for bit to the eager composition's."""
    dims, lat = STEP_CASES[case]
    ps, pd = _state(case.split("_")[0], *dims, dtype=dtype, latitude=lat)
    assert (pd._consts(ps).fcor != 0.0) == (lat is not None)
    dt = 1.5 * pd.compute_time_step(ps)
    assert math.ceil(dt / pd.compute_time_step(ps)) == 2
    got = pd.time_step(ps, dt)
    want = _EagerDycore(ord=pd.ord).time_step(ps, dt)
    for name in want.fields:
        assert torch.equal(got[name], want[name]), name

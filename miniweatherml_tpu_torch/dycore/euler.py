"""Compressible-Euler WENO finite-volume dynamical core.

Port of ``miniweatherml_tpu/dycore/euler.py`` (reference
``Dynamics_Euler_Stratified_WenoFV``, model/modules/
dynamics_euler_stratified_wenofv.h): A-grid cell-centered FV, WENO-limited
reconstruction to cell edges, acoustic + advective upwind (Godunov) fluxes,
FCT positivity for tracers, SSP-RK3 with CFL sub-cycling, hydrostatic
background-state splitting, gravity, Coriolis, and immersed boundaries.

Each direction's reconstruction + Riemann solve + state divergence is one
call of ``ops/direction_fluxes.direction_fluxes`` (a CUDA kernel on the
card).  FCT and the tracer divergence go through ``ops/fct`` (two more CUDA
kernels on the card): the multiplier once per right-hand side, then one
scaled divergence per direction -- x, z, y -- accumulating into one tracer
buffer, the last of which also does the SSPRK3 tracer stage update and the
positivity clamp (as the JAX package's ``_fct_div_pallas``).  The state side
runs the same chain in the flux kernel (the Pallas kernel's ``acc`` and
``rk`` forms): x writes its divergence, z adds its own to it in place, and
the last direction (y; z in 2-D) adds its own, the gravity and Coriolis
sources, the 2-D v = 0 and the immersed blend, and writes the SSPRK3
stage's state.  The limiter runs in the algebra that ``riemann_impl``
names, as in the JAX package: "xla" (the default, and what "auto" resolves
to on every device) the reference algebra with exact weights, "pallas" the
Pallas kernels' reduced-operation algebra with, by default,
approximate-reciprocal weights in f32 (``fast_weights``); "pallas" with
``opt_algebra=False`` or a cutoff the Pallas kernels' reference algebra,
with the same weights.
The de-densitization that each right-hand side's directions share and the
conversions between the coupler's fields and the dycore's state go through
``ops/dycore_state`` (one CUDA kernel each on the card).

Under a mesh (``parallel/spmd.py``) each shard steps its local block with an
``SpmdCtx``: a split x or y direction takes its halo strips from the ring
neighbours (``parallel/halo.exchange_halo_strips``) into the flux kernel's
halo-strip form, whose face overwrites apply only on the shards that hold
the global boundary, and FCT takes the neighbours' boundary multipliers
(``exchange_face_scalar``) into ``fct_scale_div``.  z is never split.

State variable order matches the reference (dynamics...h:34-38):
idR, idU, idV, idW, idT = rho', rho*u, rho*v, rho*w, (rho*theta)'.
Tensor layout: (nvar, nens, nz, ny, nx).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

from ..core.coupler import CouplerState
from ..ops.direction_fluxes import (IDR, IDT, IDU, IDV, IDW, StageUpdate,
                                    direction_fluxes)
from ..ops.dycore_state import (coupler_to_dynamics, dedensitize,
                                dynamics_to_coupler)
from ..ops.fct import fct_mult, fct_scale_div
from ..ops.stencil import BC_WALL
from ..ops.weno import weno_matrices
from ..parallel.collectives import axis_index
from ..parallel.halo import exchange_face_scalar, exchange_halo_strips
from ..utils.profiling import span

__all__ = ["Dycore", "SpmdCtx", "IDR", "IDU", "IDV", "IDW", "IDT"]

# Field axes of the directions on (nvar, nens, nz, ny, nx).
_AX_X, _AX_Y, _AX_Z = -1, -2, -3

# Fixed max wave speed and CFL (reference dynamics...h:70-77).
_MAXWAVE = 350.0 + 80.0
_CFL = 0.6


def _thermo(state):
    """The conversions' thermodynamic keywords of ``state``
    (``ops/dycore_state.py``)."""
    o = state.options
    return dict(idWV=state.meta.idWV,
                adds_mass=[t.adds_mass for t in state.meta.tracers],
                R_d=o["R_d"], R_v=o["R_v"], gamma=o["gamma_d"], C0=o["C0"])


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """What one shard of a mesh run needs to step its local block.

    ``axes`` maps a field axis (-1 = x, -2 = y) to its (mesh axis name,
    shard count), for the split axes only.  Halo data then comes from the
    ring neighbours (``parallel/halo.py``, through the thread's current
    shard communicator), the counterpart of the reference's MPI halo and
    edge exchange (dynamics...h:574-1082)."""

    axes: Any  # Mapping[int, tuple[str, int]]

    def get(self, axis: int):
        return self.axes.get(axis) if self.axes else None


@dataclasses.dataclass(frozen=True)
class _Consts:
    """Physical constants of one run."""

    C0: float
    gamma: float
    grav: float
    fcor: float
    enable_gravity: bool
    use_immersed: bool
    bc_x: int
    bc_y: int
    bc_z: int


class Dycore:
    """Order-``ord`` WENO FV Euler dycore (ord in {3,5,7,9}; reference
    -DMW_ORD, dynamics...h:24-28)."""

    def __init__(self, ord: int = 5, cutoff: float = 0.0,
                 riemann_impl: str = "auto",
                 fast_weights: bool | None = None, opt_algebra: bool = True):
        if ord not in (3, 5, 7, 9):
            raise ValueError("ord must be 3, 5, 7 or 9")
        if riemann_impl == "auto":
            # The JAX package picks "pallas" on a single-device TPU; here the
            # numerics are never the device's choice, so "auto" is the
            # reference algebra everywhere and the Pallas kernels' algebra
            # is asked for by name.
            riemann_impl = "xla"
        if riemann_impl not in ("xla", "pallas"):
            raise ValueError("riemann_impl must be 'xla', 'pallas' or "
                             "'auto'")
        if fast_weights is None:
            fast_weights = riemann_impl == "pallas"
        self.ord = ord
        self.cutoff = cutoff
        # "xla": the JAX XLA path's limiter (reference algebra, exact
        # weights); "pallas": the Pallas kernels' reduced-operation algebra
        # (ops/weno_fused.py::reconstruct_edges_opt) at cutoff 0
        self.riemann_impl = riemann_impl
        # fast_weights: approximate-reciprocal weight normalisation (f32 on
        # the card; the plain version and f64 are exact).  Only affects
        # riemann_impl="pallas".
        self.fast_weights = fast_weights
        # opt_algebra: the reduced-operation algebra under "pallas"; False
        # (or a cutoff) runs the Pallas kernels' reference-ordered algebra
        # (ops/weno_fused.py::reconstruct_edges_recip, with fast_weights
        # csrc/direction_fluxes_ref_fast.cu).  Only affects
        # riemann_impl="pallas".
        self.opt_algebra = opt_algebra
        self.mats = weno_matrices(ord)

    def limiter_form(self) -> dict:
        """The flux kernel's limiter keywords (``opt``, ``fast_weights``)
        of this dycore's ``riemann_impl`` and ``opt_algebra``."""
        pallas = self.riemann_impl == "pallas"
        return {"opt": pallas and self.opt_algebra,
                "fast_weights": pallas and self.fast_weights}

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def init(self, state: CouplerState) -> CouplerState:
        """Register coupler fields, set constant options with defaults, build
        hydrostatic profiles and the test-case initial condition
        (reference dynamics...h:1197-1683)."""
        from . import init_cases

        # Physical-constant defaults (reference dynamics...h:1227-1248).
        state = state.setdefault_options(
            R_d=287.0, cp_d=1003.0, R_v=461.0, cp_v=1859.0,
            p0=1.0e5, grav=9.81, earthrot=7.292115e-5,
        )
        o = state.options
        cp_d, R_d = o["cp_d"], o["R_d"]
        state = state.setdefault_options(cv_d=cp_d - R_d)
        cv_d = state.options["cv_d"]
        state = state.setdefault_options(
            gamma_d=cp_d / cv_d, kappa_d=R_d / cp_d, cv_v=o["R_v"] - o["cp_v"])
        kappa = state.options["kappa_d"]
        gamma = state.options["gamma_d"]
        state = state.setdefault_options(
            C0=(R_d * o["p0"] ** (-kappa)) ** gamma, latitude=0.0)
        state = state.setdefault_options(
            enable_gravity=True, use_immersed_boundaries=False, out_freq=-1.0)

        if state.meta.idWV < 0:
            raise ValueError(
                "dycore requires a 'water_vapor' tracer to be registered "
                "before init (reference dynamics...h:1292)")

        # Coupler prognostic fields (reference dynamics...h:1253-1257).
        for name in ("density_dry", "uvel", "vvel", "wvel", "temp",
                     "immersed_proportion"):
            if name not in state:
                state = state.register_field(name)

        # Test case dispatch (reference dynamics...h:1306-1310).
        init_data = state.get_option("init_data", "supercell")
        case = {
            "thermal": init_cases.init_thermal,
            "supercell": partial(init_cases.init_supercell, ord=self.ord),
            "city": init_cases.init_city,
            "building": init_cases.init_building,
        }.get(init_data)
        if case is None:
            raise ValueError(f"invalid init_data {init_data!r}")
        state, s_dyn, tr_dyn = case(state)

        return state.replace_fields(
            **self._dyn_to_coupler_fields(state, s_dyn, tr_dyn))

    # ------------------------------------------------------------------
    # public stepping API
    # ------------------------------------------------------------------
    def compute_time_step(self, state: CouplerState) -> float:
        """Max stable dt from fixed max wave speed (dynamics...h:70-77)."""
        g = state.grid
        return _CFL * min(g.dx, g.dy, g.dz) / _MAXWAVE

    def time_step(self, state: CouplerState, dt_phys: float,
                  spmd: SpmdCtx | None = None) -> CouplerState:
        """One physics step: CFL sub-cycled SSPRK3 (dynamics...h:81-181).
        ``spmd``: run as one shard of a mesh (``state`` holds the shard's
        local block and local grid; ``parallel/spmd.py``)."""
        with span("dycore.step"):
            dt_dyn = self.compute_time_step(state)
            ncycles = max(1, int(math.ceil(dt_phys / dt_dyn - 1e-12)))
            dt = dt_phys / ncycles

            with span("dycore.to_dynamics"):
                s, tr = self.convert_coupler_to_dynamics(state)
            consts = self._consts(state)
            hy = self._hy(state)
            immersed = state["immersed_proportion"]
            positive = [t.positive for t in state.meta.tracers]

            for _ in range(ncycles):
                s, tr = self._ssprk3(state.grid, consts, hy, immersed,
                                     positive, s, tr, dt, spmd)

            with span("dycore.to_coupler"):
                return state.replace_fields(
                    **self._dyn_to_coupler_fields(state, s, tr))

    # ------------------------------------------------------------------
    # conversions (reference dynamics...h:1891-2015)
    # ------------------------------------------------------------------
    def convert_coupler_to_dynamics(self, state: CouplerState):
        return coupler_to_dynamics(
            state["density_dry"], state["uvel"], state["vvel"],
            state["wvel"], state["temp"],
            [state[n] for n in state.meta.tracer_names],
            state["hy_dens_cells"], state["hy_dens_theta_cells"],
            **_thermo(state))

    def _dyn_to_coupler_fields(self, state: CouplerState, s, tr):
        rho_d, u, v, w, temp = dynamics_to_coupler(
            s, tr, state["hy_dens_cells"], state["hy_dens_theta_cells"],
            **_thermo(state))
        out = dict(density_dry=rho_d, uvel=u, vvel=v, wvel=w, temp=temp)
        out.update({n: tr[i] for i, n in enumerate(state.meta.tracer_names)})
        return out

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _consts(self, state: CouplerState) -> _Consts:
        o = state.options
        return _Consts(
            C0=o["C0"], gamma=o["gamma_d"],
            grav=o["grav"],
            fcor=2.0 * o["earthrot"] * math.sin(o.get("latitude", 0.0)),
            enable_gravity=bool(o.get("enable_gravity", True)),
            use_immersed=bool(o.get("use_immersed_boundaries", False)),
            bc_x=int(o["bc_x"]), bc_y=int(o["bc_y"]), bc_z=int(o["bc_z"]),
        )

    def _hy(self, state: CouplerState):
        return (state["hy_dens_cells"], state["hy_dens_theta_cells"],
                state["hy_dens_edges"], state["hy_dens_theta_edges"])

    def _ssprk3(self, grid, consts, hy, immersed, positive, s, tr, dt,
                spmd=None):
        """Three-stage SSPRK3 with per-stage tracer positivity clamp
        (reference dynamics...h:110-175; FCT dt per stage 1, 1/4, 2/3).  The
        stage update runs in the last direction's kernels -- the state's in
        the flux kernel, the tracers' in the last FCT pass --, which hand
        back the stage's state and tracers: stage k is c0 * base0 + c1 *
        base1 + cdt * tendency with base0 the step's (s, tr) and base1 the
        previous stage's (None in stage 1)."""
        def stage(s_, tr_, dt_, c0, c1, cdt, base1):
            return self._tendencies(grid, consts, hy, immersed, positive,
                                    s_, tr_, dt_, (c0, c1, cdt, (s, tr),
                                                   base1), spmd)

        s1, t1 = stage(s, tr, dt, 1.0, 0.0, dt, None)
        s2, t2 = stage(s1, t1, dt / 4.0, 0.75, 0.25, 0.25 * dt, (s1, t1))
        return stage(s2, t2, 2.0 * dt / 3.0, 1.0 / 3.0, 2.0 / 3.0,
                     (2.0 / 3.0) * dt, (s2, t2))

    def _direction(self, consts, hy, prim, axis, n, bc, normal_id, d,
                   spmd=None, acc=None, rk=None):
        """State divergence (added into ``acc``; the stage's state with
        ``rk``) and tracer faces of one direction; on an axis split over the
        mesh, in the flux kernel's halo-strip form."""
        hyc, hyt, hye, hyte = hy
        hy_r, hy_t = (hye, hyte) if axis == _AX_Z else (hyc, hyt)
        strips = None
        mesh_ax = spmd.get(axis) if spmd is not None else None
        if mesh_ax is not None:
            name, ns = mesh_ax
            hp = (self.ord - 1) // 2 + 1
            zv = normal_id if bc == BC_WALL else None
            lo, hi = exchange_halo_strips(prim, axis, hp, name, ns, bc,
                                          zero_var=zv)
            idx = axis_index(name)
            # the face overwrites only at the global boundary
            strips = (lo, hi, bc if idx == 0 else 0,
                      bc if idx == ns - 1 else 0)
        return direction_fluxes(prim, axis, n, bc, normal_id, consts.C0,
                                consts.gamma, hy_r, hy_t, self.mats,
                                self.cutoff, 1.0 / d, strips, acc, rk,
                                **self.limiter_form())

    def _fct(self, grid, tr, positive, Fx, Fy, Fz, dt, rk, spmd=None):
        """Flux-corrected transport and the tracer divergence
        (dynamics...h:498-516), followed by the tracer stage update: the
        multiplier once, then the scaled divergence of x (first), z and y
        (accumulating into one buffer), the last with the ``rk`` epilogue.
        On periodic axes the seam faces 0 and n are two copies scaled
        independently, as in the reference.  On an axis split over the
        mesh, the faces beyond the shard take the neighbours' boundary
        multipliers (1 at the global boundary)."""
        mult = fct_mult(tr, positive, Fx, Fy, Fz, dt, grid.dx, grid.dy,
                        grid.dz)
        c0, c1, cdt, (_, tr0), base1 = rk
        rk = (c0, c1, cdt, tr0, None if base1 is None else base1[1],
              positive)

        def edges(axis):
            mesh_ax = spmd.get(axis) if spmd is not None else None
            if mesh_ax is None:
                return None
            return exchange_face_scalar(mult, axis, *mesh_ax)
        t = fct_scale_div(Fx, mult, None, _AX_X, grid.nx, 1.0 / grid.dx,
                          edges=edges(_AX_X))
        t = fct_scale_div(Fz, mult, t, _AX_Z, grid.nz, 1.0 / grid.dz,
                          rk=rk if Fy is None else None)
        if Fy is not None:
            t = fct_scale_div(Fy, mult, t, _AX_Y, grid.ny, 1.0 / grid.dy,
                              rk=rk, edges=edges(_AX_Y))
        return t

    def _tendencies(self, grid, consts, hy, immersed, positive, s, tr, dt,
                    rk, spmd=None):
        """One semi-discrete RHS evaluation (dynamics...h:204-552) and the
        SSPRK3 stage update of its ``rk`` = (c0, c1, cdt, (s0, tr0), (s1,
        tr1) | None).  Returns the stage's state and tracers."""
        c0, c1, cdt, (s0, _), base1 = rk
        sim2d = grid.sim2d
        # De-densitized variables (dynamics...h:248-255): rho', u, v, w,
        # (rho theta)', tracer concentrations -- shared by all directions.
        with span("dycore.prim"):
            prim = dedensitize(s, tr, hy[0])

        # Gravity, Coriolis and the immersed-boundary blend
        # (dynamics...h:524-550) and the stage update ride the last
        # direction's kernel.
        stage = StageUpdate(
            c0, c1, cdt, s0, None if base1 is None else base1[0], hy[0],
            consts.grav if consts.enable_gravity else None, consts.fcor,
            immersed if consts.use_immersed else None, dt, sim2d)
        acc, TFx = self._direction(consts, hy, prim, _AX_X, grid.nx,
                                   consts.bc_x, IDU, grid.dx, spmd)
        s_new, TFz = self._direction(consts, hy, prim, _AX_Z, grid.nz,
                                     consts.bc_z, IDW, grid.dz, acc=acc,
                                     rk=stage if sim2d else None)
        TFy = None
        if not sim2d:
            s_new, TFy = self._direction(consts, hy, prim, _AX_Y, grid.ny,
                                         consts.bc_y, IDV, grid.dy, spmd,
                                         acc=acc, rk=stage)
        del prim

        t_new = self._fct(grid, tr, positive, TFx, TFy, TFz, dt, rk, spmd)
        return s_new, t_new

"""Kessler warm-rain microphysics (KW 1978).

Port of ``miniweatherml_tpu/physics/kessler.py`` (reference
model/modules/microphysics_kessler.h): autoconversion + accretion,
saturation adjustment, rain evaporation, and rain sedimentation with internal
CFL sub-cycling.  The sub-cycle count is a global min reduction that stays on
the device: ``MicrophysicsKessler`` takes the largest stable step from
``kessler_cuda.min_step`` (one reduction kernel on the card) and hands the
count with the coupler's fields to ``kessler_cuda.kessler_step``, which runs
the whole step (prep, passes, post) in one kernel, without a host sync.
``kessler_column`` is the whole scheme in plain PyTorch on any z spacing,
the counterpart of the JAX function of that name.
"""

from __future__ import annotations

import torch

from ..core.coupler import CouplerState
from ..ops.exact_div import exact_div
from ..parallel.collectives import pmin
from ..utils.profiling import count_device, span
from .kessler_cuda import (column_constants, kessler_pass, kessler_step,
                           min_step, step_plain)

__all__ = ["MicrophysicsKessler", "kessler_column", "kessler_rainsplit"]


class MicrophysicsKessler:
    """Registers water_vapor / cloud_liquid / precip_liquid tracers and the
    ``precl`` precipitation-rate field (reference microphysics_kessler.h:51-95)."""

    # physical constants (reference microphysics_kessler.h:30-41)
    R_d, cp_d = 287.0, 1003.0
    R_v, cp_v = 461.0, 1859.0
    p0, grav = 1.0e5, 9.81

    num_tracers = 3

    # the JAX package's kernel choice (xla, pallas or auto), a class default
    # that subclasses with their own __init__ inherit; every value runs the
    # one kernel here, whose arithmetic all of them share
    impl = "auto"

    def __init__(self, impl: str = "auto"):
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError("impl must be 'auto', 'xla' or 'pallas'")
        self.impl = impl

    def init(self, state: CouplerState) -> CouplerState:
        g = state.grid
        state = state.add_tracer("water_vapor", "Water Vapor", True, True)
        state = state.add_tracer("cloud_liquid", "Cloud liquid", True, True)
        state = state.add_tracer("precip_liquid", "precip_liquid", True, True)
        state = state.register_field("precl", shape=(g.nens, g.ny, g.nx))
        cv_d = self.cp_d - self.R_d
        return state.set_options(
            micro="kessler",
            R_d=self.R_d, cp_d=self.cp_d, cv_d=cv_d,
            gamma_d=self.cp_d / cv_d, kappa_d=self.R_d / self.cp_d,
            R_v=self.R_v, cp_v=self.cp_v, cv_v=self.R_v - self.cp_v,
            p0=self.p0, grav=self.grav,
        )

    def time_step(self, state: CouplerState, dt: float,
                  spmd_axes: tuple = ()) -> CouplerState:
        """(reference microphysics_kessler.h:99-162).  ``spmd_axes``: the
        mesh axes to take the sub-cycle count's minimum step over, in a
        shard of a mesh run (the MPI_Allreduce analog)."""
        g = state.grid
        # The kernel sediments with a scalar dz (reference kessler.h:296-299
        # uses z(k+1)-z(k)); a stretched vertical coordinate must not reach
        # it.
        if not isinstance(g.dz, float):
            raise ValueError("Kessler sub-cycling needs a uniform vertical "
                             "grid (scalar Grid.dz)")
        with span("kessler.step"):
            rho_d = state["density_dry"]
            rainsplit = _count(dt, pmin(min_step(state["precip_liquid"],
                                                 rho_d, dt, g.dz), spmd_axes))
            count_device("kessler.subcycles", rainsplit)
            rho_v, rho_c, rho_r, temp, precl = kessler_step(
                rho_d, state["temp"], state["water_vapor"],
                state["cloud_liquid"], state["precip_liquid"], rainsplit, dt,
                g.dz, self.R_d, self.R_v, self.cp_d, self.p0)
            return state.replace_fields(water_vapor=rho_v, cloud_liquid=rho_c,
                                        precip_liquid=rho_r, temp=temp,
                                        precl=precl)


def kessler_rainsplit(qr, rho, z, dt, z_axis: int = 1,
                      spmd_axes: tuple = ()):
    """The sedimentation sub-cycle count as a 0-d int32 tensor on the
    fields' device (reference microphysics_kessler.h:262-280): the max
    stable sub-step is the min over cells below the top of 0.8 dz / velqr,
    and rainsplit = ceil(dt / max).  ``spmd_axes``: mesh axes to ``pmin``
    the step over (on the device, no host read), as the JAX function does:
    the horizontal axes only, so each ensemble shard keeps its own count."""
    return _count(dt, pmin(step_plain(qr, rho, z, dt, z_axis), spmd_axes))


def _count(dt, dt_max):
    """ceil(dt / dt_max) as a 0-d int32 tensor on dt_max's device."""
    return torch.ceil(dt / dt_max).to(torch.int32)


def kessler_column(theta, qv, qc, qr, rho, z, pk, dt, Rd, cp, p0,
                   z_axis: int = 0):
    """The Kessler scheme itself (reference microphysics_kessler.h:234-339,
    after Klemp & Wilhelmson 1978 via Ullrich's kessler.f90 v2).

    All tensors share a shape with the vertical on ``z_axis``; every other
    axis is an independent column.  Returns updated (theta, qv, qc, qr) and
    ``precl`` (precipitation rate, m/s; shape without the z axis).
    """
    nz = theta.shape[z_axis]
    rainsplit = kessler_rainsplit(qr, rho, z, dt, z_axis)
    dt0 = exact_div(dt, rainsplit.to(theta.dtype))
    r, rhalf, pc = column_constants(rho, pk, Rd, cp, p0, z_axis)
    dz_lev = z.narrow(z_axis, 1, nz - 1) - z.narrow(z_axis, 0, nz - 1)
    dz_top = z.narrow(z_axis, nz - 1, 1) - z.narrow(z_axis, nz - 2, 1)
    precl = torch.zeros_like(theta.narrow(z_axis, 0, 1))
    for _ in range(int(rainsplit)):
        theta, qv, qc, qr, precl = kessler_pass(
            theta, qv, qc, qr, precl, rho, r, rhalf, pk, pc, dz_lev, dz_top,
            dt0, cp, z_axis)
    precl = precl / rainsplit.to(theta.dtype)
    return theta, qv, qc, qr, precl.squeeze(z_axis)

"""Running time-average of the coupler prognostic fields.

Port of ``miniweatherml_tpu/physics/time_averager.py`` (reference
``Time_Averager``, experiments/simple_city/custom_modules/time_averager.h):
inertia-weighted running mean ``avg <- inertia*avg + (1-inertia)*field``
with ``inertia = etime/(etime+dt)`` (time_averager.h:60-70); ``finalize``
writes ``time_averaged_fields.nc`` with (z, y, x) dims (time_averager.h:
75-141).  The averages and the elapsed time ride in the coupler state
(fields ``time_avg_*`` and the 0-d ``time_avg_etime``, kept on the device so
that ``accumulate`` never waits for it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.coupler import CouplerState

__all__ = ["TimeAverager"]

_FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor")


class TimeAverager:
    def init(self, state: CouplerState) -> CouplerState:
        for name in _FIELDS:
            state = state.register_field("time_avg_" + name)
        return state.register_field(
            "time_avg_etime",
            value=torch.zeros((), dtype=state.meta.tdtype,
                              device=state.device))

    def accumulate(self, state: CouplerState, dt: float) -> CouplerState:
        etime = state["time_avg_etime"]
        inertia = etime / (etime + dt)
        updates = {
            "time_avg_" + n: inertia * state["time_avg_" + n]
            + (1.0 - inertia) * state[n]
            for n in _FIELDS
        }
        updates["time_avg_etime"] = etime + dt
        return state.replace_fields(**updates)

    def finalize(self, state: CouplerState,
                 path: str = "time_averaged_fields.nc") -> str:
        """Write the averaged fields (ensemble member 0) to NetCDF
        (time_averager.h:75-141), or to ``.npz`` where scipy is missing;
        returns the path written."""
        g = state.grid
        data = {n: state["time_avg_" + n][0].detach().cpu().numpy().astype(
            np.float64) for n in _FIELDS}
        coords = {
            "x": (np.arange(g.nx) + 0.5) * g.dx,
            "y": (np.arange(g.ny) + 0.5) * g.dy,
            "z": (np.arange(g.nz) + 0.5) * g.dz,
        }
        try:
            from scipy.io import netcdf_file
        except ImportError:  # pragma: no cover
            path = path.rsplit(".", 1)[0] + ".npz"
            np.savez(path, **coords, **data)
            return path
        nc = netcdf_file(path, "w")
        for dim in ("x", "y", "z"):
            nc.createDimension(dim, len(coords[dim]))
            v = nc.createVariable(dim, "d", (dim,))
            v[:] = coords[dim]
        for name in _FIELDS:
            v = nc.createVariable(name, "d", ("z", "y", "x"))
            v[:] = data[name]
        nc.close()
        return path

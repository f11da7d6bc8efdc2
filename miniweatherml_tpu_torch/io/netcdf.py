"""NetCDF output with the reference's file schema.

Port of ``miniweatherml_tpu/io/netcdf.py::StateWriter``: dims (t, z, y, x),
coordinate variables x/y/z/t, and one variable per coupler state field and
tracer (dynamics_euler_stratified_wenofv.h:2019-2191), written with scipy's
NetCDF3 writer.  Fields are copied from the device at each snapshot.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..core.coupler import CouplerState

__all__ = ["StateWriter"]

_STATE_VARS = ("density_dry", "uvel", "vvel", "wvel", "temp")


class StateWriter:
    """Snapshot writer mirroring the reference output() variable layout.
    Writes ensemble member ``iens`` (0, like the reference, dynamics...h:2034)."""

    def __init__(self, path_prefix: str, state: CouplerState, iens: int = 0,
                 extra_vars: tuple = ()):
        """``extra_vars``: further registered (nens, nz, ny, nx) fields to
        write beyond the reference's state + tracer layout, e.g. the P3
        diagnostic fields."""
        self.iens = iens
        self.varnames = (list(_STATE_VARS) + list(state.meta.tracer_names)
                         + list(extra_vars))
        g = state.grid
        self.path = (path_prefix if path_prefix.endswith(".nc")
                     else path_prefix + ".nc")
        nc = netcdf_file(self.path, "w")
        nc.createDimension("t", None)  # scipy requires the unlimited dim first
        nc.createDimension("x", g.nx)
        nc.createDimension("y", g.ny)
        nc.createDimension("z", g.nz)
        for dim, n, d in (("x", g.nx, g.dx), ("y", g.ny, g.dy),
                          ("z", g.nz, g.dz)):
            v = nc.createVariable(dim, "d", (dim,))
            v[:] = (np.arange(n) + 0.5) * d
        self._tvar = nc.createVariable("t", "d", ("t",))
        self._vars = {name: nc.createVariable(name, "d", ("t", "z", "y", "x"))
                      for name in self.varnames}
        self._nc = nc
        self._n = 0

    def write(self, state: CouplerState, etime: float) -> None:
        i = self._n
        self._tvar[i] = etime
        for name in self.varnames:
            self._vars[name][i] = (
                state[name][self.iens].detach().cpu().numpy().astype(np.float64))
        self._nc.flush()
        self._n += 1

    def close(self) -> None:
        self._nc.close()

"""NetCDF output with the reference's file schema.

Port of ``miniweatherml_tpu/io/netcdf.py``: ``StateWriter`` writes dims
(t, z, y, x), coordinate variables x/y/z/t, and one variable per coupler
state field and tracer (dynamics_euler_stratified_wenofv.h:2019-2191) with
scipy's NetCDF3 writer; ``ShardedStateWriter`` writes one such file per
shard (the reference's ``file_per_process``), which ``io/stitch.py`` merges.
Fields are copied from the device at each snapshot.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..core.coupler import CouplerState
from ..parallel.mesh import ShardedState

__all__ = ["StateWriter", "ShardedStateWriter"]

_STATE_VARS = ("density_dry", "uvel", "vvel", "wvel", "temp")


class StateWriter:
    """Snapshot writer mirroring the reference output() variable layout.
    Writes ensemble member ``iens`` (0, like the reference, dynamics...h:2034)."""

    def __init__(self, path_prefix: str, state: CouplerState, iens: int = 0,
                 offsets: tuple | None = None, extra_vars: tuple = ()):
        """``offsets`` = (i_beg, j_beg, dx, dy): a shard's global index
        offsets and the global cell widths; the x/y coordinates are then
        written in global coordinates and the offsets kept as the file's
        ``i_beg`` / ``j_beg`` attributes, so shard files stitch offline.
        ``extra_vars``: further registered (nens, nz, ny, nx) fields to
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
        i_beg, j_beg, dx, dy = 0, 0, g.dx, g.dy
        if offsets is not None:
            i_beg, j_beg, dx, dy = offsets
            nc.i_beg = i_beg
            nc.j_beg = j_beg
        for dim, n, d, beg in (("x", g.nx, dx, i_beg), ("y", g.ny, dy, j_beg),
                               ("z", g.nz, g.dz, 0)):
            v = nc.createVariable(dim, "d", (dim,))
            v[:] = (np.arange(n) + beg + 0.5) * d
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


class ShardedStateWriter:
    """Per-shard snapshot writer: one ``<prefix>_task_<rank>.nc`` per shard
    of a ``ShardedState`` (rank order: ``Mesh.coords``), or one
    ``<prefix>_task_0.nc`` for a plain ``CouplerState``, as the JAX
    package's writer does on one device -- the reference's
    ``file_per_process`` per-rank output (dynamics...h:2027-2120).  Each
    file carries its shard's global offsets, so ``io/stitch.py`` can merge
    the files into the one global file."""

    def __init__(self, path_prefix: str, state, iens: int = 0):
        self.prefix = path_prefix
        self.iens = iens
        self._writers: list[StateWriter] = []

    @staticmethod
    def _shards(state):
        """(local state, i_beg, j_beg) of each shard, and the global grid."""
        if isinstance(state, ShardedState):
            mesh, out = state.mesh, []
            for rank, shard in enumerate(state.shards):
                c, g = mesh.coords(rank), shard.grid
                out.append((shard, c["x"] * g.nx, c["y"] * g.ny))
            return out, state.grid
        return [(state, 0, 0)], state.grid

    def write(self, state, etime: float) -> None:
        shards, g = self._shards(state)
        if not self._writers:
            self._writers = [
                StateWriter(f"{self.prefix}_task_{rank}", shard,
                            iens=self.iens, offsets=(i, j, g.dx, g.dy))
                for rank, (shard, i, j) in enumerate(shards)]
        for w, (shard, _, _) in zip(self._writers, shards):
            w.write(shard, etime)

    def close(self) -> None:
        for w in self._writers:
            w.close()

"""Plain PyTorch reference of the P3 module's step.

This follows ``MicrophysicsP3.time_step`` (model/modules/microphysics_p3.h:
96-444) with the scheme of ``p3_scheme.py``, a translation of the JAX
package's P3 (see its header): the wrapper's inputs with the saturation
adjustment, the scheme at the table tier, then the output pass.  The
scheme runs over slabs of rows so its temporaries fit at the full grid.
The sedimentation's sub-step count takes the fastest fall speed of the
whole grid: each slab first runs with its own, and a slab whose count
differs from the grid's runs again with the grid's.  The lookup table is
the data file the configuration names, parsed by ``p3_tables.py``.
"""

from __future__ import annotations

import math
import os

import torch

from . import p3_scheme as S
from . import p3_tables as T

# (name, positive, adds_mass), in the order the module registers them
TRACERS = (("cloud_water", True, True), ("cloud_water_num", True, False),
           ("rain", True, True), ("rain_num", True, False),
           ("ice", True, True), ("ice_num", True, False),
           ("ice_rime", True, False), ("ice_rime_vol", True, False),
           ("water_vapor", True, True))
FIELDS = {"qv_prev": "cells", "t_prev": "cells", "precl": "surface",
          "precl_ice": "surface"}
R_D, CP_D, R_V, P0 = S.R_D, S.CP_D, S.R_V, S.P0
GRAV = 9.80616
SLAB_CELLS = 1 << 24


class Micro:
    """The P3 module's step on a dict of coupler fields.  With ``counts``
    set to a list, each step appends its gate counts (a dict,
    ``p3_scheme``) to it."""

    name = "p3"

    def __init__(self, cfg: dict, root: str, dtype, device):
        self.tab = T.load_tables(os.path.join(root, cfg["p3_table"])).to(
            device, dtype)
        self.counts = None

    def _slab(self, f, ys, grid, dt, vmax, counts):
        names = [t[0] for t in TRACERS]
        sl = (slice(None), slice(None), ys)
        rho_d = f["density_dry"][sl]
        out = S.wrapper_inputs(rho_d, f["temp"][sl],
                               *(f[n][sl] for n in names),
                               f["qv_prev"][sl], f["t_prev"][sl])
        exner = out[10]
        res = S.p3_scheme(*out[:12], rho_d, grid.dz, dt, self.tab,
                          qv_prev=out[12], t_prev=out[13], vmax=vmax,
                          counts=counts)
        upd = {n: (q * rho_d).clamp(min=0.0) for n, q in zip(names, res[:9])}
        temp = res[9] * exner
        upd.update(temp=temp, qv_prev=res[8].clamp(min=0.0), t_prev=temp,
                   precl=res[10], precl_ice=res[11])
        return upd, res[12]

    def time_step(self, f: dict, dt: float, grid) -> dict:
        ny = grid.ny
        rows = max(1, SLAB_CELLS // (grid.nens * grid.nz * grid.nx))
        slabs = [slice(a, min(ny, a + rows)) for a in range(0, ny, rows)]
        names = [t[0] for t in TRACERS]
        new = {k: torch.empty_like(f[k]) for k in
               names + ["temp", "qv_prev", "t_prev", "precl", "precl_ice"]}

        def put(ys, upd):
            for k, v in upd.items():
                if v.dim() == 4:
                    new[k][:, :, ys] = v
                else:
                    new[k][:, ys] = v

        def nsub(v):
            return max(1, math.ceil(dt * float(v) / (0.9 * grid.dz)))

        counts = {} if self.counts is not None else None
        seen = []
        for ys in slabs:
            upd, v = self._slab(f, ys, grid, dt, None, counts)
            put(ys, upd)
            seen.append(float(v))
        vmax = max(seen)
        for ys, v in zip(slabs, seen):
            if nsub(v) != nsub(vmax):
                put(ys, self._slab(f, ys, grid, dt, vmax, None)[0])
        if counts is not None:
            counts["sed_substeps"] = nsub(vmax)
            self.counts.append(counts)
        out = dict(f)
        out.update(new)
        return out

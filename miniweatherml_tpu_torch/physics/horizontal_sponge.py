"""Lateral (horizontal) inflow/outflow sponge.

Port of ``miniweatherml_tpu/physics/horizontal_sponge.py`` (reference
``Horizontal_Sponge``, experiments/simple_city/custom_modules/
horizontal_sponge.h): stores one reference column of {density_dry, uvel,
vvel, wvel, temp, water_vapor} at init -- the global (j=0, i=0) column --
then each step relaxes a cosine-weighted band of ``sponge_cells`` cells at
the selected x/y walls toward that column (horizontal_sponge.h:100-193).
The stored column rides in the coupler state as the field
``horiz_sponge_column``, shaped (6, nens, nz).  Under a mesh
(``apply(spmd=...)``) the wall bands use global cell indices.
"""

from __future__ import annotations

import math

import torch

from ..core.coupler import CouplerState
from ..parallel.collectives import axis_index

__all__ = ["HorizontalSponge"]

_FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor")


class HorizontalSponge:
    """Relax lateral boundary bands toward a fixed reference column."""

    def __init__(self, sponge_cells: int = 10, time_scale: float = 1.0):
        self.sponge_cells = sponge_cells
        self.time_scale = time_scale

    def init(self, state: CouplerState) -> CouplerState:
        """Capture the global (j=0, i=0) column (horizontal_sponge.h:54-68)."""
        col = torch.stack([state[n][:, :, 0, 0] for n in _FIELDS])
        if "horiz_sponge_column" in state.fields:
            return state.replace_fields(horiz_sponge_column=col)
        return state.register_field("horiz_sponge_column", value=col)

    def override(self, state: CouplerState, **values: float) -> CouplerState:
        """Set a stored column to a constant (reference override_* methods)."""
        col = state["horiz_sponge_column"].clone()
        for name, val in values.items():
            col[_FIELDS.index(name)] = val
        return state.replace_fields(horiz_sponge_column=col)

    def apply(self, state: CouplerState, dt: float,
              x1: bool = True, x2: bool = True,
              y1: bool = True, y2: bool = True,
              spmd=None) -> CouplerState:
        """Cosine-in-space, dt/time_scale-in-time blend toward the column at
        the selected walls (horizontal_sponge.h:100-193).  ``spmd``
        (``dycore.euler.SpmdCtx``) makes the wall bands use global cell
        indices in a shard of a mesh run (the reference computes the band
        from each rank's global offsets)."""
        g = state.grid
        dtype, device = state.meta.tdtype, state.device
        n_sp = self.sponge_cells
        time_factor = dt / self.time_scale
        col = state["horiz_sponge_column"]  # (6, nens, nz)

        def wall_weight(idx):
            # weight(i) = (cos(pi * i/(n_sp-1)) + 1)/2 for i < n_sp, else 0
            loc = idx.to(dtype) / (n_sp - 1.0)
            w = torch.where(idx < n_sp, (torch.cos(math.pi * loc) + 1.0) / 2.0,
                            0.0)
            return w * time_factor

        ix = torch.arange(g.nx, device=device)
        jy = torch.arange(g.ny, device=device)
        gnx, gny = g.nx, g.ny
        if spmd is not None:
            ax = spmd.get(-1)
            if ax is not None:
                name, ns = ax
                ix = axis_index(name) * g.nx + ix
                gnx = g.nx * ns
            ay = spmd.get(-2)
            if ay is not None:
                name, ns = ay
                jy = axis_index(name) * g.ny + jy
                gny = g.ny * ns
        # The reference blends one wall after another (x1 -> x2 -> y1 -> y2,
        # horizontal_sponge.h:137-193); every pass is a linear blend toward
        # the same column c, f' = w*c + (1-w)*f, so the sequence collapses to
        #   f_final = (1 - prod_k (1-w_k))*c + prod_k (1-w_k)*f,
        # independent of the wall order.
        one_minus = torch.ones((g.ny, g.nx), dtype=dtype, device=device)
        if x1:
            one_minus = one_minus * (1.0 - wall_weight(ix))[None, :]
        if x2:
            one_minus = one_minus * (1.0 - wall_weight(gnx - 1 - ix))[None, :]
        if y1:
            one_minus = one_minus * (1.0 - wall_weight(jy))[:, None]
        if y2:
            one_minus = one_minus * (1.0 - wall_weight(gny - 1 - jy))[:, None]
        w = (1.0 - one_minus)[None, None, :, :]  # (1, 1, ny, nx)

        updates = {}
        for l, name in enumerate(_FIELDS):
            c = col[l][:, :, None, None]  # (nens, nz, 1, 1)
            updates[name] = w * c + (1.0 - w) * state[name]
        return state.replace_fields(**updates)

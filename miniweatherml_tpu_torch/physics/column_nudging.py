"""Column nudging (reference model/modules/column_nudging.h).

Port of ``miniweatherml_tpu/physics/column_nudging.py``: stores the initial
horizontal-mean column of {density_dry, uvel, vvel, temp, water_vapor} and
nudges the state toward it with a 900 s time scale each step.
"""

from __future__ import annotations

import torch

from ..core.coupler import CouplerState
from ..parallel.collectives import pmean
from ..utils.profiling import span

__all__ = ["ColumnNudger"]

_FIELDS = ("density_dry", "uvel", "vvel", "temp", "water_vapor")
_TIME_SCALE = 900.0  # (column_nudging.h:61)


class ColumnNudger:
    """The stored column rides in the coupler state as the field
    ``nudging_column`` of shape (num_fields, nens, nz)."""

    def set_column(self, state: CouplerState) -> CouplerState:
        col = torch.stack([torch.mean(state[n], dim=(2, 3)) for n in _FIELDS])
        if "nudging_column" in state.fields:
            return state.replace_fields(nudging_column=col)
        return state.register_field("nudging_column", value=col)

    def nudge_to_column(self, state: CouplerState, dt: float,
                        spmd_axes: tuple = ()) -> CouplerState:
        """``spmd_axes``: horizontal mesh axis names to ``pmean`` the column
        average over, in a shard of a mesh run (the MPI_Allreduce analog,
        column_nudging.h:89-99).  Like the reference (column_nudging.h:61-65),
        the water-vapor nudge is not positivity-clamped; transient negatives
        in dry cells are re-clamped by the dycore's per-stage FCT clamp on
        the next step."""
        with span("nudge.step"):
            column = state["nudging_column"]
            avgs = pmean(torch.stack([
                torch.mean(state[n], dim=(2, 3), keepdim=True)
                for n in _FIELDS]), spmd_axes)
            updates = {}
            for l, name in enumerate(_FIELDS):
                f = state[name]
                updates[name] = f + dt * (column[l][:, :, None, None]
                                          - avgs[l]) / _TIME_SCALE
            return state.replace_fields(**updates)

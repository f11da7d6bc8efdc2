"""Top sponge layer (reference model/modules/sponge_layer.h).

Port of ``miniweatherml_tpu/physics/sponge.py``: relaxes the top
``num_layers`` model levels toward the instantaneous horizontal mean (w
relaxed toward 0), with a cosine spatial profile and dt/time_scale temporal
blending.
"""

from __future__ import annotations

import math

import torch

from ..core.coupler import CouplerState
from ..parallel.collectives import pmean
from ..utils.profiling import span

__all__ = ["sponge_layer"]


def sponge_layer(state: CouplerState, dt: float, time_scale: float = 60.0,
                 num_layers: int = 10,
                 spmd_axes: tuple = ()) -> CouplerState:
    """``spmd_axes``: horizontal mesh axis names to ``pmean`` the horizontal
    means over, in a shard of a mesh run (the Allreduce analog; one
    reduction of every field's means together)."""
    with span("sponge.step"):
        g = state.grid
        names = ["density_dry", "uvel", "vvel", "wvel", "temp"] + \
            list(state.meta.tracer_names)
        time_factor = dt / time_scale

        ref = state["temp"]
        k = torch.arange(g.nz - num_layers, g.nz, device=ref.device)
        z = (k.to(ref.dtype) + 0.5) * g.dz
        rel_dist = (g.zlen - z) / (num_layers * g.dz)
        space_factor = (torch.cos(math.pi * rel_dist) + 1.0) / 2.0
        factor = (space_factor * time_factor)[None, :, None, None]

        # w is relaxed toward zero, not its mean (sponge_layer.h:23,50)
        avg_names = [n for n in names if n != "wvel"]
        means = pmean(torch.stack([
            torch.mean(state[n][:, -num_layers:], dim=(2, 3), keepdim=True)
            for n in avg_names]), spmd_axes)
        havgs = dict(zip(avg_names, means.unbind(0)), wvel=0.0)

        updates = {}
        for name in names:
            f = state[name]
            top = f[:, -num_layers:]
            havg = havgs[name]
            updates[name] = torch.cat(
                [f[:, :-num_layers], top + (havg - top) * factor], dim=1)
        return state.replace_fields(**updates)

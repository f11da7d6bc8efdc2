"""The plain reference of a configuration's chain: the initial state derived
from the configuration and the benchmark's inputs, then its step modules
in the reference order dycore -> microphysics -> sponge -> nudge.

The top sponge follows model/modules/sponge_layer.h and the column nudging
model/modules/column_nudging.h, as the port's ``physics/sponge.py`` and
``physics/column_nudging.py`` at commit b9c5862 describe them.  Nothing here
imports the program: a configuration names its initial state
(``reference/init_<init>.py``) and its microphysics
(``reference/micro_<micro>.py``), found by name.
"""

from __future__ import annotations

import importlib
import math

import torch

from ..inputs import apply_inputs
from .dycore import DycoreReference, time_step

NUDGE_FIELDS = ("density_dry", "uvel", "vvel", "temp", "water_vapor")
NUDGE_TIME_SCALE = 900.0
SPONGE_TIME_SCALE = 60.0
SPONGE_LAYERS = 10


def sponge(f, dt, grid, tracer_names):
    """Relax the top levels toward their horizontal mean (w toward 0)."""
    n = SPONGE_LAYERS
    names = ["density_dry", "uvel", "vvel", "wvel", "temp", *tracer_names]
    ref = f["temp"]
    k = torch.arange(grid.nz - n, grid.nz, device=ref.device)
    z = (k.to(ref.dtype) + 0.5) * grid.dz
    rel = (grid.zlen - z) / (n * grid.dz)
    factor = ((torch.cos(math.pi * rel) + 1.0) / 2.0
              * (dt / SPONGE_TIME_SCALE))[None, :, None, None]
    out = dict(f)
    for name in names:
        top = f[name][:, -n:]
        avg = 0.0 if name == "wvel" else top.mean(dim=(2, 3), keepdim=True)
        new = f[name].clone()
        new[:, -n:] = top + (avg - top) * factor
        out[name] = new
    return out


def nudge(f, dt, column):
    """Nudge the horizontal means toward the stored column."""
    out = dict(f)
    for i, name in enumerate(NUDGE_FIELDS):
        avg = f[name].mean(dim=(2, 3), keepdim=True)
        out[name] = f[name] + dt * (column[i][:, :, None, None] - avg) \
            / NUDGE_TIME_SCALE
    return out


class ReferenceChain:
    """The configuration's chain in plain PyTorch on ``device``."""

    def __init__(self, cfg: dict, grid, root: str, dtype, device):
        ref = cfg["reference"]
        pkg = __package__
        self.init = importlib.import_module(f"{pkg}.init_{ref['init']}")
        mod = importlib.import_module(f"{pkg}.micro_{ref['micro']}")
        self.micro_mod = mod
        self.micro = mod.Micro(cfg, root, dtype, device)
        self.grid, self.dtype, self.device = grid, dtype, device
        self.tracer_names = [t[0] for t in mod.TRACERS]
        self.idwv = self.tracer_names.index("water_vapor")
        self.c = self.init.constants(mod)
        self.dt = time_step(grid.dx, grid.dy, grid.dz)

    def initial(self, inputs: dict) -> dict:
        """The coupler fields after the build and the benchmark's inputs."""
        g, dt, dev = self.grid, self.dtype, self.device
        flags = [(p, m) for _, p, m in self.micro_mod.TRACERS]
        hy, s, tr = self.init.initial_dynamics(g, self.c,
                                               len(self.tracer_names),
                                               self.idwv, dt, dev)
        self.dycore = DycoreReference(g, self.c, hy, flags, dt, dev)
        f = self.dycore.to_coupler(s, tr, self.tracer_names, self.idwv)
        del s, tr
        self.column = torch.stack([f[n].mean(dim=(2, 3))
                                   for n in NUDGE_FIELDS])
        f["temp"] = f["temp"] + self.init.thermal_bubble(g, dt, dev)[None]
        for name, kind in self.micro_mod.FIELDS.items():
            shape = ((g.nens, g.ny, g.nx) if kind == "surface" else
                     (g.nens, g.nz, g.ny, g.nx))
            f[name] = torch.zeros(shape, dtype=dt, device=dev)
        f.update(apply_inputs(f, inputs))
        return f

    def step(self, f: dict) -> dict:
        dt, g = self.dt, self.grid
        f = self.dycore.time_step(f, dt, self.tracer_names, self.idwv)
        f = self.micro.time_step(f, dt, g)
        f = sponge(f, dt, g, self.tracer_names)
        return nudge(f, dt, self.column)

"""The top sponge (model/modules/sponge_layer.h, as the port's
``physics/sponge.py`` at commit b9c5862 describes it): the top ``layers``
levels relax toward their horizontal mean (w toward 0) with a cosine
profile and dt / ``time_scale``.  Settings (``reference.sponge``):
``time_scale`` (s, default 60) and ``layers`` (default 10)."""

from __future__ import annotations

import math

import torch

TIME_SCALE = 60.0
LAYERS = 10


def sponge(f, dt, grid, tracer_names, time_scale=TIME_SCALE, layers=LAYERS):
    """Relax the top levels toward their horizontal mean (w toward 0)."""
    n = layers
    names = ["density_dry", "uvel", "vvel", "wvel", "temp", *tracer_names]
    ref = f["temp"]
    k = torch.arange(grid.nz - n, grid.nz, device=ref.device)
    z = (k.to(ref.dtype) + 0.5) * grid.dz
    rel = (grid.zlen - z) / (n * grid.dz)
    factor = ((torch.cos(math.pi * rel) + 1.0) / 2.0
              * (dt / time_scale))[None, :, None, None]
    out = dict(f)
    for name in names:
        top = f[name][:, -n:]
        avg = 0.0 if name == "wvel" else top.mean(dim=(2, 3), keepdim=True)
        new = f[name].clone()
        new[:, -n:] = top + (avg - top) * factor
        out[name] = new
    return out


class Step:
    def __init__(self, chain, settings=None):
        s = settings or {}
        self.chain = chain
        self.time_scale = float(s.get("time_scale", TIME_SCALE))
        self.layers = int(s.get("layers", LAYERS))

    def __call__(self, f: dict) -> dict:
        c = self.chain
        return sponge(f, c.dt, c.grid, c.tracer_names, self.time_scale,
                      self.layers)

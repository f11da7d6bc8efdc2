"""The lateral sponge of the city chain (experiments/simple_city/
custom_modules/horizontal_sponge.h:54-68, 100-193, as the port's
``physics/horizontal_sponge.py`` and ``tests/test_aux_oracle.py``'s
reference kernel at commit a5ba73f describe it): the (j = 0, i = 0) column
of six fields is stored from the built state; each step, wall after wall,
the band of ``cells`` cells at the wall blends toward that column with the
weight (cos(pi d / (cells - 1)) + 1) / 2 x dt / ``time_scale`` at distance
d from the wall.  Settings (``reference.hsponge``): ``cells`` (default
10), ``time_scale`` (s, default 1) and ``walls`` (of x1, x2, y1, y2, in
that order; default all four)."""

from __future__ import annotations

import math

import torch

FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor")
WALLS = ("x1", "x2", "y1", "y2")


class Step:
    def __init__(self, chain, settings=None):
        s = settings or {}
        self.chain = chain
        self.cells = int(s.get("cells", 10))
        self.time_scale = float(s.get("time_scale", 1.0))
        self.walls = [w for w in WALLS if w in s.get("walls", WALLS)]
        self.column = None

    def setup(self, f: dict) -> dict:
        self.column = {n: f[n][:, :, 0, 0].clone() for n in FIELDS}
        return f

    def _weight(self, wall):
        """The wall's blend weight, broadcast over (nens, nz, ny, nx)."""
        c, g = self.chain, self.chain.grid
        n = g.nx if wall[0] == "x" else g.ny
        d = torch.arange(n, device=c.device)
        if wall[1] == "2":
            d = n - 1 - d
        w = torch.where(
            d < self.cells,
            (torch.cos(math.pi * d.to(c.dtype) / (self.cells - 1)) + 1.0)
            / 2.0, 0.0) * (c.dt / self.time_scale)
        return w[None, None, None, :] if wall[0] == "x" else \
            w[None, None, :, None]

    def __call__(self, f: dict) -> dict:
        out = dict(f)
        for wall in self.walls:
            w = self._weight(wall)
            for n in FIELDS:
                col = self.column[n][:, :, None, None]
                out[n] = w * col + (1.0 - w) * out[n]
        return out

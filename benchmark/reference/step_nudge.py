"""The column nudging (model/modules/column_nudging.h, as the port's
``physics/column_nudging.py`` at commit b9c5862 describes it): the
horizontal means of five fields nudged toward the column stored from the
built state, before any perturbation."""

from __future__ import annotations

import torch

NUDGE_FIELDS = ("density_dry", "uvel", "vvel", "temp", "water_vapor")
NUDGE_TIME_SCALE = 900.0


def nudge(f, dt, column):
    """Nudge the horizontal means toward the stored column."""
    out = dict(f)
    for i, name in enumerate(NUDGE_FIELDS):
        avg = f[name].mean(dim=(2, 3), keepdim=True)
        out[name] = f[name] + dt * (column[i][:, :, None, None] - avg) \
            / NUDGE_TIME_SCALE
    return out


class Step:
    def __init__(self, chain, settings=None):
        self.chain = chain
        self.column = None

    def setup(self, f: dict) -> dict:
        self.column = torch.stack([f[n].mean(dim=(2, 3))
                                   for n in NUDGE_FIELDS])
        return f

    def __call__(self, f: dict) -> dict:
        return nudge(f, self.chain.dt, self.column)

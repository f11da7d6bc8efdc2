"""The running time average of the city chain (experiments/simple_city/
custom_modules/time_averager.h:60-70, as the port's
``physics/time_averager.py`` and ``tests/test_aux_oracle.py``'s reference
kernel at commit a5ba73f describe it): the fields ``time_avg_<name>`` of
six fields, zero at the build, become inertia x avg + (1 - inertia) x
field with inertia = etime / (etime + dt), etime the simulated seconds
before the step."""

from __future__ import annotations

import torch

FIELDS = ("density_dry", "uvel", "vvel", "wvel", "temp", "water_vapor")


class Step:
    def __init__(self, chain, settings=None):
        self.chain = chain
        self.etime = 0.0

    def setup(self, f: dict) -> dict:
        for n in FIELDS:
            f["time_avg_" + n] = torch.zeros_like(f[n])
        self.etime = 0.0
        return f

    def __call__(self, f: dict) -> dict:
        dt = self.chain.dt
        inertia = self.etime / (self.etime + dt)
        out = dict(f)
        for n in FIELDS:
            out["time_avg_" + n] = inertia * f["time_avg_" + n] \
                + (1.0 - inertia) * f[n]
        self.etime += dt
        return out

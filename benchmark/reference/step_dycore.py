"""The dycore's module step (``dycore.py``: CFL sub-cycles of SSPRK3 on the
coupler fields) in a reference chain."""

from __future__ import annotations


class Step:
    def __init__(self, chain, settings=None):
        self.chain = chain

    def __call__(self, f: dict) -> dict:
        c = self.chain
        return c.dycore.time_step(f, c.dt, c.tracer_names, c.idwv)

"""The microphysics module's step in a reference chain: the scheme the
configuration's ``reference.micro`` names (``micro_<micro>.py``), with the
module's own fields (``FIELDS``) zero at the build."""

from __future__ import annotations

import torch


class Step:
    def __init__(self, chain, settings=None):
        if chain.micro is None:
            raise ValueError("a chain with a micro step names its scheme "
                             "in reference.micro")
        self.chain = chain

    def setup(self, f: dict) -> dict:
        c, g = self.chain, self.chain.grid
        for name, kind in c.micro_mod.FIELDS.items():
            shape = ((g.nens, g.ny, g.nx) if kind == "surface" else
                     (g.nens, g.nz, g.ny, g.nx))
            f[name] = torch.zeros(shape, dtype=c.dtype, device=c.device)
        return f

    def __call__(self, f: dict) -> dict:
        c = self.chain
        return c.micro.time_step(f, c.dt, c.grid)

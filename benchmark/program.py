"""The system under test: the port's chain for a configuration, built
through the port's public entries.

The configuration names the experiment module (``entry``) whose build
function (``build``, default ``build``) makes the chain from ``(config,
device)`` and returns ``(state, step_modules, dycore)``, and the dycore
form to run (``dycore``: its keyword arguments, as
``miniweatherml_tpu_torch.bench`` swaps it in).  That form's step takes
the place of the entry's dycore step, found by identity wherever it sits
in the chain; every other module runs as built, in the built order, under
the names the configuration's ``modules`` gives.  This is the only module
of the benchmark that imports the program.
"""

from __future__ import annotations

import importlib

import torch


class Program:
    """The port's chain for ``cfg`` on ``device``."""

    def __init__(self, cfg: dict, device):
        from miniweatherml_tpu_torch.config import config_from_dict
        from miniweatherml_tpu_torch.dycore.euler import Dycore

        self.config = config_from_dict(cfg)
        build = getattr(importlib.import_module(cfg["entry"]),
                        cfg.get("build", "build"))
        state, mods, built = build(self.config, device)
        at = [i for i, m in enumerate(mods) if m == built.time_step]
        if len(at) != 1:
            raise ValueError(f"the chain holds its dycore's step {len(at)} "
                             "times, not once")
        self.dycore = Dycore(**cfg["dycore"])
        self.mods = list(mods)
        self.mods[at[0]] = self.dycore.time_step
        self.names = list(cfg["modules"])
        if len(self.names) != len(self.mods):
            raise ValueError(f"modules {self.names} do not name the chain's "
                             f"{len(self.mods)} step modules")
        self.state = state

    def apply(self, updates: dict) -> None:
        self.state = self.state.replace_fields(**updates)

    def time_step(self) -> float:
        """The CFL step, taken once and held (``Dycore.compute_time_step``)."""
        return self.dycore.compute_time_step(self.state)

    def step(self, dt: float, spans: bool = False) -> None:
        """One step of the chain; with ``spans`` each module inside a
        ``record_function`` span of its name."""
        state = self.state
        if spans:
            for name, mod in zip(self.names, self.mods):
                with torch.profiler.record_function(name):
                    state = mod(state, dt)
        else:
            for mod in self.mods:
                state = mod(state, dt)
        self.state = state

    def fields(self, names) -> dict:
        return {n: self.state[n] for n in names}

    def validate(self) -> dict:
        return self.state.validate()

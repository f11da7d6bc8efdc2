"""The plain reference of a configuration's chain: the initial state derived
from the configuration and the benchmark's inputs, then its steps in the
configuration's order.

A configuration's ``reference`` names its initial state (``init``:
``reference/init_<init>.py``), its microphysics where it has one
(``micro``: ``reference/micro_<micro>.py``) and its steps (``steps``,
default dycore -> micro -> sponge -> nudge: ``reference/step_<step>.py``),
each found by name in the checkout, so a chain of other steps is new files
and entries.  The entry of a step's name under ``reference`` holds that
step's settings (the top sponge's ``time_scale`` and ``layers``, the
lateral sponge's ``cells``, ``time_scale`` and ``walls``).

An init module gives ``constants(micro)`` (gas constants, boundary
conditions, gravity and immersed-boundary switches) and
``initial_dynamics``; where it has them, ``TRACERS`` (the chain's tracers
when it has no microphysics), ``immersed_proportion(grid, cfg, root,
dtype, device)`` (the dycore's immersed blend) and ``perturb(f, grid,
dtype, device)`` (what the build adds after the steps' own set-up, as the
supercell's thermal bubble).  A step module gives ``Step(chain,
settings)``: called on the coupler fields, and with ``setup(f)`` where the
step keeps fields or state of its own from the built state, before the
inputs.  Nothing here imports the program.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

from ..inputs import apply_inputs
from .dycore import DycoreReference, time_step

DEFAULT_STEPS = ("dycore", "micro", "sponge", "nudge")
HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str, name: str):
    """``reference/<name>.py`` of the checkout at ``root``: this package's
    module where the checkout is this one, else loaded from its file (its
    relative imports then reach this package's modules)."""
    path = os.path.join(root, "benchmark", "reference", name + ".py")
    if os.path.realpath(os.path.dirname(path)) == os.path.realpath(HERE):
        return importlib.import_module(f"{__package__}.{name}")
    spec = importlib.util.spec_from_file_location(f"{__package__}.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ReferenceChain:
    """The configuration's chain in plain PyTorch on ``device``."""

    def __init__(self, cfg: dict, grid, root: str, dtype, device):
        ref = cfg["reference"]
        self.cfg, self.root = cfg, root
        self.init = load(root, f"init_{ref['init']}")
        self.micro_mod = load(root, f"micro_{ref['micro']}") \
            if ref.get("micro") else None
        self.micro = None if self.micro_mod is None else \
            self.micro_mod.Micro(cfg, root, dtype, device)
        self.grid, self.dtype, self.device = grid, dtype, device
        tracers = (self.micro_mod or self.init).TRACERS
        self.tracer_flags = [(p, m) for _, p, m in tracers]
        self.tracer_names = [t[0] for t in tracers]
        self.idwv = self.tracer_names.index("water_vapor")
        self.c = self.init.constants(self.micro_mod)
        self.dt = time_step(grid.dx, grid.dy, grid.dz)
        self.steps = [load(root, f"step_{name}").Step(self, ref.get(name))
                      for name in ref.get("steps", DEFAULT_STEPS)]

    def initial(self, inputs: dict) -> dict:
        """The coupler fields after the build and the benchmark's inputs."""
        g, dt, dev = self.grid, self.dtype, self.device
        hy, s, tr = self.init.initial_dynamics(g, self.c,
                                               len(self.tracer_names),
                                               self.idwv, dt, dev)
        if hasattr(self.init, "immersed_proportion"):
            self.c["immersed_proportion"] = self.init.immersed_proportion(
                g, self.cfg, self.root, dt, dev)
        self.dycore = DycoreReference(g, self.c, hy, self.tracer_flags, dt,
                                      dev)
        f = self.dycore.to_coupler(s, tr, self.tracer_names, self.idwv)
        del s, tr
        for step in self.steps:
            if hasattr(step, "setup"):
                f = step.setup(f)
        if hasattr(self.init, "perturb"):
            f = self.init.perturb(f, g, dt, dev)
        f.update(apply_inputs(f, inputs))
        return f

    def step(self, f: dict) -> dict:
        for step in self.steps:
            f = step(f)
        return f

"""Supercell with P3 ice microphysics.

Port of ``miniweatherml_tpu/experiments/supercell_p3.py``: the supercell
driver chain (dycore -> micro -> sponge -> nudge) with ``MicrophysicsP3`` in
place of Kessler (reference model/modules/microphysics_p3.h).  YAML keys:
``p3_backend`` ("torch", or "jax" for the same scheme, or "native" for the
C++ twin, whose column step runs on the host while the rest of the chain
stays on the device) and ``p3_diagnostics: true``, which registers part3's
diagnostic fields, fills them each step and writes them to the NetCDF
output (not with "native").

Usage:  python -m miniweatherml_tpu_torch.experiments.supercell_p3 <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import SimConfig, load_config
from ..core.coupler import CouplerState
from ..dycore.euler import Dycore
from ..io.netcdf import StateWriter
from ..physics.column_nudging import ColumnNudger
from ..physics.p3 import MicrophysicsP3
from ..physics.perturb import perturb_temperature
from ..physics.sponge import sponge_layer
from .driver import Timers, parse_command_line, run_main_loop, setup_state

__all__ = ["build", "run", "main", "seed_all_active", "seed_layers",
           "seed_mixed_regimes"]


def build(config: SimConfig, device: str | torch.device):
    """Initialize coupler + modules on ``device``; returns (state,
    step_modules, dycore), modules in the reference order dycore -> micro
    -> sponge -> nudge."""
    state = setup_state(config, device)
    micro = MicrophysicsP3(
        backend=str(config.extras.get("p3_backend", "torch")),
        diagnostics=bool(config.extras.get("p3_diagnostics", False)))
    dycore = Dycore()
    nudger = ColumnNudger()

    state = micro.init(state)
    state = dycore.init(state)
    state = nudger.set_column(state)
    state = perturb_temperature(state)

    step_modules = [
        dycore.time_step,
        micro.time_step,
        sponge_layer,
        nudger.nudge_to_column,
    ]
    return state, step_modules, dycore


# Seeded states for measurements and checks.  Each returns a new state whose
# hydrometeor tracer masses (and, for the mixed regimes, temperature) are
# replaced; the dry density is not re-derived, so they are inputs for timing
# and for comparisons, not physics runs.

# bench.py's all-cells-active floor (MWML_BENCH_P3_ACTIVE=1), tracer masses
ACTIVE_SEEDS = {"cloud_water": 1.0e-4, "cloud_water_num": 1.0e7,
                "rain": 1.0e-4, "rain_num": 1.0e5, "ice": 1.0e-4,
                "ice_num": 1.0e5, "ice_rime": 5.0e-5, "ice_rime_vol": 1.0e-7}


def seed_all_active(state: CouplerState) -> CouplerState:
    """At least a little cloud, rain and rimed ice in every cell, so every
    presence gate fires on every step (bench.py's P3 worst case)."""
    return state.replace_fields(**{k: torch.clamp(state[k], min=v)
                                   for k, v in ACTIVE_SEEDS.items()})


def seed_mixed_regimes(state: CouplerState, seed: int = 3) -> CouplerState:
    """White-noise hydrometeors over every regime (warm, riming, collection,
    freezing, melting, wet growth, evaporation) and a +-20 K temperature
    jitter: the numpy recipe of the JAX suite's ``_seeded_mixed_state``
    (tests/test_p3.py), drawn in the same order from the same seed."""
    rng = np.random.default_rng(seed)
    rho_d = state["density_dry"].double().cpu().numpy()
    shape = rho_d.shape

    def fld(scale, frac):
        v = rng.random(shape) * scale
        v = np.where(rng.random(shape) < frac, v, 0.0)
        return torch.as_tensor(v * rho_d, dtype=state["temp"].dtype,
                               device=state.device)
    fields = dict(
        cloud_water=fld(2e-3, 0.5), cloud_water_num=fld(1e8, 0.5),
        rain=fld(1e-3, 0.4), rain_num=fld(1e5, 0.4),
        ice=fld(1e-3, 0.4), ice_num=fld(1e5, 0.4),
        ice_rime=fld(3e-4, 0.3), ice_rime_vol=fld(1e-6, 0.3))
    jitter = torch.as_tensor(rng.uniform(-20.0, 20.0, shape),
                             dtype=state["temp"].dtype, device=state.device)
    return state.replace_fields(temp=state["temp"] + jitter, **fields)


def seed_layers(state: CouplerState) -> CouplerState:
    """Smooth hydrometeor layers: cloud around 4 km, rain around 2.5 km,
    rimed ice around 9 km, modulated horizontally.  Smooth fields keep the
    dycore's WENO stencil choices away from their switching points, so two
    implementations can be compared closely over several steps."""
    g = state.grid
    dev, dt = state.device, state["temp"].dtype

    def axis(n, d, shape):
        return ((torch.arange(n, dtype=torch.float64) + 0.5) * d).reshape(shape)
    z = axis(g.nz, g.dz, (1, -1, 1, 1))
    x = axis(g.nx, g.dx, (1, 1, 1, -1))
    y = axis(g.ny, g.dy, (1, 1, -1, 1))
    horiz = 1.0 + 0.5 * (torch.sin(2 * np.pi * x / g.xlen)
                         * torch.cos(2 * np.pi * y / g.ylen))
    rho_d = state["density_dry"].double().cpu()

    def layer(peak, zc, width):
        v = peak * torch.exp(-((z - zc) / width) ** 2) * horiz * rho_d
        return v.to(device=dev, dtype=dt)
    return state.replace_fields(
        cloud_water=layer(1.5e-3, 4000.0, 2500.0),
        cloud_water_num=layer(1e8, 4000.0, 2500.0),
        rain=layer(1e-3, 2500.0, 2000.0), rain_num=layer(1e5, 2500.0, 2000.0),
        ice=layer(1e-3, 9000.0, 3000.0), ice_num=layer(1e5, 9000.0, 3000.0),
        ice_rime=layer(3e-4, 9000.0, 3000.0),
        ice_rime_vol=layer(7.5e-7, 9000.0, 3000.0))


def run(config: SimConfig, device: str | torch.device) -> CouplerState:
    """Build and run the experiment, with NetCDF output (diagnostics
    included when enabled) when ``out_freq >= 0``; prints the heartbeat and
    the timers."""
    state, mods, dycore = build(config, device)
    diag = (MicrophysicsP3.DIAG_FIELDS
            if config.extras.get("p3_diagnostics", False) else ())
    writer = (StateWriter(config.out_prefix, state, extra_vars=diag)
              if config.out_freq >= 0 else None)
    timers = Timers(device)
    timers.start("main")
    state = run_main_loop(state, config, mods, dycore, writer, timers,
                          validate=bool(config.extras.get("validate", False)))
    timers.stop("main")
    if writer:
        writer.close()
    print(timers.report())
    return state


def main(argv=None) -> CouplerState:
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("supercell_p3", argv)
    return run(load_config(path), device)


if __name__ == "__main__":
    main()

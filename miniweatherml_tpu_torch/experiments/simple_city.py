"""Dycore-only flow over immersed buildings (city / building test cases).

Port of ``miniweatherml_tpu/experiments/simple_city.py``
(experiments/simple_city/driver.cpp): WENO dycore with immersed boundaries
+ west/east horizontal sponge + top sponge (time scale 1 s) + running time
averager; a manually-added water_vapor tracer and optional gravity
(driver.cpp:37-38,55-56,72-77).  ``dyn_order``, ``riemann_impl`` and
``fast_weights`` set the dycore's numerics, as in ``supercell_example``.

Usage:  python -m miniweatherml_tpu_torch.experiments.simple_city <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from ..core.coupler import CouplerState
from ..physics.horizontal_sponge import HorizontalSponge
from ..physics.sponge import sponge_layer
from ..physics.time_averager import TimeAverager
from .driver import Timers, parse_command_line, run_main_loop, setup_state
from .supercell_example import dycore_from_config, make_writer

__all__ = ["build", "build_chain", "run", "main"]


def build(config: SimConfig, device: str | torch.device):
    """Initialize coupler + modules on ``device``; returns (state,
    step_modules, dycore, time_averager).  Module order matches
    driver.cpp:70-77."""
    state = setup_state(config, device)
    dycore = dycore_from_config(config)
    horiz_sponge = HorizontalSponge(sponge_cells=10, time_scale=1.0)
    time_averager = TimeAverager()

    # driver.cpp:55-56: water_vapor added manually (no microphysics module).
    state = state.add_tracer("water_vapor", "water_vapor", True, True)
    state = dycore.init(state)
    state = horiz_sponge.init(state)       # driver.cpp:72
    state = time_averager.init(state)

    step_modules = [
        # x-walls only (driver.cpp:74: apply(coupler, dt, true, true, false, false))
        lambda s, dt: horiz_sponge.apply(s, dt, x1=True, x2=True, y1=False,
                                         y2=False),
        dycore.time_step,
        lambda s, dt: sponge_layer(s, dt, time_scale=1.0),
        time_averager.accumulate,
    ]
    return state, step_modules, dycore, time_averager


def build_chain(config: SimConfig, device: str | torch.device):
    """``build`` without the averager object, in the (state, step_modules,
    dycore) form of ``community_benchmark.run_benchmark(build=...)``; the
    averages still accumulate in the state (``TimeAverager`` keeps none of
    its own, so ``TimeAverager().finalize`` writes them)."""
    state, mods, dycore, _ = build(config, device)
    return state, mods, dycore


def run(config: SimConfig, device: str | torch.device,
        avg_path: str = "time_averaged_fields.nc") -> CouplerState:
    """Build and run the chain, with NetCDF output when ``out_freq >= 0``
    (``supercell_example.make_writer``: one file per shard with
    ``file_per_process``) and the averaged fields written to ``avg_path`` at the end; prints the
    heartbeat and the timers."""
    state, mods, dycore, time_averager = build(config, device)
    writer = make_writer(config, state)
    timers = Timers(device)
    timers.start("main")
    state = run_main_loop(state, config, mods, dycore, writer, timers,
                          validate=bool(config.extras.get("validate", False)))
    timers.stop("main")
    if writer:
        writer.close()
    print(f"wrote {time_averager.finalize(state, avg_path)}")
    print(timers.report())
    return state


def main(argv=None) -> CouplerState:
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("simple_city", argv)
    return run(load_config(path), device)


if __name__ == "__main__":
    main()

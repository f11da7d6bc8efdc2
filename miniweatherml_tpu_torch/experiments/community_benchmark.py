"""Timed benchmark experiment.

Port of ``miniweatherml_tpu/experiments/community_benchmark.py``
(experiments/community_benchmark/driver.cpp): the supercell_example physics
chain, output disabled, with a timer around the simulation loop and a
throughput report in cell-updates/sec.

Usage: python -m miniweatherml_tpu_torch.experiments.community_benchmark <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from . import supercell_example
from .driver import Timers, parse_command_line, run_main_loop

__all__ = ["main", "run_benchmark"]


def run_benchmark(config: SimConfig, device: str | torch.device,
                  quiet: bool = False, build=supercell_example.build):
    """Run the chain for ``config.sim_time``; returns (state, result) where
    result holds the step count, the timed seconds and Mcellups (cells x
    steps / s / 1e6).  ``build(config, device) -> (state, step_modules,
    dycore)`` makes the chain (default: the Kessler supercell).  One step
    on a copy of the state runs first and is discarded, so one-time costs
    (kernel builds, allocator growth) stay outside the timer."""
    state, mods, dycore = build(config, device)
    g = config.grid
    dt = (dycore.compute_time_step(state) if config.dt_phys <= 0.0
          else config.dt_phys)
    warm = state.clone()
    for mod in mods:
        warm = mod(warm, dt)
    del warm
    timers = Timers(device)
    nsteps = [0]
    state = run_main_loop(
        state, config, mods, dycore, writer=None, timers=timers,
        on_step=lambda s, d, e: nsteps.__setitem__(0, nsteps[0] + 1),
        quiet=quiet,
    )
    elapsed = timers.acc["simulation_loop"]
    cells = g.nx * g.ny * g.nz * g.nens
    result = {
        "steps": nsteps[0],
        "elapsed_s": elapsed,
        "steps_per_s": nsteps[0] / max(elapsed, 1e-12),
        "mcellups": cells * nsteps[0] / max(elapsed, 1e-12) / 1e6,
    }
    if not quiet:
        print(f"simulation_loop: {elapsed:.3f} s, {nsteps[0]} steps, "
              f"{result['mcellups']:.2f} Mcell-updates/s")
    return state, result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("community_benchmark", argv)
    return run_benchmark(load_config(path), device)


if __name__ == "__main__":
    main()

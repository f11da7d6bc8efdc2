"""The canonical supercell experiment.

Port of ``miniweatherml_tpu/experiments/supercell_example.py``
(experiments/supercell_example/driver.cpp): Kessler microphysics + WENO
dycore + top sponge + column nudging, seeded with a deterministic thermal
temperature perturbation.

Usage:  python -m miniweatherml_tpu_torch.experiments.supercell_example <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from ..core.coupler import CouplerState
from ..dycore.euler import Dycore
from ..io.checkpoint import load_checkpoint
from ..io.netcdf import ShardedStateWriter, StateWriter
from ..physics.column_nudging import ColumnNudger
from ..physics.kessler import MicrophysicsKessler
from ..physics.perturb import perturb_temperature
from ..physics.sponge import sponge_layer
from .driver import Timers, parse_command_line, run_main_loop, setup_state

__all__ = ["build", "dycore_from_config", "make_writer", "run", "main"]


def dycore_from_config(config: SimConfig) -> Dycore:
    """The dycore of the YAML's numerics keys, as the JAX package's builds
    read them: ``dyn_order`` (the reference's -DMW_ORD compile flag,
    dynamics...h:24-28), ``riemann_impl`` ("xla", "pallas" or "auto") and
    ``fast_weights`` (unset: follows ``riemann_impl``)."""
    ex = config.extras
    return Dycore(ord=int(ex.get("dyn_order", 5)),
                  riemann_impl=str(ex.get("riemann_impl", "auto")),
                  fast_weights=(bool(ex["fast_weights"])
                                if "fast_weights" in ex else None))


def build(config: SimConfig, device: str | torch.device):
    """Initialize coupler + modules on ``device``; returns (state,
    step_modules, dycore).

    Module order matches the reference main loop (driver.cpp:72-77):
    dycore -> micro -> sponge -> nudge.
    """
    state = setup_state(config, device)
    micro = MicrophysicsKessler()
    dycore = dycore_from_config(config)
    nudger = ColumnNudger()

    state = micro.init(state)          # driver.cpp:58
    state = dycore.init(state)         # driver.cpp:59
    state = nudger.set_column(state)   # driver.cpp:60
    state = perturb_temperature(state) # driver.cpp:61

    step_modules = [
        dycore.time_step,
        micro.time_step,
        sponge_layer,
        nudger.nudge_to_column,
    ]
    return state, step_modules, dycore


def _restart_options(config: SimConfig, state: CouplerState,
                     device: str | torch.device):
    """The YAML's checkpoint / restart keys, as the JAX package's
    ``supercell_example.main`` reads them: ``restart_file`` (resume from a
    ``.npz`` checkpoint, replacing ``state``) and ``checkpoint_freq`` (write
    ``<out_prefix>_chkpt.npz`` every N simulated seconds).  Returns (state,
    keyword arguments of ``run_main_loop``)."""
    etime0 = 0.0
    if config.extras.get("restart_file"):
        state, etime0 = load_checkpoint(str(config.extras["restart_file"]),
                                        device)
        print(f"restarted from {config.extras['restart_file']} at "
              f"etime={etime0:g}")
    return state, dict(
        etime0=etime0,
        checkpoint_freq=float(config.extras.get("checkpoint_freq", -1.0)),
        checkpoint_path=config.out_prefix + "_chkpt.npz",
        validate=bool(config.extras.get("validate", False)))


def make_writer(config: SimConfig, state: CouplerState):
    """The NetCDF writer of ``config``: None when ``out_freq < 0``; with
    ``file_per_process`` one file per shard (``<out_prefix>_task_0.nc`` on
    one device, the reference's per-rank output), else ``<out_prefix>.nc``."""
    if config.out_freq < 0:
        return None
    if config.file_per_process:
        return ShardedStateWriter(config.out_prefix, state)
    return StateWriter(config.out_prefix, state)


def run(config: SimConfig, device: str | torch.device) -> CouplerState:
    """Build and run the experiment, with NetCDF output when
    ``out_freq >= 0`` (``make_writer``) and the checkpoint / restart keys of
    ``_restart_options``; prints the heartbeat and the timers."""
    state, mods, dycore = build(config, device)
    state, loop_kw = _restart_options(config, state, device)
    writer = make_writer(config, state)
    timers = Timers(device)
    timers.start("main")
    state = run_main_loop(state, config, mods, dycore, writer, timers,
                          **loop_kw)
    timers.stop("main")
    if writer:
        writer.close()
    print(timers.report())
    return state


def main(argv=None) -> CouplerState:
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("supercell_example", argv)
    return run(load_config(path), device)


if __name__ == "__main__":
    main()

"""Shared experiment-driver machinery.

Port of ``miniweatherml_tpu/experiments/driver.py``, after the reference
driver pattern (experiments/supercell_example/driver.cpp:9-88): config ->
allocate coupler -> module init -> main loop {compute dt, module
time_steps} -> finalize, plus the ``Etime, dtphys, maxw`` heartbeat
(dynamics...h:186-196) and periodic NetCDF output.  The port runs eagerly:
each step calls the modules in order; the timers synchronize the device
before they read the clock.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Sequence

import torch

from ..config import SimConfig
from ..core.coupler import CouplerState, make_coupler_state
from ..io.checkpoint import save_checkpoint
from ..io.netcdf import StateWriter

__all__ = ["setup_state", "run_main_loop", "Timers", "parse_command_line",
           "add_device_argument", "checked_device"]


def parse_command_line(prog: str, argv: Sequence[str]) -> tuple[str, str]:
    """(input YAML path, device) of an experiment's command line
    ``<input.yaml> [--device cuda|cpu]``.  The device is the GPU unless the
    caller asks for the CPU; without CUDA the GPU default raises rather
    than falling back."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("input", help="input YAML")
    add_device_argument(ap)
    args = ap.parse_args(list(argv))
    return args.input, checked_device(prog, args.device)


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    """The ``--device`` option every entry point takes."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")


def checked_device(prog: str, name: str) -> str:
    """``name`` as a torch device string; a CUDA device without CUDA raises,
    naming ``--device cpu``, rather than falling back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{prog}: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    return str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    """Wall-clock section timers (the reference uses yakl::timer_start/stop,
    e.g. community_benchmark/driver.cpp:66,82).  With a CUDA ``device`` each
    start and stop first waits for the device's queued work."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.acc: dict[str, float] = {}
        self._open: dict[str, float] = {}

    def start(self, name: str):
        _sync(self.device)
        self._open[name] = time.perf_counter()

    def stop(self, name: str):
        _sync(self.device)
        self.acc[name] = (self.acc.get(name, 0.0) + time.perf_counter()
                          - self._open.pop(name))

    def report(self) -> str:
        return "\n".join(f"  {k:<24s} {v:10.3f} s" for k, v in self.acc.items())


def setup_state(config: SimConfig, device: str | torch.device) -> CouplerState:
    """Allocate the coupler state on ``device`` and stash driver-level
    options (reference driver.cpp:34-47)."""
    state = make_coupler_state(config.grid, dtype=config.dtype, device=device)
    return state.set_options(
        out_prefix=config.out_prefix,
        init_data=config.init_data,
        out_freq=config.out_freq,
        enable_gravity=config.enable_gravity,
        file_per_process=config.file_per_process,
        standalone_input_file=config.config_path,
    )


def run_main_loop(
    state: CouplerState,
    config: SimConfig,
    step_modules: Sequence[Callable[[CouplerState, float], CouplerState]],
    dycore,
    writer: StateWriter | None = None,
    timers: Timers | None = None,
    on_step: Callable[[CouplerState, float, float], None] | None = None,
    quiet: bool = False,
    etime0: float = 0.0,
    checkpoint_freq: float = -1.0,
    checkpoint_path: str = "",
    validate: bool = False,
) -> CouplerState:
    """The reference main loop (driver.cpp:64-80) with heartbeat + output.
    ``on_step(state, dtphys, etime)`` runs after every step.  A restarted
    run starts at ``etime0`` (its output and checkpoint counters continue
    from there); with ``checkpoint_freq > 0`` the state is saved to
    ``checkpoint_path`` every ``checkpoint_freq`` simulated seconds.
    ``validate`` checks every field for NaN / Inf / negative tracers after
    each step (one host read) and raises on a problem."""
    timers = timers or Timers(state.device)
    etime = etime0
    dtphys_in = config.dt_phys
    out_freq = config.out_freq
    num_out = int(etime0 / out_freq) if out_freq > 0 else 0
    num_chk = int(etime0 / checkpoint_freq) if checkpoint_freq > 0 else 0

    if writer is not None and out_freq >= 0.0 and etime0 == 0.0:
        writer.write(state, 0.0)

    timers.start("simulation_loop")
    while etime < config.sim_time:
        dtphys = (dycore.compute_time_step(state) if dtphys_in <= 0.0
                  else dtphys_in)
        if etime + dtphys > config.sim_time:
            dtphys = config.sim_time - etime
        for mod in step_modules:
            state = mod(state, dtphys)
        etime += dtphys
        if on_step is not None:
            on_step(state, dtphys, etime)
        if validate:
            problems = state.validate()
            if problems:
                raise FloatingPointError(
                    f"state validation failed at etime={etime:g}: {problems}")
        if out_freq >= 0.0 and etime / out_freq >= num_out + 1:
            if writer is not None:
                writer.write(state, etime)
            num_out += 1
            maxw = float(torch.max(torch.abs(state["wvel"])))
            if not quiet:
                # heartbeat format mirrors dynamics...h:193-195
                print(f"Etime , dtphys, maxw: {etime:10.6e} , "
                      f"{dtphys:10.6e} , {maxw:10.6e}", flush=True)
        if (checkpoint_freq > 0.0 and checkpoint_path
                and etime / checkpoint_freq >= num_chk + 1):
            save_checkpoint(checkpoint_path, state, etime)
            num_chk += 1
    timers.stop("simulation_loop")
    return state

"""Supercell run with the MLP surrogate microphysics deployed inline.

Port of ``miniweatherml_tpu/experiments/inference_surrogate.py``
(experiments/supercell_kessler_surrogate/inference_ponni.cpp): the
supercell_example chain with the NN surrogate as the micro module
(custom_modules::Microphysics_Kessler in microphysics_kessler_ponni.h).
YAML keys (reference supercell_kessler_surrogate/inputs/input_euler3d.yaml:
29-33):

  keras_weights_h5 / nn_weights : Keras HDF5 (needs h5py) or .npz weights
  nn_input_scaling              : 5x2 min-max table (text)
  nn_output_scaling             : 4x2 min-max table (text)
  surrogate_online              : bool (default false, matching the
                                  reference's commented-out override)
  surrogate_compare             : print mean NN-truth diffs every step
                                  (default true)

Usage: python -m miniweatherml_tpu_torch.experiments.inference_surrogate <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from ..core.coupler import CouplerState
from ..dycore.euler import Dycore
from ..io.netcdf import StateWriter
from ..ml.mlp import load_keras_h5, load_mlp, load_scaling
from ..physics.column_nudging import ColumnNudger
from ..physics.kessler_surrogate import MicrophysicsKesslerSurrogate
from ..physics.perturb import perturb_temperature
from ..physics.sponge import sponge_layer
from .driver import Timers, parse_command_line, run_main_loop, setup_state

__all__ = ["build", "surrogate_from_config", "run", "main"]


def surrogate_from_config(config: SimConfig) -> MicrophysicsKesslerSurrogate:
    """The surrogate micro that the YAML's keys describe
    (inference_ponni.cpp:44-49)."""
    ex = config.extras
    wpath = ex.get("keras_weights_h5") or ex.get("nn_weights")
    if wpath is None:
        raise ValueError("inference_surrogate needs 'keras_weights_h5' (HDF5) "
                         "or 'nn_weights' (.npz) in the input YAML")
    model = (load_keras_h5(wpath) if str(wpath).endswith((".h5", ".hdf5"))
             else load_mlp(wpath))
    return MicrophysicsKesslerSurrogate(
        model, load_scaling(ex["nn_input_scaling"], 5),
        load_scaling(ex["nn_output_scaling"], 4),
        online=bool(ex.get("surrogate_online", False)),
        compare=bool(ex.get("surrogate_compare", True)))


def build(config: SimConfig, device: str | torch.device,
          micro: MicrophysicsKesslerSurrogate | None = None):
    """Like supercell_example.build, with the surrogate micro (from the
    YAML's keys unless ``micro`` is given); returns (state, step_modules,
    dycore)."""
    if micro is None:
        micro = surrogate_from_config(config)
    state = setup_state(config, device)
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


def run(config: SimConfig, device: str | torch.device,
        quiet: bool = False) -> CouplerState:
    """Build and run the experiment; prints the mean NN - Kessler diffs
    after every step (microphysics_kessler_ponni.h:266-269), one device
    read per step, then the last ones and the timers."""
    state, mods, dycore = build(config, device)
    writer = StateWriter(config.out_prefix, state) if config.out_freq >= 0 \
        else None

    def on_step(s, dt, etime):
        if not quiet:
            d = s["surrogate_diffs"].tolist()
            print(f"Etime: {etime:10.6e}  mean diff NN - Kessler "
                  f"[temp, rho_v, rho_c, rho_r]: "
                  f"[{d[0]: .6e}, {d[1]: .6e}, {d[2]: .6e}, {d[3]: .6e}]",
                  flush=True)

    timers = Timers(device)
    timers.start("main")
    state = run_main_loop(state, config, mods, dycore, writer, timers,
                          on_step=on_step, quiet=quiet)
    timers.stop("main")
    if writer:
        writer.close()
    print("Mean diff (NN - Kessler) [temp, rho_v, rho_c, rho_r]:",
          state["surrogate_diffs"].tolist())
    print(timers.report())
    return state


def main(argv=None, quiet: bool = False) -> CouplerState:
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("inference_surrogate", argv)
    return run(load_config(path), device, quiet=quiet)


if __name__ == "__main__":
    main()

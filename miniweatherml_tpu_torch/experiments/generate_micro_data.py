"""Harvest stratified Kessler input/output training pairs during a supercell
run.

Port of ``miniweatherml_tpu/experiments/generate_micro_data.py``
(experiments/supercell_kessler_surrogate/generate_micro_data.cpp): the
supercell chain, with the coupler state cloned before the micro step and
DataGenerator sampling (input, output) stencil rows into the training
dataset (generate_micro_data.cpp:59-92).  The dataset and its metadata
sidecar are written into the working directory unless the generator names
another path.

Usage: python -m miniweatherml_tpu_torch.experiments.generate_micro_data <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from ..ml.surrogate_data import DataGenerator
from .driver import parse_command_line, run_main_loop
from .supercell_example import build

__all__ = ["main", "run_generate_micro_data"]


def run_generate_micro_data(config: SimConfig, device: str | torch.device,
                            quiet: bool = False,
                            generator: DataGenerator | None = None):
    """Run the chain on ``device`` and write the dataset; returns (state,
    generator)."""
    state, mods, dycore = build(config, device)
    micro_step = mods[1]
    gen = generator or DataGenerator()
    state = gen.init(state)
    etime_box = [0.0]

    def micro_with_datagen(s, dt):
        before = s.clone()  # the reference's coupler.clone_into(input)
        after = micro_step(s, dt)
        gen.generate_samples_stencil(before, after, dt, etime_box[0])
        return after

    def on_step(s, dt, etime):
        etime_box[0] = etime

    mods_wrapped = [mods[0], micro_with_datagen] + mods[2:]
    state = run_main_loop(state, config, mods_wrapped, dycore, writer=None,
                          on_step=on_step, quiet=quiet)
    path = gen.finalize()
    if not quiet:
        print(f"wrote {gen.num_samples} samples to {path}")
    return state, gen


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("generate_micro_data", argv)
    return run_generate_micro_data(load_config(path), device)


if __name__ == "__main__":
    main()

"""Measure the fraction of cells with active microphysics.

Port of ``miniweatherml_tpu/experiments/gather_statistics.py``
(experiments/supercell_kessler_surrogate/gather_statistics.cpp): the
supercell chain, with the coupler state cloned before the micro step and
the StatisticsGatherer classifying which cells changed
(gather_statistics.cpp:53-94).

Usage: python -m miniweatherml_tpu_torch.experiments.gather_statistics <input.yaml> [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig, load_config
from ..ml.surrogate_data import StatisticsGatherer
from .driver import parse_command_line, run_main_loop
from .supercell_example import build

__all__ = ["main", "run_gather_statistics"]


def run_gather_statistics(config: SimConfig, device: str | torch.device,
                          quiet: bool = False):
    """Run the chain on ``device``; returns (state, gatherer)."""
    state, mods, dycore = build(config, device)
    micro_step = mods[1]
    gatherer = StatisticsGatherer()
    etime_box = [0.0]

    def micro_with_stats(s, dt):
        before = s.clone()  # the reference's coupler.clone_into(input)
        after = micro_step(s, dt)
        gatherer.gather(before, after, dt, etime_box[0])
        return after

    def on_step(s, dt, etime):
        etime_box[0] = etime

    mods_wrapped = [mods[0], micro_with_stats] + mods[2:]
    state = run_main_loop(state, config, mods_wrapped, dycore, writer=None,
                          on_step=on_step, quiet=quiet)
    gatherer.finalize()
    return state, gatherer


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path, device = parse_command_line("gather_statistics", argv)
    return run_gather_statistics(load_config(path), device)


if __name__ == "__main__":
    main()

"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath."""

import time

import pytest
import torch

from benchmark import compare, harness, readings

from conftest import CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, tiny, cell):
    gaps = readings.control_reading(cell, 31, torch.device("cpu"), root, tiny)
    ok, checks = compare.judge(gaps, compare.load_limits(root, cell))
    assert not ok
    assert sum(c["value"] > c["limit"] for c in checks.values()) >= 3


def _unchanged(prog):
    prog.mods = [lambda state, dt: state for _ in prog.mods]


def _half(prog):
    """The dycore's step leaves half of the columns (y < ny / 2) as they
    were."""
    dycore = prog.mods[0]

    def step(state, dt):
        new = dycore(state, dt)
        h = state.grid.ny // 2
        keep = {}
        for name in ("density_dry", "uvel", "vvel", "wvel", "temp",
                     *state.meta.tracer_names):
            f = new[name].clone()
            f[:, :, :h] = state[name][:, :, :h]
            keep[name] = f
        return new.replace_fields(**keep)
    prog.mods[0] = step


def _altered(prog):
    """The microphysics' vapor is 0.1% off where it is produced."""
    micro = prog.mods[1]

    def step(state, dt):
        new = micro(state, dt)
        return new.replace_fields(water_vapor=new["water_vapor"] * 1.001)
    prog.mods[1] = step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_timed_path_is_not_correct(root, tiny, cell, fault):
    res = harness.run(cell, 99, 0.1, False, time.perf_counter(),
                      device="cpu", grid_overrides=tiny, root=root,
                      program_hook=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())

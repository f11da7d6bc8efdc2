"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath."""

import time

import pytest
import torch

from benchmark import compare, harness, readings

from conftest import CELLS, SUPERCELL, size


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    gaps = readings.control_reading(cell, 31, torch.device("cpu"), root,
                                    size(cell))
    ok, checks = compare.judge(gaps, compare.load_limits(root, cell))
    assert not ok
    assert sum(c["value"] > c["limit"] for c in checks.values()) >= 3


def _module(prog, name):
    return prog.names.index(name)


def _unchanged(prog):
    prog.mods = [lambda state, dt: state for _ in prog.mods]


def _half(prog):
    """The dycore's step leaves half of the columns (y < ny / 2) as they
    were."""
    at = _module(prog, "dycore")
    dycore = prog.mods[at]

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
    prog.mods[at] = step


def _altered(prog):
    """The microphysics' vapor is 0.1% off where it is produced."""
    at = _module(prog, "micro")
    micro = prog.mods[at]

    def step(state, dt):
        new = micro(state, dt)
        return new.replace_fields(water_vapor=new["water_vapor"] * 1.001)
    prog.mods[at] = step


def _altered_wind(prog):
    """The dycore's u is 0.1% off where it is produced."""
    at = _module(prog, "dycore")
    dycore = prog.mods[at]

    def step(state, dt):
        new = dycore(state, dt)
        return new.replace_fields(uvel=new["uvel"] * 1.001)
    prog.mods[at] = step


def _skipped(name):
    def fault(prog):
        prog.mods[_module(prog, name)] = lambda state, dt: state
    fault.__name__ = f"_{name}_skipped"
    return fault


def _no_buildings(prog):
    """The immersed proportion zeroed: the buildings are gone."""
    prop = prog.state["immersed_proportion"]
    assert prop.max().item() == 1.0
    prog.apply({"immersed_proportion": torch.zeros_like(prop)})


FAULTS = [(cell, f) for cell in SUPERCELL
          for f in (_unchanged, _half, _altered)] + \
    [("city_400x400x60", f) for f in (
        _unchanged, _half, _altered_wind, _skipped("hsponge"),
        _skipped("averager"), _no_buildings)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    res = harness.run(cell, 99, 0.1, False, time.perf_counter(),
                      device="cpu", grid_overrides=size(cell), root=root,
                      program_hook=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())

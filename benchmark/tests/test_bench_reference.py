"""The plain reference agrees with the port's CPU path on a small grid, for
every cell, imports nothing of the program or of JAX, and composes the
supercell chains as it did before a configuration named its steps."""

import ast
import importlib
import math
import os

import pytest
import torch

from benchmark import compare, readings

from conftest import CELLS, SUPERCELL, size


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(root, cell):
    """The port's plain PyTorch path (f32, two steps) against the reference
    (f32, the oracle's algebra): every gap within the limit the card's
    runs are held to."""
    gaps = readings.program_reading(cell, 20261018, torch.device("cpu"),
                                    root, size(cell))
    limits = compare.load_limits(root, cell)
    assert set(gaps) == set(limits)
    assert gaps["dt"] == 0.0
    for name, v in gaps.items():
        assert v <= limits[name], (name, v)


FORBIDDEN = ("jax", "jaxlib", "flax", "miniweatherml_tpu",
             "miniweatherml_tpu_torch")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program(root):
    ref = os.path.join(root, "benchmark", "reference")
    seen = 0
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                for name in _imports(os.path.join(dirpath, f)):
                    assert name.split(".")[0] not in FORBIDDEN, (f, name)
    assert seen >= 12


@pytest.mark.parametrize("cell", ["kessler_cb1024", "p3_cb1024_layers",
                                  "city_400x400x60"])
def test_slabs_do_not_change_the_reference(root, cell, monkeypatch):
    """The reference run over many slabs (as at the full grid) gives what
    it gives in one, to rounding (float64, where rounding is far below
    what the WENO limiter amplifies in float32)."""
    from benchmark.harness import Cell, reference_run
    from benchmark.reference import dycore, micro_p3
    c = Cell(cell, root, size(cell))
    cpu = torch.device("cpu")
    whole = reference_run(c, 3, cpu, torch.float64)[1]
    monkeypatch.setattr(dycore, "SLAB_VALUES", 3000)
    monkeypatch.setattr(micro_p3, "SLAB_CELLS", c.grid.nz * c.grid.nx * 3)
    slabs = reference_run(c, 3, cpu, torch.float64)[1]
    for name in c.fields:
        scale = whole[name].abs().max().item()
        assert (whole[name] - slabs[name]).abs().max().item() \
            <= 1e-12 * scale, name


# The supercell chains as the reference composed them before a
# configuration named its steps: the sponge and the nudging as they were
# written then, and the dycore, the microphysics and the initial state
# called in the old order.
OLD_NUDGE_FIELDS = ("density_dry", "uvel", "vvel", "temp", "water_vapor")


def _old_sponge(f, dt, grid, tracer_names):
    n = 10
    names = ["density_dry", "uvel", "vvel", "wvel", "temp", *tracer_names]
    ref = f["temp"]
    k = torch.arange(grid.nz - n, grid.nz, device=ref.device)
    z = (k.to(ref.dtype) + 0.5) * grid.dz
    rel = (grid.zlen - z) / (n * grid.dz)
    factor = ((torch.cos(math.pi * rel) + 1.0) / 2.0
              * (dt / 60.0))[None, :, None, None]
    out = dict(f)
    for name in names:
        top = f[name][:, -n:]
        avg = 0.0 if name == "wvel" else top.mean(dim=(2, 3), keepdim=True)
        new = f[name].clone()
        new[:, -n:] = top + (avg - top) * factor
        out[name] = new
    return out


def _old_nudge(f, dt, column):
    out = dict(f)
    for i, name in enumerate(OLD_NUDGE_FIELDS):
        avg = f[name].mean(dim=(2, 3), keepdim=True)
        out[name] = f[name] + dt * (column[i][:, :, None, None] - avg) \
            / 900.0
    return out


def _old_reference(cell, seed):
    from benchmark.inputs import apply_inputs
    from benchmark.reference import (dycore, init_supercell, micro_kessler,
                                     micro_p3)
    cpu, dt_ = torch.device("cpu"), torch.float32
    g, cfg = cell.grid, cell.cfg
    mod = {"kessler": micro_kessler, "p3": micro_p3}[cfg["reference"]["micro"]]
    micro = mod.Micro(cfg, cell.root, dt_, cpu)
    names = [t[0] for t in mod.TRACERS]
    idwv = names.index("water_vapor")
    c = init_supercell.constants(mod)
    dt = dycore.time_step(g.dx, g.dy, g.dz)
    inputs = cell.inputs(seed, cpu, dt_)
    hy, s, tr = init_supercell.initial_dynamics(g, c, len(names), idwv, dt_,
                                                cpu)
    dyc = dycore.DycoreReference(g, c, hy, [(p, m) for _, p, m in
                                            mod.TRACERS], dt_, cpu)
    f = dyc.to_coupler(s, tr, names, idwv)
    column = torch.stack([f[n].mean(dim=(2, 3)) for n in OLD_NUDGE_FIELDS])
    f["temp"] = f["temp"] + init_supercell.thermal_bubble(g, dt_, cpu)[None]
    for name, kind in mod.FIELDS.items():
        shape = ((g.nens, g.ny, g.nx) if kind == "surface" else
                 (g.nens, g.nz, g.ny, g.nx))
        f[name] = torch.zeros(shape, dtype=dt_, device=cpu)
    f.update(apply_inputs(f, inputs))
    f0 = dict(f)
    for _ in range(cell.nwarm):
        f = dyc.time_step(f, dt, names, idwv)
        f = micro.time_step(f, dt, g)
        f = _old_sponge(f, dt, g, names)
        f = _old_nudge(f, dt, column)
    return f0, f, dt


@pytest.mark.parametrize("cell", SUPERCELL)
def test_named_steps_compose_the_supercell_chains_as_before(root, cell):
    """The reference through the configuration's named steps equals, bit
    for bit, the four step functions called in the old order, and so does
    the program built through its dycore found by identity."""
    from benchmark.harness import Cell, reference_run, warm_program
    from miniweatherml_tpu_torch.dycore.euler import Dycore
    c = Cell(cell, root, size(cell))
    cpu = torch.device("cpu")
    ref0, ref, dt_ref, _ = reference_run(c, 8, cpu)
    old0, old, dt_old = _old_reference(c, 8)
    assert dt_ref == dt_old
    for name in c.fields:
        assert torch.equal(ref0[name], old0[name]), name
        assert torch.equal(ref[name], old[name]), name

    def old_chain(prog):
        """The modules as the program took them: the entry's build, its
        first module replaced by the configuration's dycore form."""
        state, mods, _ = importlib.import_module(c.cfg["entry"]).build(
            prog.config, cpu)
        dyc = Dycore(**c.cfg["dycore"])
        prog.state, prog.dycore = state, dyc
        prog.mods = [dyc.time_step, *mods[1:]]
    new = warm_program(c, 8, cpu)
    was = warm_program(c, 8, cpu, old_chain)
    assert new[1] == was[1]
    for name in c.fields:
        assert torch.equal(new[2][name], was[2][name]), name

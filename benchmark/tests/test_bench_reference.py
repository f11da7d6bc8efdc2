"""The plain reference agrees with the port's CPU path on a tiny grid, for
both configurations and both traffic mixes, and imports nothing of the
program or of JAX."""

import ast
import os

import pytest
import torch

from benchmark import compare, readings

from conftest import CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(root, tiny, cell):
    """The port's plain PyTorch path (f32, two steps) against the reference
    (f32, the oracle's algebra): every gap within the limit the card's
    runs are held to."""
    gaps = readings.program_reading(cell, 20261018, torch.device("cpu"),
                                    root, tiny)
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
    assert seen >= 5


@pytest.mark.parametrize("cell", ["kessler_cb1024", "p3_cb1024_layers"])
def test_slabs_do_not_change_the_reference(root, tiny, cell, monkeypatch):
    """The reference run over many slabs (as at the full grid) gives what
    it gives in one, to rounding (float64, where rounding is far below
    what the WENO limiter amplifies in float32)."""
    from benchmark.harness import Cell, reference_run
    from benchmark.reference import dycore, micro_p3
    c = Cell(cell, root, tiny)
    cpu = torch.device("cpu")
    whole = reference_run(c, 3, cpu, torch.float64)[1]
    monkeypatch.setattr(dycore, "SLAB_VALUES", 3000)
    monkeypatch.setattr(micro_p3, "SLAB_CELLS", c.grid.nz * c.grid.nx * 3)
    slabs = reference_run(c, 3, cpu, torch.float64)[1]
    for name in c.fields:
        scale = whole[name].abs().max().item()
        assert (whole[name] - slabs[name]).abs().max().item() \
            <= 1e-12 * scale, name

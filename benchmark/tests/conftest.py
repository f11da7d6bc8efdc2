"""Tests of the benchmark harness.  They run on the CPU at a tiny grid,
through the port's plain PyTorch paths; the test marked ``cuda`` runs one
cell on the card and skips without one.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny grid at the supercell cells' cell sizes (800 m x 800 m x 1 km)
TINY = dict(nx=24, ny=16, nz=20, xlen=24 * 800.0, ylen=16 * 800.0,
            zlen=20000.0)
# a small city: the published domain, so the buildings stay in, at
# 31.25 m x 31.25 m x 25 m, with both ensemble members
CITY_SMALL = dict(nx=64, ny=64, nz=12, nens=2, xlen=2000.0, ylen=2000.0,
                  zlen=300.0)
SIZES = {"kessler_cb1024": TINY, "p3_cb1024_layers": TINY,
         "p3_cb1024_clear": TINY, "city_400x400x60": CITY_SMALL}
CELLS = tuple(SIZES)
SUPERCELL = ("kessler_cb1024", "p3_cb1024_layers", "p3_cb1024_clear")


def size(cell: str) -> dict:
    """The CPU grid of a cell's tests."""
    return dict(SIZES[cell])


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def tiny():
    return dict(TINY)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")

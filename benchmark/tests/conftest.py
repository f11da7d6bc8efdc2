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

# a tiny grid at the cells' cell sizes (800 m x 800 m x 1 km)
TINY = dict(nx=24, ny=16, nz=20, xlen=24 * 800.0, ylen=16 * 800.0,
            zlen=20000.0)
CELLS = ("kessler_cb1024", "p3_cb1024_layers", "p3_cb1024_clear")


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

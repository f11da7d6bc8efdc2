"""The surrogate kernel's share of its roofline (%): the least time of a
step's forward call (``surrogate_work``, one call a step online) times the
steps, over the family's device time.  The model's widths come from the
configuration's weights file (``nn_weights``, in the checkout)."""

from __future__ import annotations

import os

import numpy as np

from .. import work
from ._layer import roofline_pct, shape

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NIN, NOUT = 5, 4


def widths(path: str) -> list[int]:
    """The layer widths [5, ..., 4] of a ``.npz`` model."""
    with np.load(path) as z:
        n = int(z["nlayers"])
        return [int(z["W0"].shape[0])] + [int(z[f"W{i}"].shape[1])
                                          for i in range(n)]


def surrogate_work(widths, cells: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one forward call over ``cells`` cells.
    Bytes: the 5 input fields read and the 4 outputs written once, and the
    packed parameters (header, both tables, every W and b) read once.
    Operations, as the kernel computes them a cell: the normalisation
    (a subtraction and a division an input), each output of each layer an
    ordered sum of n_in products plus its bias (2 n_in), LeakyReLU on each
    hidden unit, the denormalisation (a multiply and an add an output) and
    the 3 clamps."""
    params = len(widths) + 1 + 2 * (NIN + NOUT) + sum(
        a * b + b for a, b in zip(widths[:-1], widths[1:]))
    nbytes = work.ITEM[dtype] * ((NIN + NOUT) * cells + params)
    per_cell = (2 * NIN + sum(2 * a * b for a, b in zip(widths[:-1],
                                                      widths[1:]))
                + sum(widths[1:-1]) + 2 * NOUT + (NOUT - 1))
    return nbytes, per_cell * cells


def read(trace):
    cfg = trace.context["cfg"]
    if "nn_weights" not in cfg:
        return None
    nens, nz, ny, nx = shape(trace)
    dtype = trace.context["dtype"]
    least = work.bound_s(*surrogate_work(
        widths(os.path.join(ROOT, cfg["nn_weights"])), nens * nz * ny * nx,
        dtype), dtype)
    return roofline_pct(trace, "surrogate", least)

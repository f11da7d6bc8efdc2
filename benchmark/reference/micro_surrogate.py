"""Plain PyTorch reference of the Kessler MLP surrogate deployed online.

The forward pass follows the upstream drop-in microphysics
experiments/supercell_kessler_surrogate/custom_modules/
microphysics_kessler_ponni.h: per cell the five inputs [temp, density_dry,
water_vapor, cloud_liquid, precip_liquid] are min-max normalised with the
input table, pushed through the dense layers (x W + b, LeakyReLU(0.1)
between layers; the shipped model is 5 -> 10 -> 4, :103-111), denormalised
with the output table and rho_v, rho_c, rho_r clamped at 0 (:177-202); the
prediction replaces temp, water_vapor, cloud_liquid and precip_liquid (the
override at :271-276).  The weights are read with ``numpy.load`` from the
configuration's ``nn_weights`` (``nlayers``, ``W<i>`` (n_in, n_out),
``b<i>``) and the tables with ``numpy.loadtxt`` from ``nn_input_scaling``
(5 x [min, max]) and ``nn_output_scaling`` (4 x [min, max]), each path
joined to the checkout's root.  It imports nothing of the program.

Departures from the upstream header:

- the upstream module also runs the Kessler scheme every step and prints
  the mean NN-minus-Kessler differences, with the override commented out;
  this is the override alone (the deployment), so no Kessler step runs;
- the upstream reads the Keras ``.h5``; the ``.npz`` here holds the same
  arrays bit for bit, so no HDF5 reader is needed;
- ``precl`` stays as it is (zero from the build): the surrogate predicts no
  surface rain, where the upstream would keep its Kessler call's;
- the arithmetic is in the configuration's dtype (float32, TF32 off: the
  harness sets it), where ponni computes in the build's real type; the
  layers are ``torch.matmul`` over slabs of cells, which may sum in another
  order than the program's kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.nn import functional as F

from .micro_kessler import (CP_D, CP_V, FIELDS, GRAV, P0, R_D,  # noqa: F401
                            R_V, TRACERS)

INPUTS = ("temp", "density_dry", "water_vapor", "cloud_liquid",
          "precip_liquid")
OUTPUTS = ("temp", "water_vapor", "cloud_liquid", "precip_liquid")
SLAB_CELLS = 1 << 24


def load_weights(path: str) -> list:
    """[(W (n_in, n_out), b (n_out,)), ...] as numpy arrays."""
    with np.load(path) as z:
        return [(z[f"W{i}"], z[f"b{i}"]) for i in range(int(z["nlayers"]))]


def surrogate(inputs, weights, scl_in, scl_out):
    """The prediction of (temp, rho_v, rho_c, rho_r) from the five input
    fields, each (..., ) of one shape; ``weights`` [(W, b), ...],
    ``scl_in`` (5, 2), ``scl_out`` (4, 2), tensors in the fields' dtype."""
    shape = inputs[0].shape
    x = torch.stack([f.reshape(-1) for f in inputs], dim=1)
    outs = []
    for s in range(0, x.shape[0], SLAB_CELLS):
        h = (x[s:s + SLAB_CELLS] - scl_in[:, 0]) / (scl_in[:, 1]
                                                    - scl_in[:, 0])
        for i, (W, b) in enumerate(weights):
            h = torch.matmul(h, W) + b
            if i + 1 < len(weights):
                h = F.leaky_relu(h, 0.1)
        outs.append(h * (scl_out[:, 1] - scl_out[:, 0]) + scl_out[:, 0])
    y = torch.cat(outs)
    del x, outs
    temp = y[:, 0].reshape(shape)
    return (temp, *(torch.clamp(y[:, j], min=0.0).reshape(shape)
                    for j in range(1, 4)))


class Micro:
    """The online surrogate's step on a dict of coupler fields."""

    name = "surrogate"

    def __init__(self, cfg: dict, root: str, dtype, device):
        kw = dict(dtype=dtype, device=device)
        self.weights = [(torch.tensor(W, **kw), torch.tensor(b, **kw))
                        for W, b in load_weights(
                            os.path.join(root, cfg["nn_weights"]))]
        self.scl_in, self.scl_out = (
            torch.tensor(np.loadtxt(os.path.join(root, cfg[key]),
                                    dtype=np.float64).reshape(n, 2), **kw)
            for key, n in (("nn_input_scaling", 5), ("nn_output_scaling", 4)))

    def time_step(self, f: dict, dt: float, grid) -> dict:
        pred = surrogate([f[n] for n in INPUTS], self.weights, self.scl_in,
                         self.scl_out)
        out = dict(f)
        out.update(zip(OUTPUTS, pred))
        return out

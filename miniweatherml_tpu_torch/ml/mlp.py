"""Inline MLP inference for microphysics surrogates.

Port of ``miniweatherml_tpu/ml/mlp.py`` (after the reference's ponni C++
inference runtime, external/ponni, used by experiments/
supercell_kessler_surrogate/custom_modules/microphysics_kessler_ponni.h:
103-111): the surrogate is an ``nn.Module`` of dense layers applied with
``torch.matmul`` inside the physics step.

Also provides:
  * Keras-HDF5 weight loading (the reference loads "/dense_6/dense_6
    kernel:0"-style datasets, microphysics_kessler_ponni.h:103-107),
  * the reference's whitespace text min-max scaling table format
    (microphysics_kessler_ponni.h:113-135),
  * the JAX package's ``.npz`` weight layout (``nlayers``, ``W{i}``,
    ``b{i}``), so a model trained by either package loads in the other,
  * ``mlp_from_numpy``, which carries a JAX model's parameters across.

Weights keep the JAX layout: a layer computes ``x @ W + b`` with W of shape
(n_in, n_out), so weight files and carried parameters need no transpose.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "MLP", "leaky_relu", "init_mlp", "save_mlp", "load_mlp",
    "load_keras_h5", "load_scaling", "save_scaling", "mlp_from_numpy",
]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU with the reference's slope 0.1
    (microphysics_kessler_ponni.h:105, training notebook)."""
    return F.leaky_relu(x, negative_slope)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class MLP(nn.Module):
    """Dense MLP: x @ W + b per layer, LeakyReLU(0.1) between layers.

    The reference architecture is 5 -> 10 -> 4
    (jupyter_notebooks/kessler_singlecell_train_example.ipynb).
    ``weights`` is a list of (W (n_in, n_out), b (n_out,)) tensors.
    """

    def __init__(self, weights):
        super().__init__()
        self.W = nn.ParameterList(nn.Parameter(torch.as_tensor(W))
                                  for W, _ in weights)
        self.b = nn.ParameterList(nn.Parameter(torch.as_tensor(b))
                                  for _, b in weights)

    @property
    def weights(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.W, self.b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., n_in) -> (..., n_out)."""
        n = len(self.W)
        for i, (W, b) in enumerate(self.weights):
            x = torch.matmul(x, W) + b
            if i + 1 < n:
                x = leaky_relu(x)
        return x

    def validate(self) -> None:
        """Check layer shape compatibility (the ponni model.validate()
        analog, microphysics_kessler_ponni.h:110); raises on mismatch."""
        for i, (W, b) in enumerate(self.weights):
            if W.ndim != 2 or tuple(b.shape) != (W.shape[1],):
                raise ValueError(f"layer {i}: kernel {tuple(W.shape)} / bias "
                                 f"{tuple(b.shape)} mismatch")
            if i and self.W[i - 1].shape[1] != W.shape[0]:
                raise ValueError(f"layer {i-1}->{i}: {self.W[i-1].shape[1]} "
                                 f"outputs vs {W.shape[0]} inputs")

    def describe(self) -> str:
        """Human-readable layer summary (the ponni model.print() analog)."""
        lines = []
        for i, (W, _) in enumerate(self.weights):
            act = " + LeakyReLU(0.1)" if i + 1 < len(self.W) else ""
            lines.append(f"layer {i}: Dense {W.shape[0]} -> {W.shape[1]}{act}")
        return "\n".join(lines)


def mlp_from_numpy(weights, device: str | torch.device,
                   dtype: torch.dtype = torch.float32) -> MLP:
    """An ``MLP`` on ``device`` from [(W, b), ...] host arrays, e.g. a JAX
    model's parameters as ``[(np.asarray(W), np.asarray(b)) for W, b in
    model.weights]``."""
    return MLP([(torch.tensor(np.asarray(W), dtype=dtype, device=device),
                 torch.tensor(np.asarray(b), dtype=dtype, device=device))
                for W, b in weights])


def init_mlp(sizes, generator: torch.Generator, scale: float = 0.05,
             dtype: torch.dtype = torch.float32) -> MLP:
    """RandomUniform(-scale, scale) init, matching the Keras notebook's
    kernel_initializer=RandomUniform, drawn from ``generator`` on its
    device.  The draws differ from the JAX package's ``init_mlp`` (a JAX
    PRNG key cannot be reproduced in torch): to start both packages from
    the same weights, carry them across with ``mlp_from_numpy``."""
    ws = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        W, b = (torch.rand(shape, generator=generator, dtype=dtype,
                           device=generator.device) * (2.0 * scale) - scale
                for shape in ((n_in, n_out), (n_out,)))
        ws.append((W, b))
    return MLP(ws)


def save_mlp(path: str, model: MLP) -> None:
    arrays = {}
    for i, (W, b) in enumerate(model.weights):
        arrays[f"W{i}"] = _numpy(W)
        arrays[f"b{i}"] = _numpy(b)
    np.savez(path, nlayers=len(model.W), **arrays)


def load_mlp(path: str, dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cpu") -> MLP:
    with np.load(path) as z:
        ws = [(z[f"W{i}"], z[f"b{i}"]) for i in range(int(z["nlayers"]))]
    return mlp_from_numpy(ws, device, dtype)


def load_keras_h5(path: str, layers=("dense_6", "dense_7"),
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cpu") -> MLP:
    """Load a Keras-exported HDF5 weight file with the reference's layout
    ("/<layer>/<layer>/kernel:0" and "bias:0",
    microphysics_kessler_ponni.h:103-107).  Needs ``h5py``; without it,
    give the same weights as ``.npz`` (the ``nn_weights`` key)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs h5py, which is not installed; give the "
            "weights as .npz with the 'nn_weights' key instead "
            "(inputs/examples/supercell_kessler_example_weights.npz holds "
            "the shipped model)") from e
    with h5py.File(path, "r") as f:
        ws = [(np.array(f[layer][layer]["kernel:0"]),
               np.array(f[layer][layer]["bias:0"])) for layer in layers]
    return mlp_from_numpy(ws, device, dtype)


def load_scaling(path: str, nvars: int, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """Read an (nvars, 2) [min, max] whitespace table
    (reference microphysics_kessler_ponni.h:118-135)."""
    vals = np.loadtxt(path, dtype=np.float64).reshape(nvars, 2)
    return torch.as_tensor(vals, dtype=dtype, device=device)


def save_scaling(path: str, table) -> None:
    np.savetxt(path, _numpy(table).astype(np.float64), fmt="%.17g")

"""Offline surrogate training: Kessler single-cell MLP.

Port of ``miniweatherml_tpu/ml/train.py`` (after the reference's Keras
notebook, experiments/supercell_kessler_surrogate/jupyter_notebooks/
kessler_singlecell_train_example.ipynb): Dense(10, RandomUniform init) ->
LeakyReLU(0.1) -> Dense(4); loss MSE, optimizer Nadam, 10 epochs, batch
1024, validation split 0.2; min-max normalization of the 5 single-cell
inputs [T, rho_d, rho_v, rho_c, rho_p] and 4 outputs [T, rho_v, rho_c, rho_p].
The shuffles are the JAX package's numpy permutations; the optimizer is
``optax.nadam``'s update (``nadam_update``), which ``torch.optim.NAdam``
(a momentum-decay schedule) does not reproduce.

Artifacts: weights .npz (the ``ml.mlp`` layout) plus the reference's
min/max scaling text tables, so the trained model plugs into the surrogate
micro exactly like a ponni/Keras one.

Usage: python -m miniweatherml_tpu_torch.ml.train <dataset.nc|.npz> [out_prefix] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

from ..experiments.driver import add_device_argument, checked_device
from .mlp import MLP, init_mlp, save_mlp, save_scaling
from .surrogate_data import load_dataset

__all__ = ["minmax_table", "normalize", "denormalize", "nadam_init",
           "nadam_update", "train_mlp", "main"]


def minmax_table(arr: np.ndarray) -> np.ndarray:
    """(N, nvars) -> (nvars, 2) [min, max] table; degenerate ranges widened
    so (max - min) never divides by zero."""
    lo = arr.min(axis=0).astype(np.float64)
    hi = arr.max(axis=0).astype(np.float64)
    same = hi - lo < 1e-30
    hi = np.where(same, lo + 1.0, hi)
    return np.stack([lo, hi], axis=1)


def _table(table, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(table), dtype=like.dtype,
                           device=like.device)


def normalize(x: torch.Tensor, table) -> torch.Tensor:
    t = _table(table, x)
    return (x - t[:, 0]) / (t[:, 1] - t[:, 0])


def denormalize(y: torch.Tensor, table) -> torch.Tensor:
    t = _table(table, y)
    return y * (t[:, 1] - t[:, 0]) + t[:, 0]


def nadam_init(params) -> dict:
    """Zero moments for ``nadam_update``."""
    return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params]}


@torch.no_grad()
def nadam_update(params, grads, state: dict, lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One ``optax.nadam(lr)`` step on ``params`` in place: Adam with the
    bias-corrected Nesterov first moment of optax's ``scale_by_adam(...,
    nesterov=True)``, then the step scaled by -lr.  The bias corrections
    are formed in double precision and rounded to the parameters' dtype, as
    optax forms them."""
    state["count"] += 1
    t = state["count"]
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)

        def corr(v, decay, count):
            return torch.div(v, v.new_full((), 1 - decay ** count))
        mu_hat = b1 * corr(mu, b1, t + 1) + (1 - b1) * corr(g, b1, t)
        step = mu_hat / (torch.sqrt(corr(nu, b2, t)) + eps)
        p.add_(-lr * step)


def train_mlp(inputs: np.ndarray, outputs: np.ndarray, *,
              device: str | torch.device, hidden: int = 10, epochs: int = 10,
              batch: int = 1024, val_split: float = 0.2, lr: float = 1e-3,
              seed: int = 0, verbose: bool = True, init: MLP | None = None):
    """Returns (model, scl_in (5,2), scl_out (4,2), history), the model on
    ``device`` in f32.

    ``inputs`` may be (N,5,2) stencil rows (column 0 used, like the
    single-cell notebook) or already (N,5).  Training starts from a copy of
    ``init`` when given, else from ``init_mlp`` with a generator on
    ``device`` seeded ``seed``.  Losses are read from the device once per
    epoch.
    """
    if inputs.ndim == 3:
        inputs = inputs[:, :, 0]
    x = np.asarray(inputs, np.float32)
    y = np.asarray(outputs, np.float32)

    scl_in = minmax_table(x)
    scl_out = minmax_table(y)
    xn = normalize(torch.as_tensor(x, device=device), scl_in)
    yn = normalize(torch.as_tensor(y, device=device), scl_out)

    perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(x)),
                           device=device)
    xn, yn = xn[perm], yn[perm]
    n_val = int(len(x) * val_split)
    x_tr, y_tr = xn[n_val:], yn[n_val:]
    x_va, y_va = xn[:n_val], yn[:n_val]

    if init is None:
        gen = torch.Generator(device).manual_seed(seed)
        model = init_mlp((x.shape[1], hidden, y.shape[1]), gen)
    else:
        model = copy.deepcopy(init).to(device=device, dtype=torch.float32)
    params = list(model.parameters())
    opt = nadam_init(params)

    history = []
    n = len(x_tr)
    for epoch in range(epochs):
        perm = torch.as_tensor(
            np.random.default_rng(seed + 1 + epoch).permutation(n),
            device=device)
        losses = []
        for s in range(0, n, batch):
            idx = perm[s:s + batch]
            loss = torch.mean((model(x_tr[idx]) - y_tr[idx]) ** 2)
            nadam_update(params, torch.autograd.grad(loss, params), opt, lr)
            losses.append(loss.detach())
        with torch.no_grad():
            vl = (float(torch.mean((model(x_va) - y_va) ** 2)) if n_val
                  else 0.0)
        mean = float(np.mean(torch.stack(losses).cpu().numpy()
                             .astype(np.float64)))
        history.append({"epoch": epoch, "loss": mean, "val_loss": vl})
        if verbose:
            print(f"epoch {epoch}: loss={mean:.6e} val_loss={vl:.6e}")
    return model, scl_in, scl_out, history


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog="train")
    ap.add_argument("dataset", help="dataset .nc or .npz")
    ap.add_argument("out_prefix", nargs="?",
                    default="supercell_kessler_surrogate")
    add_device_argument(ap)
    args = ap.parse_args(list(argv))
    device = checked_device("train", args.device)
    prefix = args.out_prefix
    inputs, outputs, meta = load_dataset(args.dataset)
    print(f"dataset: {len(inputs)} samples, meta={meta}")
    model, scl_in, scl_out, history = train_mlp(inputs, outputs,
                                                device=device)
    save_mlp(prefix + "_weights.npz", model)
    save_scaling(prefix + "_input_scaling.txt", scl_in)
    save_scaling(prefix + "_output_scaling.txt", scl_out)
    print(f"wrote {prefix}_weights.npz / _input_scaling.txt / "
          "_output_scaling.txt")
    return model, scl_in, scl_out, history


if __name__ == "__main__":
    main()
